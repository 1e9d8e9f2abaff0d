// 7x7 depthwise convolution followed by LayerNorm over channels, NHWC.
//
// Replaces: sm3det_tpu/ops/pallas/convnext_block_kernel.py,
//   fused_dwconv_ln (the whole Pallas kernel) and the dw7x7 + LN prefix of
//   fused_convnext_block (_make_block_kernel).
//
// Contract (that of _make_block_kernel): the 49 taps accumulate in fp32 on
// top of the conv bias, with zero padding 3; the LN statistics are taken on
// the unrounded fp32 accumulator, var = max(E[x^2] - mean^2, 0), eps given;
// the normalised value is scaled, shifted and rounded once to the output
// type. Input fp32 or bf16, output fp32 or bf16.
//
// Bound on the H100: the fp32 FMA rate, narrowly. Each output element
// needs 49 FMAs and ~8 flops of LN (~106 flops at the 67 TFLOP/s of the
// CUDA cores: the taps are not a matrix product) against one element read
// and one written: 4 bytes in bf16 (1.2 ps at 3.35 TB/s) for 1.6 ps of
// arithmetic. In fp32 the 8 bytes make it memory bound.
//
// Design: one block owns a 4x8 pixel tile of one image and all C channels
// of it, since LN reduces over C (up to 768). Channels go in chunks of 32:
// the chunk's input rows plus the 3-pixel halo ((4+6) x (8+6) pixels) and
// its 49 taps are staged in shared memory, one warp lane per channel so
// the staging loads are coalesced along C and the tap reads are free of
// bank conflicts. The fp32 accumulators of all C channels stay in shared
// memory (32 x C floats, 96 KB at C = 768) until the LN pass, in which one
// warp per pixel reduces the sums with shuffles and writes the row once.
// Halo reads cost (10*14)/(4*8) = 4.4x of the input, served by L1/L2.
// (Keeping the accumulators in registers instead, C/32 per lane and
// pixel, spills at C = 768 and was no faster at C >= 384 on the H100.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 4;            // output rows per block
constexpr int TC = 8;            // output columns per block
constexpr int TP = TR * TC;      // pixels per block
constexpr int HR = TR + 6;       // staged rows (3-pixel halo both sides)
constexpr int HC = TC + 6;       // staged columns
constexpr int CC = 32;           // channels per chunk (one per lane)
constexpr int THREADS = 256;     // 8 warps: 8 groups of 4 pixels per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t smem_bytes(int C) {
  return sizeof(float) * (size_t)(HR * HC * CC + 49 * CC + TP * C);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
dwconv_ln_kernel(const Tin* __restrict__ x, const float* __restrict__ dwk,
                 const float* __restrict__ dwb, const float* __restrict__ lns,
                 const float* __restrict__ lnb, Tout* __restrict__ out, int H,
                 int W, int C, float eps) {
  extern __shared__ float smem[];
  float* tile = smem;                    // [HR*HC][CC]
  float* wts = tile + HR * HC * CC;      // [49][CC]
  float* acc = wts + 49 * CC;            // [TP][C]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TR;
  const int x0 = blockIdx.x * TC;
  const int tid = threadIdx.x;
  const Tin* xb = x + (size_t)b * H * W * C;

  const int cc = tid % CC;         // channel within the chunk
  const int pg = tid / CC;         // pixel group: row pg/2, 4 columns
  const int r = pg >> 1;
  const int q0 = (pg & 1) * 4;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
    for (int i = tid; i < HR * HC * CC; i += THREADS) {
      const int ch = i % CC;
      const int pix = i / CC;
      const int gy = y0 - 3 + pix / HC;
      const int gx = x0 - 3 + pix % HC;
      float v = 0.f;
      if (ch < nc && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(xb[((size_t)gy * W + gx) * C + c0 + ch]);
      tile[i] = v;
    }
    for (int i = tid; i < 49 * CC; i += THREADS) {
      const int ch = i % CC;
      wts[i] = ch < nc ? dwk[(size_t)(c0 + ch) * 49 + i / CC] : 0.f;
    }
    __syncthreads();
    if (cc < nc) {
      const float bias = dwb[c0 + cc];
      float a[4] = {bias, bias, bias, bias};
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        float row[10];
#pragma unroll
        for (int j = 0; j < 10; ++j)
          row[j] = tile[((r + dy) * HC + q0 + j) * CC + cc];
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const float w = wts[(dy * 7 + dx) * CC + cc];
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = fmaf(row[j + dx], w, a[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[(r * TC + q0 + j) * C + c0 + cc] = a[j];
    }
    __syncthreads();
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const float inv_c = 1.f / (float)C;
  for (int p = warp; p < TP; p += THREADS / 32) {
    const int py = y0 + p / TC;
    const int px = x0 + p % TC;
    if (py >= H || px >= W) continue;          // uniform across the warp
    const float* ap = acc + p * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = ap[c];
      s += v;
      s2 = fmaf(v, v, s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s * inv_c;
    const float var = fmaxf(s2 * inv_c - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    Tout* op = out + (((size_t)b * H + py) * W + px) * C;
    for (int c = lane; c < C; c += 32)
      op[c] = from_f<Tout>((ap[c] - mean) * rstd * lns[c] + lnb[c]);
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const float* dwk, const float* dwb,
           const float* lns, const float* lnb, void* out, int B, int H, int W,
           int C, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  auto kern = dwconv_ln_kernel<Tin, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), dwk, dwb, lns, lnb, static_cast<Tout*>(out),
      H, W, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sm3det_dwconv_ln(const void* x, const float* dwk,
                                const float* dwb, const float* lns,
                                const float* lnb, void* out, int B, int H,
                                int W, int C, int in_bf16, int out_bf16,
                                float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (in_bf16 && out_bf16)
    return launch<bf, bf>(x, dwk, dwb, lns, lnb, out, B, H, W, C, eps, stream);
  if (in_bf16)
    return launch<bf, float>(x, dwk, dwb, lns, lnb, out, B, H, W, C, eps,
                             stream);
  if (out_bf16)
    return launch<float, bf>(x, dwk, dwb, lns, lnb, out, B, H, W, C, eps,
                             stream);
  return launch<float, float>(x, dwk, dwb, lns, lnb, out, B, H, W, C, eps,
                              stream);
}
