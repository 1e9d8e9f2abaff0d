// fp32 grouped GEMM with per-row-tile expert weights and the FFN
// epilogues: the fp32 path of the FFN (the bf16 path is the fused
// ``ffn_wgmma.cu``).
//
// Replaces, at fp32: sm3det_tpu/ops/pallas/moe_groupgemm_kernel.py::_kernel
//   (moe_ffn_grouped) and the MLP half of convnext_block_kernel.py::
//   _make_block_kernel (fused_convnext_block). The JAX package keeps its
//   kernel to bf16; the port's fp32 path serves the card-against-host
//   checks at fp32.
//
// One launch computes out = epilogue(A @ W[e] + bias[e]), A (M, K) row
// major, W (E, K, N) row major (the JAX layout, read as it is), and
// e = tile_expert[row0 / tile_rows] for every row tile; with no
// tile_expert, e = 0 (a dense block). The FFN is two launches:
//   epilogue 0 (fc1):  h = gelu_erf(acc + b1);
//   epilogue 1 (fc2, MoE): y = acc + b2;
//   epilogue 2 (fc2, dense block): y = shortcut + gamma * (acc + b2).
//
// Bound on the H100: 2*M*K*N flops against (M*K + K*N + M*N) elements,
// well above the ridge at the slice's shapes: the 67 TFLOP/s fp32 peak.
//
// Design: full fp32 FMAs (no TF32); the output tiled 128x128, 256 threads
// each owning an 8x8 block of the tile; the row tile's expert is picked
// once, so a tile never mixes experts (tile_rows is a multiple of 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---- fp32: SIMT FMAs ----------------------------------------------------

constexpr int BK32 = 16;

template <int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A,
                const int* __restrict__ tile_expert, int tile_rows,
                const float* __restrict__ Wt, const float* __restrict__ bias,
                const float* __restrict__ shortcut,
                const float* __restrict__ gamma, float* __restrict__ out,
                int M, int K, int N) {
  __shared__ __align__(16) float As[BK32][BM + 4];
  __shared__ __align__(16) float Bs[BK32][BN + 4];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int e = tile_expert ? tile_expert[m0 / tile_rows] : 0;
  const float* W = Wt + (size_t)e * K * N;
  const float* bv = bias + (size_t)e * N;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK32) {
    for (int i = tid; i < BM * BK32; i += THREADS) {
      const int row = i / BK32, col = i % BK32;
      const int gm = m0 + row, gk = k0 + col;
      As[col][row] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < BK32 * BN; i += THREADS) {
      const int row = i / BN, col = i % BN;
      const int gk = k0 + row, gn = n0 + col;
      Bs[row][col] = (gk < K && gn < N) ? W[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      float v = acc[i][j] + bv[gn];
      if (EPI == 0) {
        v = gelu_erf(v);
      } else if (EPI == 2) {
        v = shortcut[o] + gamma[gn] * v;
      }
      out[o] = v;
    }
  }
}

int launch(const float* A, const int* te, int tr, const float* W,
           const float* bias, const float* S, const float* gamma, float* O,
           int M, int K, int N, int epilogue, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  switch (epilogue) {
    case 0:
      gemm_f32_kernel<0><<<grid, THREADS, 0, stream>>>(A, te, tr, W, bias,
                                                       S, gamma, O, M, K, N);
      break;
    case 1:
      gemm_f32_kernel<1><<<grid, THREADS, 0, stream>>>(A, te, tr, W, bias,
                                                       S, gamma, O, M, K, N);
      break;
    case 2:
      gemm_f32_kernel<2><<<grid, THREADS, 0, stream>>>(A, te, tr, W, bias,
                                                       S, gamma, O, M, K, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sm3det_grouped_gemm(const float* a, const int* tile_expert,
                                   int tile_rows, const float* w,
                                   const float* bias, const float* shortcut,
                                   const float* gamma, float* out, int M,
                                   int K, int N, int epilogue,
                                   cudaStream_t stream) {
  if (tile_expert != nullptr && (tile_rows <= 0 || tile_rows % BM != 0))
    return (int)cudaErrorInvalidValue;
  return launch(a, tile_expert, tile_rows, w, bias, shortcut, gamma, out, M,
                K, N, epilogue, stream);
}
