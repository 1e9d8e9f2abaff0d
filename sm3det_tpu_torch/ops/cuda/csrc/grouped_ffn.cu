// Grouped GEMM with per-row-tile expert weights and the FFN epilogues.
//
// Replaces: sm3det_tpu/ops/pallas/moe_groupgemm_kernel.py::_kernel
//   (moe_ffn_grouped: the MoE expert FFN over the group-aligned slot
//   layout) and the MLP half of convnext_block_kernel.py::
//   _make_block_kernel (fused_convnext_block), which is the same FFN with
//   one expert plus layer scale and residual.
//
// One launch computes out = epilogue(A @ W[e] + bias[e]), A (M, K) row
// major, W (E, K, N) row major (the JAX layout, read as it is), and
// e = tile_expert[row0 / tile_rows] for every row tile; with no
// tile_expert, e = 0 (a dense block). The FFN is two launches:
//   epilogue 0 (fc1):  h = gelu(round_T(acc + b1)), rounded to T; gelu is
//                      the tanh form for bf16 and erf for fp32;
//   epilogue 1 (fc2, MoE): y = round_T(acc + b2);
//   epilogue 2 (fc2, dense block): y = round_T(shortcut + gamma * (acc + b2))
//                      in fp32, rounded once.
// Products accumulate in fp32.
//
// Bound on the H100: at the slice's shapes (M >= 5000 rows, K, N >= 96)
// the work is 2*M*K*N flops against (M*K + K*N + M*N) elements, well above
// the ridge, so the bound is the flops over the tensor-core peak (bf16) or
// the 67 TFLOP/s fp32 peak.
//
// Design (first version, correct before fast). Both paths tile the output
// 128x128 and pick the row tile's expert once, so a tile never mixes
// experts (tile_rows is a multiple of 128).
// - bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, fp32 sums).
//   4 warps, each a 64x64 piece of the tile (32 products per 8 ldmatrix);
//   32-deep K slices come into shared memory by cp.async, four stages
//   deep, so three slices load while one multiplies; ldmatrix feeds the
//   fragments (rows padded by 16 bytes, so its reads are free of bank
//   conflicts).
// - fp32: full fp32 FMAs (no TF32), 256 threads each owning an 8x8 block
//   of the tile.
// The hidden activation goes to device memory between the two launches;
// keeping it on chip as the TPU kernel does, and wgmma with TMA, are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u = 0.79788456080286536f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(u));
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

// ---- bf16: tensor cores -------------------------------------------------

constexpr int BK = 32;
constexpr int STAGES = 4;          // K slices in flight
constexpr int THREADS16 = 128;     // 4 warps, 2 x 2, each 64 x 64
constexpr int A_LD = BK + 8;       // 80-byte rows
constexpr int B_LD = BN + 8;       // 272-byte rows
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM16 = STAGES * (A_STAGE + B_STAGE) * 2;   // 75,776 bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int EPI>
__global__ void __launch_bounds__(THREADS16)
gemm_bf16_kernel(const bf16* __restrict__ A,
                 const int* __restrict__ tile_expert, int tile_rows,
                 const bf16* __restrict__ Wt, const float* __restrict__ bias,
                 const bf16* __restrict__ shortcut,
                 const float* __restrict__ gamma, bf16* __restrict__ out,
                 int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* As = reinterpret_cast<bf16*>(smem16);           // [STAGES][BM][A_LD]
  bf16* Bs = As + STAGES * A_STAGE;                     // [STAGES][BK][B_LD]

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int e = tile_expert ? tile_expert[m0 / tile_rows] : 0;
  const bf16* W = Wt + (size_t)e * K * N;
  const float* bv = bias + (size_t)e * N;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 64;    // warp's rows within the tile
  const int wn = (warp % 2) * 64;    // warp's columns within the tile

  // 16-byte chunks: A slice 128 rows x 4, B slice 32 rows x 16; 4 each
  auto load = [&](int stage, int k0) {
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * THREADS16;
      const int r = c / 4, kc = (c % 4) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(as + r * A_LD + kc,
                 ok ? A + (size_t)(m0 + r) * K + k0 + kc : A, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * THREADS16;
      const int r = c / 16, nc = (c % 16) * 8;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async16(bs + r * B_LD + nc,
                 ok ? W + (size_t)(k0 + r) * N + n0 + nc : W, ok);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int kt_n = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < kt_n) load(st, st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();     // slice kt has landed
    __syncthreads();                 // ... for every thread; and slice
                                     // kt - 1's stage is free again
    const int nk = kt + STAGES - 1;
    if (nk < kt_n) load(nk % STAGES, nk * BK);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[4][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], as + (wm + mi * 16 + lane % 16) * A_LD + kk +
                               (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + (kk + lane % 8 + ((lane / 8) & 1) * 8) *
                                      B_LD + wn + nj * 16 + (lane / 16) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): rows lane/4 and lane/4 + 8, columns
  // 2 * (lane % 4) + {0, 1}
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + mi * 16 + lane / 4 + h * 8;
      if (gm >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int gn = n0 + wn + ni * 8 + 2 * (lane % 4);
        if (gn >= N) continue;       // N is a multiple of 8: pairs stay whole
        const size_t o = (size_t)gm * N + gn;
        float v0 = acc[mi][ni][2 * h] + bv[gn];
        float v1 = acc[mi][ni][2 * h + 1] + bv[gn + 1];
        if (EPI == 0) {
          v0 = gelu_tanh(__bfloat162float(__float2bfloat16_rn(v0)));
          v1 = gelu_tanh(__bfloat162float(__float2bfloat16_rn(v1)));
        } else if (EPI == 2) {
          const __nv_bfloat162 s =
              *reinterpret_cast<const __nv_bfloat162*>(shortcut + o);
          v0 = __bfloat162float(s.x) + gamma[gn] * v0;
          v1 = __bfloat162float(s.y) + gamma[gn + 1] * v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const int* tile_expert, int tile_rows,
           const void* w, const float* bias, const void* shortcut,
           const float* gamma, void* out, int M, int K, int N, int epilogue,
           cudaStream_t stream);

template <>
int launch<float>(const void* a, const int* te, int tr, const void* w,
                  const float* bias, const void* sc, const float* gamma,
                  void* out, int M, int K, int N, int epilogue,
                  cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* A = static_cast<const float*>(a);
  const float* W = static_cast<const float*>(w);
  const float* S = static_cast<const float*>(sc);
  float* O = static_cast<float*>(out);
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

template <>
int launch<bf16>(const void* a, const int* te, int tr, const void* w,
                 const float* bias, const void* sc, const float* gamma,
                 void* out, int M, int K, int N, int epilogue,
                 cudaStream_t stream) {
  // 16-byte cp.async chunks and bf16 pairs in the epilogue
  if (K % 8 || N % 8 || (uintptr_t)a % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)out % 4 || (uintptr_t)sc % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* W = static_cast<const bf16*>(w);
  const bf16* S = static_cast<const bf16*>(sc);
  bf16* O = static_cast<bf16*>(out);
  void (*kern)(const bf16*, const int*, int, const bf16*, const float*,
               const bf16*, const float*, bf16*, int, int, int);
  switch (epilogue) {
    case 0: kern = gemm_bf16_kernel<0>; break;
    case 1: kern = gemm_bf16_kernel<1>; break;
    case 2: kern = gemm_bf16_kernel<2>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  // above 48 KB, dynamic shared memory has to be asked for
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM16);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS16, SMEM16, stream>>>(A, te, tr, W, bias, S, gamma, O,
                                           M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sm3det_grouped_gemm(const void* a, const int* tile_expert,
                                   int tile_rows, const void* w,
                                   const float* bias, const void* shortcut,
                                   const float* gamma, void* out, int M,
                                   int K, int N, int epilogue, int bf16,
                                   cudaStream_t stream) {
  if (tile_expert != nullptr && (tile_rows <= 0 || tile_rows % BM != 0))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(a, tile_expert, tile_rows, w, bias,
                                 shortcut, gamma, out, M, K, N, epilogue,
                                 stream);
  return launch<float>(a, tile_expert, tile_rows, w, bias, shortcut, gamma,
                       out, M, K, N, epilogue, stream);
}
