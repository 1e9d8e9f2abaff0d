// LayerNorm over the trailing (channel) axis, fp32 statistics.
//
// Replaces: sm3det_tpu/ops/pallas/convnext_block_kernel.py::fused_layernorm
//   (_ln_kernel). The JAX package leaves its own LayerNormOpt to XLA; the
//   port runs the backbone's stem, downsample and output LayerNorms
//   through this kernel.
//
// Contract (that of layernorm_math): mean and E[x^2] of the row in fp32,
// var = max(E[x^2] - mean^2, 0), y = (x - mean) * (rsqrt(var + eps) *
// scale) + bias in fp32, rounded once to the output type. Input fp32 or
// bf16, output fp32 or bf16, C <= 1024.
//
// Bound on the H100: device memory. Each element is read once and written
// once for ~8 flops, so the least time is (input + output bytes) /
// 3.35 TB/s.
//
// Design: one warp per row, the row kept in registers (C / 32 values a
// lane) from the statistics to the output, so x is read from memory once;
// two shuffle reductions give the sums; consecutive lanes touch
// consecutive channels, so every load and store is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAXV = 32;    // values a lane holds: C <= 32 * 32

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

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(WARPS * 32)
layernorm_kernel(const Tin* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, Tout* __restrict__ out,
                 long long rows, int C, float eps) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                   // uniform across the warp
  const Tin* xr = x + row * C;
  float v[MAXV];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f(xr[c]) : 0.f;
    s += v[i];
    s2 = fmaf(v[i], v[i], s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s / (float)C;
  const float var = fmaxf(s2 / (float)C - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  Tout* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = lane + 32 * i;
    if (c < C) orow[c] = from_f<Tout>((v[i] - mean) * (rstd * scale[c])
                                      + bias[c]);
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const float* scale, const float* bias, void* out,
           long long rows, int C, float eps, cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  layernorm_kernel<Tin, Tout><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      static_cast<const Tin*>(x), scale, bias, static_cast<Tout*>(out),
      rows, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sm3det_layernorm(const void* x, const float* scale,
                                const float* bias, void* out, long long rows,
                                int C, int in_bf16, int out_bf16, float eps,
                                cudaStream_t stream) {
  if (C <= 0 || C > 32 * MAXV) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (in_bf16 && out_bf16)
    return launch<bf, bf>(x, scale, bias, out, rows, C, eps, stream);
  if (in_bf16)
    return launch<bf, float>(x, scale, bias, out, rows, C, eps, stream);
  if (out_bf16)
    return launch<float, bf>(x, scale, bias, out, rows, C, eps, stream);
  return launch<float, float>(x, scale, bias, out, rows, C, eps, stream);
}
