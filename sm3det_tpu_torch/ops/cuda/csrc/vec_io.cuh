// Vector reads and writes of N consecutive fp32 or bf16 elements as fp32
// values, for the bytes-bound kernels (layernorm.cu, roi_align_rotated.cu):
// one instruction of N * sizeof(T) bytes where N * sizeof(T) is 4, 8 or
// 16, two for 8 fp32 values, and a scalar for N = 1. The address must be
// aligned to the access (N * sizeof(T), at most 16 bytes); a generic
// pointer may point to shared or device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vec_io {

template <int N>
__device__ __forceinline__ void unpack(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    static_assert(N == 1, "N: 1, 2 or a multiple of 4");
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void unpack(const __nv_bfloat16* p,
                                       float (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    static_assert(N == 2 || N == 4 || N == 8, "N: 1, 2, 4 or 8");
    uint32_t w[N / 2];
    if constexpr (N == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (N == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x; w[1] = q.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void pack_store(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int N>
__device__ __forceinline__ void pack_store(__nv_bfloat16* p,
                                           const float (&v)[N]) {
  if constexpr (N == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 b =
          __float22bfloat162_rn(make_float2(v[2 * i], v[2 * i + 1]));
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    if constexpr (N == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (N == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

}  // namespace vec_io
