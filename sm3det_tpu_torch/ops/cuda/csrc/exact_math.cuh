// Separately rounded fp32 arithmetic.
//
// nvcc contracts a * b + c into one fused multiply-add, which rounds once
// where PyTorch's elementwise operators round twice. The geometry kernels
// (rotated IoU, RoI align coordinates) feed threshold tests (iou > thr,
// y < -1), so they spell every operation with these round-to-nearest
// intrinsics, which the compiler never contracts: the kernel's values then
// equal those of the plain PyTorch version evaluated on the same card.

#pragma once

#include <cuda_runtime.h>

namespace exact {

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

}  // namespace exact
