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

// __fdiv_rn(inter, uni) > thr, with uni > 0, decided without the division
// where it can be (thr_normal: thr is a positive normal float). Let r =
// fl(thr * uni). If inter > fl(r * (1 + 2^-21)), the exact quotient
// exceeds thr * (1 + 2^-23) (each rounding moves a product by at most
// 2^-24 of it), past the midpoint between thr and the next float, so the
// rounded quotient is above thr. If inter < fl(r * (1 - 2^-21)), the exact
// quotient is below thr, and so is its rounding (rounding is monotone and
// thr is a float). Otherwise, or when r is not a normal float far from
// overflow, or thr is not normal, the decision is "unsure" and the rounded
// quotient decides.
__device__ __forceinline__ bool iou_above_sure(float inter, float uni,
                                               float thr, bool thr_normal,
                                               bool& unsure) {
  const float r = __fmul_rn(thr, uni);
  const bool above = inter > __fmul_rn(r, 1.f + 0x1p-21f);
  const bool below = inter < __fmul_rn(r, 1.f - 0x1p-21f);
  unsure = !thr_normal || !(r >= 1e-30f && r <= 1e30f) || !(above || below);
  return above && !unsure;
}

}  // namespace exact
