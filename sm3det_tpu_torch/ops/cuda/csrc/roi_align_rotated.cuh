// Shared part of the rotated RoI align forward (roi_align_rotated.cu) and
// backward (roi_align_rotated_bwd.cu): the pyramid description and the
// sample geometry (one sample, or one bin row), so that both kernels place
// every sample and weigh every tap identically.
//
// RoI n = (batch, cx, cy, w, h, theta) in image pixels reads level
// lvls[n]; with s = 1 / stride, centre (cx s - .5, cy s - .5), size (w s,
// h s), angle -theta. Bin (ph, pw) averages sample_num^2 samples at local
// (yy, xx) = (-h/2 + (ph + (iy + .5) / sample_num) h / out, ...), rotated
// by the angle and shifted to the centre. A sample with y < -1, y > H,
// x < -1 or x > W weighs 0; else it is clipped to [0, H - 1] x [0, W - 1]
// and read bilinearly with fp32 weights. The coordinates are computed with
// separately rounded operations in the plain version's order
// (exact_math.cuh), so the border tests agree with it bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace roi_align {

constexpr int MAX_LEVELS = 4;
constexpr int MAX_SAMPLES = 64;  // out_size * sample_num^2 of one bin row

struct Pyramid {
  void* feat[MAX_LEVELS];  // features (forward) or fp32 gradients (backward)
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float inv_stride[MAX_LEVELS];
};

// Level and image of RoI n, both clamped to the valid range.
__device__ __forceinline__ void roi_level_batch(const float* roi,
                                                const int* lvls, int n, int B,
                                                int* lvl, int* b) {
  int l = lvls[n];
  *lvl = l < 0 ? 0 : (l >= MAX_LEVELS ? MAX_LEVELS - 1 : l);
  int bb = (int)roi[0];
  *b = bb < 0 ? 0 : (bb >= B ? B - 1 : bb);
}

// Sample (iy, ix) of bin (ph, pw) of RoI `roi` on level `lvl`: the
// clipped pixel rows y0 <= y1 and columns x0 <= x1 of its four taps and
// their weights, in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1); all
// four weights are 0 for a sample outside the level.
__device__ __forceinline__ void sample_taps(const Pyramid& pyr,
                                            const float* roi, int lvl, int ph,
                                            int pw, int iy, int ix,
                                            int out_size, int sample_num,
                                            int (&yx)[4], float (&wgt)[4]) {
  using namespace exact;
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  const float inv = pyr.inv_stride[lvl];
  const float cx = sub(mul(roi[1], inv), 0.5f);
  const float cy = sub(mul(roi[2], inv), 0.5f);
  const float w = mul(roi[3], inv), h = mul(roi[4], inv);
  const float theta = -roi[5];
  const float cos_t = cosf(theta), sin_t = sinf(theta);
  const float bin_h = div(h, (float)out_size);
  const float bin_w = div(w, (float)out_size);
  const float sub_y = div(add((float)iy, 0.5f), (float)sample_num);
  const float sub_x = div(add((float)ix, 0.5f), (float)sample_num);
  const float yy = add(div(-h, 2.f), mul(add((float)ph, sub_y), bin_h));
  const float xx = add(div(-w, 2.f), mul(add((float)pw, sub_x), bin_w));
  float y = add(add(mul(yy, cos_t), mul(xx, sin_t)), cy);
  float x = add(sub(mul(xx, cos_t), mul(yy, sin_t)), cx);
  const bool oob = y < -1.f || y > (float)H || x < -1.f || x > (float)W;
  y = fminf(fmaxf(y, 0.f), (float)(H - 1));
  x = fminf(fmaxf(x, 0.f), (float)(W - 1));
  const int y0 = (int)floorf(y), x0 = (int)floorf(x);
  yx[0] = y0;
  yx[1] = x0;
  yx[2] = min(y0 + 1, H - 1);
  yx[3] = min(x0 + 1, W - 1);
  const float ly = sub(y, (float)y0), lx = sub(x, (float)x0);
  const float hy = sub(1.f, ly), hx = sub(1.f, lx);
  wgt[0] = oob ? 0.f : mul(hy, hx);
  wgt[1] = oob ? 0.f : mul(hy, lx);
  wgt[2] = oob ? 0.f : mul(ly, hx);
  wgt[3] = oob ? 0.f : mul(ly, lx);
}

// The block's threads fill, for bin row ph of RoI `roi` on level `lvl`,
// the four tap offsets (pixels in the level image) and weights of each of
// the out_size * sample_num^2 samples. The caller synchronises after.
__device__ __forceinline__ void row_samples(const Pyramid& pyr,
                                            const float* roi, int lvl, int ph,
                                            int out_size, int sample_num,
                                            int (*s_off)[4],
                                            float (*s_wgt)[4]) {
  const int per_bin = sample_num * sample_num;
  const int n_samples = out_size * per_bin;
  const int W = pyr.w[lvl];
  for (int s = threadIdx.x; s < n_samples; s += blockDim.x) {
    const int pw = s / per_bin, iy = (s % per_bin) / sample_num,
              ix = s % sample_num;
    int yx[4];
    sample_taps(pyr, roi, lvl, ph, pw, iy, ix, out_size, sample_num, yx,
                s_wgt[s]);
    s_off[s][0] = yx[0] * W + yx[1];
    s_off[s][1] = yx[0] * W + yx[3];
    s_off[s][2] = yx[2] * W + yx[1];
    s_off[s][3] = yx[2] * W + yx[3];
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

}  // namespace roi_align
