// Multi-level rotated RoI align (forward), NHWC, fp32 or bf16 features.
//
// Replaces: sm3det_tpu/ops/pallas/roi_align_kernel.py::
//   roi_align_rotated_pyramid_fused and ::..._fused_bucketed. One direct
//   bilinear-sampling kernel stands for both: the static (PATCH, PATCH, C)
//   window copy, the one-hot stencil product, the size buckets and the
//   extent clamp of the level routing exist there only because that
//   hardware needs static windows.
//
// Contract: sm3det_tpu_torch/ops/roi_align_rotated.py::
// roi_align_rotated_pyramid (aligned, clockwise). RoI n = (batch, cx, cy,
// w, h, theta) in image pixels reads level lvls[n]; with s = 1 / stride,
// centre (cx s - .5, cy s - .5), size (w s, h s), angle -theta. Bin (ph,
// pw) averages sample_num^2 samples at local (yy, xx) = (-h/2 + (ph +
// (iy + .5) / sample_num) h / out, ...), rotated by the angle and shifted
// to the centre. A sample with y < -1, y > H, x < -1 or x > W adds 0; else
// it is clipped to [0, H - 1] x [0, W - 1] and read bilinearly with fp32
// weights. The coordinates are computed with separately rounded operations
// in the plain version's order (exact_math.cuh), so the border tests agree
// with it bit for bit; the taps accumulate in fp32 and round once to the
// feature type at the store. (The TPU kernel rounds the bilinear weights
// to bf16 for its matrix product; this one keeps them fp32.)
//
// Bound on the H100: device memory. The output (N * out^2 * C values) and
// the pyramid are read and written once; the 16 taps of a bin mostly hit
// L2 (neighbouring samples share pixels).
//
// Design: one block per (RoI, bin row). The first out * sample_num^2
// threads work out the row's samples, four tap offsets and four weights
// each, into shared memory. Then the threads run across the channels, two
// channels a thread, so each tap is one coalesced read of the pixel's C
// contiguous values (512 bytes at C = 256 in bf16), and the store is
// coalesced too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int MAX_SAMPLES = 64;  // out_size * sample_num^2 of one bin row

struct Pyramid {
  const void* feat[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  float inv_stride[MAX_LEVELS];
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

template <typename T>
__global__ void roi_align_rotated_kernel(Pyramid pyr,
                                         const float* __restrict__ rois,
                                         const int* __restrict__ lvls,
                                         T* __restrict__ out, int B, int C,
                                         int out_size, int sample_num) {
  using namespace exact;
  __shared__ int s_off[MAX_SAMPLES][4];
  __shared__ float s_wgt[MAX_SAMPLES][4];
  const int n = blockIdx.x, ph = blockIdx.y;
  const int per_bin = sample_num * sample_num;
  const int n_samples = out_size * per_bin;

  const float* roi = rois + (size_t)n * 6;
  int lvl = lvls[n];
  lvl = lvl < 0 ? 0 : (lvl >= MAX_LEVELS ? MAX_LEVELS - 1 : lvl);
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  int b = (int)roi[0];
  b = b < 0 ? 0 : (b >= B ? B - 1 : b);

  for (int s = threadIdx.x; s < n_samples; s += blockDim.x) {
    const int pw = s / per_bin, iy = (s % per_bin) / sample_num,
              ix = s % sample_num;
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
    const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);
    const float ly = sub(y, (float)y0), lx = sub(x, (float)x0);
    const float hy = sub(1.f, ly), hx = sub(1.f, lx);
    s_off[s][0] = y0 * W + x0;
    s_off[s][1] = y0 * W + x1;
    s_off[s][2] = y1 * W + x0;
    s_off[s][3] = y1 * W + x1;
    s_wgt[s][0] = oob ? 0.f : mul(hy, hx);
    s_wgt[s][1] = oob ? 0.f : mul(hy, lx);
    s_wgt[s][2] = oob ? 0.f : mul(ly, hx);
    s_wgt[s][3] = oob ? 0.f : mul(ly, lx);
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(pyr.feat[lvl]) + (size_t)b * H * W * C;
  T* orow = out + ((size_t)n * out_size + ph) * out_size * C;
  const float count = (float)per_bin;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * blockDim.x) {
    for (int pw = 0; pw < out_size; ++pw) {
      float2 acc = make_float2(0.f, 0.f);
      for (int k = 0; k < per_bin; ++k) {
        const int s = pw * per_bin + k;
        float2 v = make_float2(0.f, 0.f);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = load2(feat + (size_t)s_off[s][t] * C + c);
          const float wt = s_wgt[s][t];
          v.x = fmaf(wt, f.x, v.x);
          v.y = fmaf(wt, f.y, v.y);
        }
        acc.x += v.x;
        acc.y += v.y;
      }
      store2(orow + (size_t)pw * C + c,
             make_float2(acc.x / count, acc.y / count));
    }
  }
}

}  // namespace

// feats: n_levels pointers (B, h[l], w[l], C), contiguous; C even.
extern "C" int sm3det_roi_align_rotated(
    const void* f0, const void* f1, const void* f2, const void* f3, int h0,
    int h1, int h2, int h3, int w0, int w1, int w2, int w3, float s0, float s1,
    float s2, float s3, const float* rois, const int* lvls, void* out, int B,
    int C, int N, int out_size, int sample_num, int bf16,
    cudaStream_t stream) {
  if (out_size * sample_num * sample_num > MAX_SAMPLES || (C & 1) ||
      out_size > 65535)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
                 {s0, s1, s2, s3}};
  int threads = ((C / 2 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dim3 grid(N, out_size);
  if (bf16)
    roi_align_rotated_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        pyr, rois, lvls, static_cast<__nv_bfloat16*>(out), B, C, out_size,
        sample_num);
  else
    roi_align_rotated_kernel<float><<<grid, threads, 0, stream>>>(
        pyr, rois, lvls, static_cast<float*>(out), B, C, out_size,
        sample_num);
  return (int)cudaGetLastError();
}
