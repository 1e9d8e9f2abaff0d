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
// roi_align_rotated_pyramid (aligned, clockwise); the sample geometry is
// in roi_align_rotated.cuh, shared with the backward. The taps accumulate
// in fp32 and round once to the feature type at the store. (The TPU
// kernel rounds the bilinear weights to bf16 for its matrix product; this
// one keeps them fp32.)
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

#include "roi_align_rotated.cuh"

using namespace roi_align;

namespace {

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
  __shared__ int s_off[MAX_SAMPLES][4];
  __shared__ float s_wgt[MAX_SAMPLES][4];
  const int n = blockIdx.x, ph = blockIdx.y;
  const int per_bin = sample_num * sample_num;
  const float* roi = rois + (size_t)n * 6;
  int lvl, b;
  roi_level_batch(roi, lvls, n, B, &lvl, &b);
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  row_samples(pyr, roi, lvl, ph, out_size, sample_num, s_off, s_wgt);
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
  Pyramid pyr = {{const_cast<void*>(f0), const_cast<void*>(f1),
                  const_cast<void*>(f2), const_cast<void*>(f3)},
                 {h0, h1, h2, h3},
                 {w0, w1, w2, w3},
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
