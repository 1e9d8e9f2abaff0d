// Multi-level rotated RoI align, feature gradient (backward), NHWC.
//
// Replaces: sm3det_tpu/ops/pallas/roi_align_kernel.py::
//   roi_align_rotated_pyramid_fused_bwd. The TPU kernel forms each RoI's
//   window gradient with one stencil matrix product and read-modify-writes
//   the window into a gradient slab, serialising RoIs whose windows
//   overlap. None of that is needed here: the backward is a scatter, and
//   the card adds into device memory atomically.
//
// Contract: the gradient with respect to the features of the forward
// (roi_align_rotated.cu, the same sample geometry from
// roi_align_rotated.cuh), with no gradient for the RoIs, as the reference
// op has none: every sample adds g[n, ph, pw, c] / sample_num^2 times each
// of its four bilinear weights into its four taps. The gradient of each
// level accumulates in an fp32 buffer (B, H_l, W_l, C) that the caller
// zeroes and later rounds to the feature type. fp32 atomics commit in no
// fixed order, so the sums differ from run to run by rounding.
//
// Bound on the H100: device memory. The cotangent is read once and each
// level's buffer written once, at least; the atomics land in L2, where
// neighbouring samples' taps overlap.
//
// Design: the forward's, mirrored. One block per (RoI, bin row) computes
// the row's samples into shared memory; then the threads run across the
// channels, two a thread: each reads its two cotangent values of a bin
// once and adds them into the 4 taps of the bin's samples with fp32
// atomicAdd (coalesced: neighbouring threads, neighbouring channels).
// Samples outside the level weigh 0 and add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_rotated.cuh"

using namespace roi_align;

namespace {

template <typename T>
__global__ void roi_align_rotated_bwd_kernel(Pyramid grads,
                                             const float* __restrict__ rois,
                                             const int* __restrict__ lvls,
                                             const T* __restrict__ g, int B,
                                             int C, int out_size,
                                             int sample_num) {
  __shared__ int s_off[MAX_SAMPLES][4];
  __shared__ float s_wgt[MAX_SAMPLES][4];
  const int n = blockIdx.x, ph = blockIdx.y;
  const int per_bin = sample_num * sample_num;
  const float* roi = rois + (size_t)n * 6;
  int lvl, b;
  roi_level_batch(roi, lvls, n, B, &lvl, &b);
  const int H = grads.h[lvl], W = grads.w[lvl];
  row_samples(grads, roi, lvl, ph, out_size, sample_num, s_off, s_wgt);
  __syncthreads();

  float* gfeat = static_cast<float*>(grads.feat[lvl]) + (size_t)b * H * W * C;
  const T* grow = g + ((size_t)n * out_size + ph) * out_size * C;
  const float inv_count = 1.f / (float)per_bin;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * blockDim.x) {
    for (int pw = 0; pw < out_size; ++pw) {
      float2 gv = load2(grow + (size_t)pw * C + c);
      gv.x *= inv_count;
      gv.y *= inv_count;
      for (int k = 0; k < per_bin; ++k) {
        const int s = pw * per_bin + k;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float wt = s_wgt[s][t];
          if (wt == 0.f) continue;
          float* p = gfeat + (size_t)s_off[s][t] * C + c;
          atomicAdd(p, wt * gv.x);
          atomicAdd(p + 1, wt * gv.y);
        }
      }
    }
  }
}

}  // namespace

// grads: n_levels fp32 pointers (B, h[l], w[l], C), zeroed, contiguous;
// g: (N, out_size, out_size, C) in the feature type; C even.
extern "C" int sm3det_roi_align_rotated_bwd(
    void* g0, void* g1, void* g2, void* g3, int h0, int h1, int h2, int h3,
    int w0, int w1, int w2, int w3, float s0, float s1, float s2, float s3,
    const float* rois, const int* lvls, const void* g, int B, int C, int N,
    int out_size, int sample_num, int bf16, cudaStream_t stream) {
  if (out_size * sample_num * sample_num > MAX_SAMPLES || (C & 1) ||
      out_size > 65535)
    return (int)cudaErrorInvalidValue;
  Pyramid grads = {{g0, g1, g2, g3},
                   {h0, h1, h2, h3},
                   {w0, w1, w2, w3},
                   {s0, s1, s2, s3}};
  int threads = ((C / 2 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dim3 grid(N, out_size);
  if (bf16)
    roi_align_rotated_bwd_kernel<__nv_bfloat16>
        <<<grid, threads, 0, stream>>>(
            grads, rois, lvls, static_cast<const __nv_bfloat16*>(g), B, C,
            out_size, sample_num);
  else
    roi_align_rotated_bwd_kernel<float><<<grid, threads, 0, stream>>>(
        grads, rois, lvls, static_cast<const float*>(g), B, C, out_size,
        sample_num);
  return (int)cudaGetLastError();
}
