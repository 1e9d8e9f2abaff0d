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
// in fp32 (per sample its four taps, then the samples of a bin, divided by
// their count) and round once to the feature type at the store. (The TPU
// kernel rounds the bilinear weights to bf16 for its matrix product; this
// one keeps them fp32.)
//
// Bound on the H100: device memory. The output (N * out^2 * C values) and
// the pyramid are read and written once. Every bin reads 16 taps of C
// channels, 16 x 512 bytes at C = 256 in bf16: read one by one from L2
// that is ~6.4 GB for the joint forward's 16000 RoIs, far more than the
// 0.6 GB of device memory the call must move.
//
// Design: one block a RoI. Its out^2 sample_num^2 samples (196 at 7 x 2)
// are placed once, one a thread (cosf / sinf once a sample, not once a
// bin row as before). The pixels their taps touch form, row by row of the
// level, a span [xlo(y), xhi(y)] (shared-memory atomics); the spans side
// by side are the RoI's footprint, P pixels, usually far fewer than the
// 4 out^2 sample_num^2 taps (the joint forward's proposals: a median of
// 49 pixels against 784 taps). Where the whole footprint, all C channels,
// fits the 32 KB stage (P <= 64 at C = 256 in bf16: most proposals), one
// thread a row sends that row's span, contiguous in NHWC, into shared
// memory with one 1-D TMA bulk copy (cp.async.bulk, all on one mbarrier),
// each pixel read from L2 once, while the block turns the taps into
// indices into the footprint; the bins then read their taps from shared
// memory. A larger footprint (a large RoI, or one routed to a level finer
// than its size) reads its taps from device memory. Either way a thread
// owns one bin and 16 bytes of channels (8 bf16): the 16 tap reads, 128
// FMAs and the 16-byte store of a bin are one thread's, and a warp's
// reads cover a pixel's channels side by side. On the H100
// (tools/profiling/torch_roi_align_variants.py) staging only the whole
// footprint beat not staging at all, and beat staging a larger RoI in
// bands of bin rows (more barriers a RoI); sending the unstaged RoIs'
// taps past L1 barely moved the time, so their reads from L2 are not what
// holds the kernel. (Staging in channel chunks with cp.async of 16 bytes
// was slower too.) No atomics on the output: the same inputs give the
// same bits on every run; the sums run in the order of the bin-row kernel
// this one replaces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "device_cache.cuh"
#include "roi_align_rotated.cuh"
#include "vec_io.cuh"
#include "wgmma_sm90.cuh"

using namespace roi_align;

namespace {

using namespace sm90;
using namespace vec_io;

constexpr int THREADS = 256;
constexpr int STAGE_BYTES = 32 * 1024;   // the footprint's shared memory
constexpr int MAX_ROI_SAMPLES = 1024;    // out^2 sample_num^2

// shared memory after the stage: tap indices and weights [S][4], the row
// spans xlo, xhi and their starts in the footprint [max_rows] each,
// ymin, ymax and P, and the stage's mbarrier (8-byte aligned: max_rows is
// rounded up to even)
__host__ __device__ inline size_t smem_bytes(int n_samples, int max_rows) {
  return STAGE_BYTES + (size_t)n_samples * 32 + (size_t)max_rows * 12 + 24;
}

// The block's bins, C channels at `base` (pixel p of the taps' indices at
// base + p * C): each thread a (bin, VE channels) at a time, its 16 taps
// at 7 x 2 all in flight; the samples in order, each its four taps summed
// from 0, then divided by their count, as the bin-row kernel this one
// replaces summed them. Called with the stage, the compiler reads it
// with shared-memory loads.
template <typename T, int VE, int SN>
__device__ __forceinline__ void pool_bins(const T* base, int (*s_idx)[4],
                                          float (*s_wgt)[4], int n_bins,
                                          int per_bin, int C, T* out) {
  const int nvk = C / VE;
  const float count = (float)per_bin;
  for (int it = threadIdx.x; it < n_bins * nvk; it += THREADS) {
    const int bin = it / nvk, u = it % nvk;
    const T* bp = base + u * VE;
    float acc[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = 0.f;
#pragma unroll
    for (int k = 0; k < (SN ? SN * SN : per_bin); ++k) {
      const int s = bin * per_bin + k;
      float v[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) v[e] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float f[VE];
        unpack<VE>(bp + (size_t)s_idx[s][t] * C, f);
        const float wt = s_wgt[s][t];
#pragma unroll
        for (int e = 0; e < VE; ++e) v[e] = fmaf(wt, f[e], v[e]);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] = acc[e] / count;
    pack_store<VE>(out + (size_t)bin * C + u * VE, acc);
  }
}

// T: feature type; VE: channels a read (16 bytes where C allows, else a
// pair); OUT, SN: out_size and sample_num, 0 for the values given at run
// time
template <typename T, int VE, int OUT, int SN>
__global__ void __launch_bounds__(THREADS)
roi_align_rotated_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ lvls, T* __restrict__ out,
                         int B, int C, int out_rt, int sn_rt, int max_rows) {
  const int out_size = OUT ? OUT : out_rt;
  const int sn = SN ? SN : sn_rt;
  const int per_bin = sn * sn, n_bins = out_size * out_size;
  const int n_samples = n_bins * per_bin;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  int (*s_idx)[4] = reinterpret_cast<int (*)[4]>(smem + STAGE_BYTES);
  float (*s_wgt)[4] = reinterpret_cast<float (*)[4]>(s_idx + n_samples);
  int* xlo = reinterpret_cast<int*>(s_wgt + n_samples);
  int* xhi = xlo + max_rows;
  int* rbase = xhi + max_rows;
  int* misc = rbase + max_rows;             // ymin, ymax, P
  uint64_t* bar = reinterpret_cast<uint64_t*>(misc + 4);

  const int n = blockIdx.x, tid = threadIdx.x;
  const float* roi = rois + (size_t)n * 6;
  int lvl, b;
  roi_level_batch(roi, lvls, n, B, &lvl, &b);
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  const T* feat = static_cast<const T*>(pyr.feat[lvl]) + (size_t)b * H * W * C;

  // 1. the samples: tap rows / columns (in s_idx for now) and weights,
  // and the rows they span
  if (tid == 0) {
    misc[0] = INT_MAX;
    misc[1] = -1;
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = tid; r < max_rows; r += THREADS) {
    xlo[r] = INT_MAX;
    xhi[r] = -1;
  }
  __syncthreads();
  int ylo = INT_MAX, yhi = -1;
  for (int s = tid; s < n_samples; s += THREADS) {
    const int bin = s / per_bin, k = s % per_bin;
    sample_taps(pyr, roi, lvl, bin / out_size, bin % out_size, k / sn,
                k % sn, out_size, sn, s_idx[s], s_wgt[s]);
    ylo = min(ylo, s_idx[s][0]);
    yhi = max(yhi, s_idx[s][2]);
  }
  if (yhi >= 0) {
    atomicMin(misc, ylo);
    atomicMax(misc + 1, yhi);
  }
  __syncthreads();
  // 2. each row's span of columns
  const int ymin = misc[0], rows = misc[1] - ymin + 1;
  for (int s = tid; s < n_samples; s += THREADS) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = s_idx[s][2 * q] - ymin;
      atomicMin(xlo + r, s_idx[s][1]);
      atomicMax(xhi + r, s_idx[s][3]);
    }
  }
  __syncthreads();
  // 3. where each row's span starts in the footprint (warp 0 scans)
  if (tid < 32) {
    int carry = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + tid;
      const int len = r < rows && xhi[r] >= xlo[r] ? xhi[r] - xlo[r] + 1
                                                    : 0;
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      if (r < rows) rbase[r] = carry + incl - len;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (tid == 0) misc[2] = carry;
  }
  __syncthreads();
  // 4. the footprint is staged whole, all C channels, one bulk copy a
  // row, where it fits; else the taps are read from device memory
  const int P = misc[2];
  const bool staged = VE * sizeof(T) == 16 &&
                      (size_t)P * C * sizeof(T) <= STAGE_BYTES;
  if (staged && tid < 32) {
    if (tid == 0) mbar_expect_tx(bar, (uint32_t)(P * C * sizeof(T)));
    __syncwarp();
    for (int r = tid; r < rows; r += 32) {
      const int len = xhi[r] >= xlo[r] ? xhi[r] - xlo[r] + 1 : 0;
      if (len > 0)
        bulk_load(stage + (size_t)rbase[r] * C,
                  feat + ((size_t)(ymin + r) * W + xlo[r]) * C,
                  (uint32_t)(len * C * sizeof(T)), bar);
    }
  }
  // 5. tap rows / columns -> indices into the footprint (or the image),
  // while the copies are in flight
  for (int s = tid; s < n_samples; s += THREADS) {
    const int y0 = s_idx[s][0], x0 = s_idx[s][1];
    const int y1 = s_idx[s][2], x1 = s_idx[s][3];
    if (staged) {
      const int b0 = rbase[y0 - ymin] - xlo[y0 - ymin];
      const int b1 = rbase[y1 - ymin] - xlo[y1 - ymin];
      s_idx[s][0] = b0 + x0;
      s_idx[s][1] = b0 + x1;
      s_idx[s][2] = b1 + x0;
      s_idx[s][3] = b1 + x1;
    } else {
      s_idx[s][0] = y0 * W + x0;
      s_idx[s][1] = y0 * W + x1;
      s_idx[s][2] = y1 * W + x0;
      s_idx[s][3] = y1 * W + x1;
    }
  }
  __syncthreads();
  T* orow = out + (size_t)n * n_bins * C;
  if (staged) {
    mbar_wait(bar, 0);
    pool_bins<T, VE, SN>(stage, s_idx, s_wgt, n_bins, per_bin, C, orow);
  } else {
    pool_bins<T, VE, SN>(feat, s_idx, s_wgt, n_bins, per_bin, C, orow);
  }
}

template <typename T, int VE, int OUT, int SN>
int launch_k(const Pyramid& pyr, const float* rois, const int* lvls,
             void* out, int B, int C, int N, int out_size, int sample_num,
             int max_rows, cudaStream_t stream) {
  constexpr auto kern = roi_align_rotated_kernel<T, VE, OUT, SN>;
  const size_t smem =
      smem_bytes(out_size * out_size * sample_num * sample_num, max_rows);
  const int err = devcache::set_smem<kern>(smem);
  if (err != 0) return err;
  kern<<<N, THREADS, smem, stream>>>(pyr, rois, lvls, static_cast<T*>(out),
                                     B, C, out_size, sample_num, max_rows);
  return (int)cudaGetLastError();
}

template <typename T, int VE>
int launch(const Pyramid& pyr, const float* rois, const int* lvls, void* out,
           int B, int C, int N, int out_size, int sample_num, int max_rows,
           cudaStream_t stream) {
  if (out_size == 7 && sample_num == 2)
    return launch_k<T, VE, 7, 2>(pyr, rois, lvls, out, B, C, N, out_size,
                                 sample_num, max_rows, stream);
  return launch_k<T, VE, 0, 0>(pyr, rois, lvls, out, B, C, N, out_size,
                               sample_num, max_rows, stream);
}

}  // namespace

// feats: n_levels pointers (B, h[l], w[l], C), contiguous, 16-byte aligned;
// C even.
extern "C" int sm3det_roi_align_rotated(
    const void* f0, const void* f1, const void* f2, const void* f3, int h0,
    int h1, int h2, int h3, int w0, int w1, int w2, int w3, float s0, float s1,
    float s2, float s3, const float* rois, const int* lvls, void* out, int B,
    int C, int N, int out_size, int sample_num, int bf16,
    cudaStream_t stream) {
  const int n_samples = out_size * out_size * sample_num * sample_num;
  if (n_samples < 1 || n_samples > MAX_ROI_SAMPLES || (C & 1) || C <= 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Pyramid pyr = {{const_cast<void*>(f0), const_cast<void*>(f1),
                  const_cast<void*>(f2), const_cast<void*>(f3)},
                 {h0, h1, h2, h3},
                 {w0, w1, w2, w3},
                 {s0, s1, s2, s3}};
  int max_rows = 1;
  for (int l = 0; l < MAX_LEVELS; ++l)
    max_rows = pyr.h[l] > max_rows ? pyr.h[l] : max_rows;
  max_rows += max_rows & 1;                  // the mbarrier's alignment
  const size_t esize = bf16 ? 2 : 4;
  bool aligned = (C * esize) % 16 == 0;
  for (int l = 0; l < MAX_LEVELS; ++l)
    aligned = aligned && reinterpret_cast<uintptr_t>(pyr.feat[l]) % 16 == 0;
  aligned = aligned && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (smem_bytes(n_samples, max_rows) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
#define SM3DET_ALIGN(T, VE)                                                  \
  return launch<T, VE>(pyr, rois, lvls, out, B, C, N, out_size, sample_num, \
                       max_rows, stream)
  if (bf16) {
    if (aligned) SM3DET_ALIGN(__nv_bfloat16, 8);
    SM3DET_ALIGN(__nv_bfloat16, 2);
  }
  if (aligned) SM3DET_ALIGN(float, 4);
  SM3DET_ALIGN(float, 2);
#undef SM3DET_ALIGN
}
