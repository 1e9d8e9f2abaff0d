// Multi-level rotated RoI align, feature gradient (backward), NHWC.
//
// Replaces: sm3det_tpu/ops/pallas/roi_align_kernel.py::
//   roi_align_rotated_pyramid_fused_bwd. The TPU kernel forms each RoI's
//   window gradient with one stencil matrix product and read-modify-writes
//   the window into an fp32 gradient slab, RoI after RoI. Here the RoIs are
//   merged by a gather instead: each output tile sums the RoIs that touch
//   it, in RoI order.
//
// Contract: the gradient with respect to the features of the forward
// (roi_align_rotated.cu, the same sample geometry from
// roi_align_rotated.cuh), with no gradient for the RoIs, as the reference
// op has none: every sample adds g[n, ph, pw, c] / sample_num^2 times each
// of its four bilinear weights into its four taps. Each level's gradient
// (B, H_l, W_l, C) is written once, in the feature type, pixels that no RoI
// touches as zeros. Every element's sum is taken in one fixed order (RoIs
// ascending, then bins), in fp32, and rounded once: two runs give the same
// bits. No atomics on device memory. sample_num <= 2, out_size <= 16.
//
// Bound on the H100: device memory. g is read once and every level's
// gradient written once (25.7 MB of bf16 g and 54.4 MB of bf16 gradient at
// the train step's shapes: 0.024 ms at 3.35 TB/s).
//
// Design: two launches.
//   1. stencil (a block a RoI, a thread a bin): the bin's sample_num^2
//      samples give 4 sample_num^2 taps; taps of one pixel are summed (in
//      sample order) into one entry (pixel, weight / sample_num^2), so a
//      bin keeps at most 16 entries, distinct pixels, in a fixed slot
//      range (unused slots, after the used ones, hold the pixel -1). The
//      bin's box of touched pixels, the RoI's box (weights != 0) and its
//      level and image go beside them. The capacities are the shapes': no
//      list can overflow.
//   2. tiles (a block of 512 threads an 8 x 8 pixel tile of one level and
//      image and a chunk of up to 128 channels): the block tests every
//      RoI's box against its tile, 2048 RoIs a pass, and keeps the hits in
//      RoI order (a prefix sum over the block). It takes the hits in
//      batches of up to 9 RoIs (49 bins each; 5 with fp32 g), a thread a
//      (RoI, bin) of the batch: the thread reads its bin's entries and
//      box, and if the box meets the tile, one bulk copy brings the bin's
//      g row into shared memory (cp.async.bulk on an mbarrier; cp.async
//      where rows are not 16-byte multiples). Meanwhile the threads sort
//      the entries inside the tile into one bucket a pixel, in thread
//      order, i.e. (RoI, bin) order: each lane's 64-bit mask of its pixels,
//      transposed across the warp by shuffles, gives the lanes at each
//      pixel; a prefix over the warps and the pixels places them. Then the
//      warps take the tile's pixels one at a time as they come free: a warp
//      walks the pixel's bucket, 4 entries' reads in flight at once, a lane
//      adding weight x g[n, bin, c] for 4 channels into the tile's fp32
//      sums in shared memory. A pixel's sums
//      see its buckets batch after batch, each in order, whichever warp
//      walks it. After the last RoI the tile is rounded and stored, zeros
//      included.
// A RoI touches ~4-25 tiles at the train step (a median footprint of 49
// pixels against 784 taps), so the g rows of its bins are read from L2 a
// few times, not once a tap. RoIs piled on one point serialise in their
// tiles, a batch at a time (chip_smoke.py times that case beside the
// random one).

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

constexpr int TILE = 8;                  // a tile is TILE x TILE pixels
constexpr int TILE_PX = TILE * TILE;
constexpr int THREADS = 512;             // >= the bins of a batch
constexpr int CHUNK_C = 128;             // channels of a tile block
constexpr int WARPS = THREADS / 32;
constexpr int LANE_C = CHUNK_C / 32;     // channels a lane: 4
constexpr int MAX_SN = 2;                // sample_num: taps a bin <= 16
constexpr int CAP = 16;                  // entries a bin: 4 sample_num^2
constexpr int MAX_BINS = THREADS;        // out_size^2
constexpr int NO_PIXEL = -1;
constexpr int MAX_SIDE = 32767;          // a level's rows, columns <
constexpr int EMPTY = MAX_SIDE;          // lower bound of an empty box
constexpr int MAX_HB = 16;               // hit RoIs summed a batch
constexpr int SMEM_BUDGET = 208 * 1024;  // sums, a batch's g rows, entries
constexpr int KR = 4;                    // RoIs a thread tests a pass
constexpr int UNROLL = 4;                // bucket entries read at once
constexpr int HIT_SCAN = KR * THREADS;   // RoIs tested a pass

struct Tiling {
  int first[MAX_LEVELS + 1];  // first tile of each level; [L] = total
  int tx[MAX_LEVELS];         // tiles a row of the level
  int ty[MAX_LEVELS];         // tile rows of the level
};

// ---- 1. stencil ----------------------------------------------------------

// entries: (N, CAP, n_bins) int2 (pixel y << 16 | x, weight bits), slot
// major, so that neighbouring bins' slots are neighbours;
// bin_box: (N, n_bins) int2, the bin's touched rows ylo << 16 | yhi and
// columns xlo << 16 | xhi (ylo = EMPTY: none); info: (N) int4, the RoI's
// lvl << 16 | b and its touched box in the same packing, and 0
__global__ void __launch_bounds__(64)
stencil_kernel(Pyramid pyr, const float* __restrict__ rois,
               const int* __restrict__ lvls, int2* __restrict__ entries,
               int2* __restrict__ bin_box, int4* __restrict__ info, int B,
               int out_size, int sn) {
  __shared__ int box[4];
  const int n = blockIdx.x, tid = threadIdx.x;
  const float* roi = rois + (size_t)n * 6;
  int lvl, b;
  roi_level_batch(roi, lvls, n, B, &lvl, &b);
  const int per_bin = sn * sn;
  const int n_bins = out_size * out_size;
  const float inv_count = 1.f / (float)per_bin;
  if (tid == 0) {
    box[0] = INT_MAX;
    box[1] = -1;
    box[2] = INT_MAX;
    box[3] = -1;
  }
  __syncthreads();
  int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
  for (int bin = tid; bin < n_bins; bin += blockDim.x) {
    int key[CAP];
    float wsum[CAP];
    int cnt = 0;
    int by0 = EMPTY, by1 = 0, bx0 = EMPTY, bx1 = 0;
    for (int k = 0; k < per_bin; ++k) {
      int yx[4];
      float wgt[4];
      sample_taps(pyr, roi, lvl, bin / out_size, bin % out_size, k / sn,
                  k % sn, out_size, sn, yx, wgt);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (wgt[t] == 0.f) continue;
        const int y = yx[t < 2 ? 0 : 2], x = yx[(t & 1) ? 3 : 1];
        const int kk = (y << 16) | x;
        int j = 0;
        while (j < cnt && key[j] != kk) ++j;
        if (j == cnt) {
          key[cnt] = kk;
          wsum[cnt++] = wgt[t];
        } else {
          wsum[j] += wgt[t];
        }
        by0 = min(by0, y);
        by1 = max(by1, y);
        bx0 = min(bx0, x);
        bx1 = max(bx1, x);
      }
    }
    int2* e = entries + (size_t)n * CAP * n_bins + bin;
    for (int j = 0; j < CAP; ++j)
      e[(size_t)j * n_bins] =
          j < cnt ? make_int2(key[j], __float_as_int(wsum[j] * inv_count))
                  : make_int2(NO_PIXEL, 0);
    bin_box[(size_t)n * n_bins + bin] =
        make_int2((by0 << 16) | by1, (bx0 << 16) | bx1);
    if (cnt) {
      ylo = min(ylo, by0);
      yhi = max(yhi, by1);
      xlo = min(xlo, bx0);
      xhi = max(xhi, bx1);
    }
  }
  if (yhi >= 0) {
    atomicMin(box, ylo);
    atomicMax(box + 1, yhi);
    atomicMin(box + 2, xlo);
    atomicMax(box + 3, xhi);
  }
  __syncthreads();
  if (tid == 0) {
    const bool none = box[1] < 0;           // no pixel: a box no tile meets
    info[n] = make_int4((lvl << 16) | b,
                        none ? (EMPTY << 16) : (box[0] << 16) | box[1],
                        none ? (EMPTY << 16) : (box[2] << 16) | box[3], 0);
  }
}

// ---- 2. tiles ------------------------------------------------------------

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __float22bfloat162_rn(make_float2(a, b));
}

// Block-wide exclusive prefix sum of v in thread order; *total gets the
// block's sum. Every thread of the block calls it.
__device__ __forceinline__ int ordered_offset(int v, int* warp_n,
                                              int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_n[warp] = incl;
  __syncthreads();
  int off = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int c = warp_n[w];
    off += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  __syncthreads();                         // warp_n is read by all
  return off + incl - v;
}

// one asynchronous copy of `bytes` (4, 8 or 16) into shared memory
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// Whether a bin's packed box (ylo << 16 | yhi, xlo << 16 | xhi) meets the
// tile at (y0, x0)
__device__ __forceinline__ bool bin_meets(int2 bb, int y0, int x0) {
  return (bb.x >> 16) < y0 + TILE && (bb.x & 0xffff) >= y0 &&
         (bb.y >> 16) < x0 + TILE && (bb.y & 0xffff) >= x0;
}


// The warp's 32 x 32 bit matrix, row `lane` in x, transposed: lane l gets
// bit r = bit l of lane r's x. Stage j swaps bit j of the row and column
// index of every element; the stages commute.
__device__ __forceinline__ unsigned transpose32(unsigned x) {
  const int lane = threadIdx.x & 31;
  const unsigned lo[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                          0x55555555u};
#pragma unroll
  for (int s = 0, j = 16; s < 5; ++s, j >>= 1) {
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~lo[s]) | ((y >> j) & lo[s])
                   : (x & lo[s]) | ((y << j) & ~lo[s]);
  }
  return x;
}

// TG: type of g; TO: type of the gradient. Shared memory: g of a batch of
// hb hit RoIs [hb * n_bins][CHUNK_C] (TG; only the rows of bins that meet
// the tile are read in), the batch's entries inside the tile bucketed by
// pixel [hb * n_bins * CAP] (bin of the batch, weight bits).
template <typename TG, typename TO>
__global__ void __launch_bounds__(THREADS)
tile_kernel(Pyramid grads, Tiling tiling, const int2* __restrict__ entries,
            const int2* __restrict__ bin_box, const int4* __restrict__ info,
            const TG* __restrict__ g, int N, int C, int n_bins, int hb,
            int unit, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);      // [TILE_PX][CHUNK_C]
  TG* gst = reinterpret_cast<TG*>(acc + TILE_PX * CHUNK_C);
  int2* list = reinterpret_cast<int2*>(gst + (size_t)hb * n_bins * CHUNK_C);
  __shared__ int hits[HIT_SCAN];
  __shared__ int warp_n[THREADS / 32];
  __shared__ unsigned wmask[THREADS / 32][TILE_PX];  // lanes at a pixel
  __shared__ int wpre[THREADS / 32][TILE_PX];        // earlier warps' count
  __shared__ int start[TILE_PX + 1];                 // the buckets
  __shared__ int next_px;                            // pixels handed out
  __shared__ uint64_t bar;                           // the g rows' copies
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int l = 0;
  while (l + 1 < MAX_LEVELS && (int)blockIdx.x >= tiling.first[l + 1]) ++l;
  int r = blockIdx.x - tiling.first[l];
  const int per_img = tiling.tx[l] * tiling.ty[l];
  const int b = r / per_img;
  r %= per_img;
  const int y0 = (r / tiling.tx[l]) * TILE, x0 = (r % tiling.tx[l]) * TILE;
  const int H = grads.h[l], W = grads.w[l];
  const int c0 = blockIdx.y * CHUNK_C;
  const int cc = min(CHUNK_C, C - c0);
  // a warp: pixels warp + WARPS k of the tile; a lane: channels [cs, cs +
  // LANE_C) of the chunk, so a warp reads a g row whole, conflict-free
  const int cs = lane * LANE_C;
  const bool full = cs + LANE_C <= cc;   // else pairs, up to cc
  const int where = (l << 16) | b;
  const int row_bytes = cc * (int)sizeof(TG);
  const bool bulk = unit == 16;          // a bulk copy a row, else cp.async
  uint32_t phase = 0;
  for (int i = tid; i < TILE_PX * CHUNK_C; i += THREADS) acc[i] = 0.f;
  if (tid == 0) {
    sm90::mbar_init(&bar, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int r0 = 0; r0 < N; r0 += HIT_SCAN) {
    // the RoIs of this level and image whose touched box meets the tile,
    // in order: thread t tests RoIs r0 + [t KR, t KR + KR), all at once
    int4 in[KR];
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int n = r0 + tid * KR + k;
      in[k] = n < N ? __ldg(info + n) : make_int4(-1, 0, 0, 0);
    }
    unsigned hit = 0;
#pragma unroll
    for (int k = 0; k < KR; ++k)
      hit |= (unsigned)(in[k].x == where &&
                        bin_meets(make_int2(in[k].y, in[k].z), y0, x0))
             << k;
    int n_hits;
    int hp = ordered_offset(__popc(hit), warp_n, &n_hits);
#pragma unroll
    for (int k = 0; k < KR; ++k)
      if ((hit >> k) & 1u) hits[hp++] = r0 + tid * KR + k;
    __syncthreads();
    for (int h0 = 0; h0 < n_hits; h0 += hb) {
      const int units = min(hb, n_hits - h0) * n_bins;
      // a thread a (RoI, bin) of the batch: if the bin meets the tile,
      // its g row goes into shared memory (cp.async) while the entries
      // are sorted
      const int u = tid, j = u / n_bins;
      const int n_u = u < units ? hits[h0 + j] : 0, bin = u - j * n_bins;
      // the bin's entries and box, read together
      int2 en[CAP];
#pragma unroll
      for (int c = 0; c < CAP; ++c)
        en[c] = u < units
                    ? __ldg(entries + ((size_t)n_u * CAP + c) * n_bins + bin)
                    : make_int2(NO_PIXEL, 0);
      const bool m = u < units &&
                     bin_meets(__ldg(bin_box + (size_t)n_u * n_bins + bin),
                               y0, x0);
      const TG* src = g + ((size_t)n_u * n_bins + bin) * C + c0;
      TG* dst = gst + (size_t)u * CHUNK_C;
      if (bulk) {                        // every thread arrives once
        if (m) {
          sm90::mbar_expect_tx(&bar, (uint32_t)row_bytes);
          sm90::bulk_load(dst, src, (uint32_t)row_bytes, &bar);
        } else {
          sm90::mbar_arrive(&bar);
        }
      } else {
        for (int k = 0; m && k < row_bytes / unit; ++k)
          copy_async(reinterpret_cast<char*>(dst) + k * unit,
                     reinterpret_cast<const char*>(src) + k * unit, unit);
        asm volatile("cp.async.commit_group;\n" ::);
      }
      // the bin's entries inside the tile (distinct pixels)
      unsigned long long pix = 0;
#pragma unroll
      for (int c = 0; c < CAP; ++c) {
        if (!m) en[c].x = NO_PIXEL;
        const int dy = (en[c].x >> 16) - y0, dx = (en[c].x & 0xffff) - x0;
        if (en[c].x != NO_PIXEL && dy >= 0 && dy < TILE && dx >= 0 &&
            dx < TILE) {
          en[c].x = dy * TILE + dx;
          pix |= 1ull << en[c].x;
        } else {
          en[c].x = NO_PIXEL;
        }
      }
      // which lanes of the warp have an entry at each pixel: the lanes'
      // pixel masks transposed, 32 pixels at a time
      wmask[warp][lane] = transpose32((unsigned)pix);
      wmask[warp][lane + 32] = transpose32((unsigned)(pix >> 32));
      __syncthreads();
      // warp 0: the earlier warps' counts and the buckets' starts
      if (warp == 0) {
        int tot[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 2 * lane + h;
          int cnt[THREADS / 32];
#pragma unroll
          for (int w = 0; w < THREADS / 32; ++w) cnt[w] = __popc(wmask[w][p]);
          int run = 0;
#pragma unroll
          for (int w = 0; w < THREADS / 32; ++w) {
            wpre[w][p] = run;
            run += cnt[w];
          }
          tot[h] = run;
        }
        const int sum = tot[0] + tot[1];
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        start[2 * lane] = incl - sum;
        start[2 * lane + 1] = incl - sum + tot[0];
        if (lane == 31) start[TILE_PX] = incl;
      }
      __syncthreads();
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int c = 0; c < CAP; ++c) {
        const int p = en[c].x;
        if (p == NO_PIXEL) continue;
        list[start[p] + wpre[warp][p] + __popc(wmask[warp][p] & below)] =
            make_int2(u, en[c].y);
      }
      if (tid == 0) next_px = 0;
      if (bulk) {
        sm90::mbar_wait(&bar, phase);
        phase ^= 1u;
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      // the pixels, handed out to the warps as they come free: a warp
      // walks a pixel's bucket in (RoI, bin) order, a lane adding into
      // its 4 channels of the pixel's sums
      for (;;) {
        int px = 0;
        if (lane == 0) px = atomicAdd(&next_px, 1);
        px = __shfl_sync(0xffffffffu, px, 0);
        if (px >= TILE_PX) break;
        const int i1 = start[px + 1];
        if (start[px] == i1) continue;
        float* a = acc + px * CHUNK_C + cs;
        float s[LANE_C];
#pragma unroll
        for (int c = 0; c < LANE_C; ++c) s[c] = a[c];
        int i = start[px];
        if (full) {
          // UNROLL entries' reads in flight at once, added in order
          for (; i + UNROLL <= i1; i += UNROLL) {
            float w[UNROLL], v[UNROLL][LANE_C];
#pragma unroll
            for (int q = 0; q < UNROLL; ++q) {
              const int2 it = list[i + q];
              w[q] = __int_as_float(it.y);
              vec_io::unpack<LANE_C>(gst + (size_t)it.x * CHUNK_C + cs, v[q]);
            }
#pragma unroll
            for (int q = 0; q < UNROLL; ++q)
#pragma unroll
              for (int c = 0; c < LANE_C; ++c)
                s[c] = fmaf(w[q], v[q][c], s[c]);
          }
        }
        for (; i < i1; ++i) {
          const int2 it = list[i];
          const TG* row = gst + (size_t)it.x * CHUNK_C + cs;
          const float w = __int_as_float(it.y);
          if (full) {
            float v[LANE_C];
            vec_io::unpack<LANE_C>(row, v);
#pragma unroll
            for (int c = 0; c < LANE_C; ++c) s[c] = fmaf(w, v[c], s[c]);
          } else {
#pragma unroll
            for (int c = 0; c < LANE_C; c += 2) {
              if (cs + c >= cc) break;
              const float2 gv = load2(row + c);
              s[c] = fmaf(w, gv.x, s[c]);
              s[c + 1] = fmaf(w, gv.y, s[c + 1]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < LANE_C; ++c) a[c] = s[c];
      }
      __syncthreads();
    }
  }

  for (int px = warp; px < TILE_PX; px += WARPS) {
    const int y = y0 + px / TILE, x = x0 + px % TILE;
    if (y >= H || x >= W || cs >= cc) continue;
    TO* out = static_cast<TO*>(grads.feat[l]) +
              (((size_t)b * H + y) * W + x) * C + c0 + cs;
    float s[LANE_C];
#pragma unroll
    for (int c = 0; c < LANE_C; ++c) s[c] = acc[px * CHUNK_C + cs + c];
    if (full && vec_out) {
      vec_io::pack_store<LANE_C>(out, s);
    } else {
#pragma unroll
      for (int c = 0; c < LANE_C; c += 2) {
        if (cs + c >= cc) break;
        store2(out + c, s[c], s[c + 1]);
      }
    }
  }
}

// hit RoIs a batch: their bins fill at most the block's threads, their g
// rows and entries SMEM_BUDGET; at most MAX_HB
template <typename TG>
int batch_rois(int n_bins) {
  // SMEM_BUDGET after the tile's fp32 sums
  const int per_roi = n_bins * (CHUNK_C * (int)sizeof(TG) + CAP * 8);
  const int room = SMEM_BUDGET - TILE_PX * CHUNK_C * 4;
  int hb = THREADS / n_bins;
  hb = hb < room / per_roi ? hb : room / per_roi;
  return hb < 1 ? 1 : (hb > MAX_HB ? MAX_HB : hb);
}

template <typename TG>
size_t tile_smem(int n_bins) {
  const size_t rows = (size_t)batch_rois<TG>(n_bins) * n_bins;
  return (size_t)TILE_PX * CHUNK_C * 4 + rows * CHUNK_C * sizeof(TG) +
         rows * CAP * 8;
}

template <typename TG, typename TO>
int launch_tiles(const Pyramid& grads, const Tiling& tiling,
                 const int2* entries, const int2* bin_box, const int4* info,
                 const void* g, int N, int C, int n_bins,
                 cudaStream_t stream) {
  constexpr auto kern = tile_kernel<TG, TO>;
  if (reinterpret_cast<uintptr_t>(g) % (2 * sizeof(TG)) != 0)
    return (int)cudaErrorInvalidValue;    // read by channel pairs at least
  const size_t smem = tile_smem<TG>(n_bins);
  const int err = devcache::set_smem<kern>(smem);
  if (err != 0) return err;
  // 16-byte copies of g where rows and chunks allow, else channel pairs
  const bool wide = (C * sizeof(TG)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int unit = wide ? 16 : 2 * (int)sizeof(TG);
  // vector stores of the gradient where its rows and levels allow
  bool vec_out = (C * sizeof(TO)) % 16 == 0;
  for (int l = 0; l < MAX_LEVELS; ++l)
    vec_out = vec_out && reinterpret_cast<uintptr_t>(grads.feat[l]) % 16 == 0;
  dim3 grid(tiling.first[MAX_LEVELS], (C + CHUNK_C - 1) / CHUNK_C);
  kern<<<grid, THREADS, smem, stream>>>(grads, tiling, entries, bin_box,
                                        info, static_cast<const TG*>(g), N,
                                        C, n_bins, batch_rois<TG>(n_bins),
                                        unit,
                                        (int)vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// grads: n_levels pointers (B, h[l], w[l], C) in the feature type (every
// element written), h = w = 0 for a missing level; g: (N, out_size,
// out_size, C); scratch: entries (N, 16, out^2) int2, bin_box (N, out^2)
// int2, info (N) int4; C even, g aligned to a channel pair; levels <
// 32767 pixels a side.
extern "C" int sm3det_roi_align_rotated_bwd(
    void* g0, void* g1, void* g2, void* g3, int h0, int h1, int h2, int h3,
    int w0, int w1, int w2, int w3, float s0, float s1, float s2, float s3,
    const float* rois, const int* lvls, const void* g, void* entries,
    void* bin_box, void* info, int B, int C, int N, int out_size,
    int sample_num, int g_bf16, int out_bf16, cudaStream_t stream) {
  const int n_bins = out_size * out_size;
  if (sample_num < 1 || sample_num > MAX_SN || out_size < 1 ||
      n_bins > MAX_BINS || (C & 1) || C <= 0 || B < 1 || B >= 65536)
    return (int)cudaErrorInvalidValue;
  Pyramid grads = {{g0, g1, g2, g3},
                   {h0, h1, h2, h3},
                   {w0, w1, w2, w3},
                   {s0, s1, s2, s3}};
  Tiling tiling;
  tiling.first[0] = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (grads.h[l] >= MAX_SIDE || grads.w[l] >= MAX_SIDE)
      return (int)cudaErrorInvalidValue;
    tiling.tx[l] = (grads.w[l] + TILE - 1) / TILE;
    tiling.ty[l] = (grads.h[l] + TILE - 1) / TILE;
    tiling.first[l + 1] = tiling.first[l] + B * tiling.tx[l] * tiling.ty[l];
  }
  int2* ent = static_cast<int2*>(entries);
  int2* bbox = static_cast<int2*>(bin_box);
  int4* rinfo = static_cast<int4*>(info);
  if (N > 0)
    stencil_kernel<<<N, 64, 0, stream>>>(grads, rois, lvls, ent, bbox, rinfo,
                                         B, out_size, sample_num);
  int err = (int)cudaGetLastError();
  if (err != 0 || tiling.first[MAX_LEVELS] == 0) return err;
#define SM3DET_TILES(TG, TO) \
  return launch_tiles<TG, TO>(grads, tiling, ent, bbox, rinfo, g, N, C, \
                              n_bins, stream)
  if (g_bf16 && out_bf16) SM3DET_TILES(__nv_bfloat16, __nv_bfloat16);
  if (g_bf16) SM3DET_TILES(__nv_bfloat16, float);
  if (out_bf16) SM3DET_TILES(float, __nv_bfloat16);
  SM3DET_TILES(float, float);
#undef SM3DET_TILES
}
