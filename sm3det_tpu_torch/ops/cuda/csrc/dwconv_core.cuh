// The 7x7 depthwise conv core shared by the dw7x7 + LN forward
// (dwconv_ln.cu) and its backward (dwconv_ln_bwd.cu).
//
// Layout: NHWC, fp32 or bf16. A block works on a tile of TH x TW output
// pixels of one image, one chunk of CK channels at a time. The chunk's
// input rows with the 3-pixel halo, (TH + 6) x (TW + 6) pixels x CK
// channels, are copied into shared memory with cp.async (16, 8 or 4 bytes
// a copy, whichever the row of C channels allows; the src-size operand 0
// writes the zero padding). A staged row holds TW + 7 pixels: the odd
// stride puts the two tile rows one warp reads into opposite halves of the
// banks. One tiling is used, Tiling<4, 16, 32, 8>; the struct keeps the
// constants that follow from it together.
//
// Thread t of a conv step owns channel pair t % 16 of the chunk and a
// strip of 8 output pixels along W (t / 16: row (t / 16) % TH, columns
// 8 ((t / 16) / TH) ...). For each of the 7 tap rows it reads 14 staged
// input pairs and 7 tap pairs, and does 7 x 8 x 2 = 112 FMAs: 5.3 FMAs a
// shared-memory load, with a lane's loads 4 (bf16 pair) or 8 (fp32 pair)
// bytes wide and neighbouring lanes on neighbouring words.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_cache.cuh"

namespace dwcore {

namespace cg = cooperative_groups;

// A block's pixel tile (TH x TW), channel chunk (CK) and strip (SW pixels
// a thread), and what follows from them.
template <int TH_, int TW_, int CK_, int SW_>
struct Tiling {
  static constexpr int TH = TH_;                // tile rows
  static constexpr int TW = TW_;                // tile columns
  static constexpr int CK = CK_;                // channels a chunk
  static constexpr int SW = SW_;                // output pixels a strip
  static constexpr int NP = CK / 2;             // channel pairs a chunk
  static constexpr int NS = TH * TW / SW;       // strips a tile
  static constexpr int THREADS = NP * NS;
  static constexpr int HR = TH + 6;             // staged rows
  static constexpr int HC = TW + 6;             // staged columns
  static constexpr int RS = TW + 7;             // staged row stride (odd)
  static constexpr int TILE_ELEMS = HR * RS * CK;
  static constexpr int TAP_ELEMS = 49 * CK;
  static_assert(NP == 16 || NP == 32, "a strip's lanes: a half or a warp");
  static_assert(TW % SW == 0, "whole strips");
};

struct Geo {
  int B, H, W, C;
  int tiles_x, tiles_y, n_tiles, n_chunks;
};

template <class K>
inline Geo make_geo(int B, int H, int W, int C) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C;
  g.tiles_x = (W + K::TW - 1) / K::TW;
  g.tiles_y = (H + K::TH - 1) / K::TH;
  g.n_tiles = B * g.tiles_x * g.tiles_y;
  g.n_chunks = (C + K::CK - 1) / K::CK;
  return g;
}

// How the forward and the backward's stats kernel spread the C / CK chunks
// of a pixel tile over the g blocks of a cluster, ncb chunks a block: at
// most 8 blocks (the portable cluster size), as many as that allows, so
// that each thread keeps all its accumulators of a tile (ncb x 16 floats)
// in registers and the LN needs one sweep (C = 96: 3 blocks of 1 chunk;
// 384: 6 of 2; 768: 8 of 3; 1536: 8 of 6; 2048: 8 of 8). The registers
// bound ncb: 8 chunks are 128 accumulators of the 255 a thread may hold,
// so C <= 8 x 8 x 32 = 2048 (ConvNeXt-XL's widest stage). Above 4 chunks
// ncb is rounded up to 6 or 8, the two instantiations the kernels carry
// for ConvNeXt-L and -XL.
constexpr int MAX_CHANNELS = 2048;

struct Split {
  int ncb, g;
};

inline Split split_channels(int C, int CK) {
  const int nch = (C + CK - 1) / CK;
  Split sp;
  sp.ncb = (nch + 7) / 8;
  if (sp.ncb == 5 || sp.ncb == 7) ++sp.ncb;
  sp.g = (nch + sp.ncb - 1) / sp.ncb;
  return sp;
}

// A launch of `blocks` blocks in clusters of `cluster` (`attr` holds the
// cluster attribute the configuration points to).
inline cudaLaunchConfig_t cluster_config(int blocks, int threads, size_t smem,
                                         int cluster, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kern` on `blocks` blocks in clusters of `cluster` blocks; the
// caller has set its dynamic shared memory limit (set_smem).
template <typename... Params, typename... Args>
inline int launch_clusters(void (*kern)(Params...), int blocks, int threads,
                           size_t smem, int cluster, cudaStream_t stream,
                           Args... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(blocks, threads, smem, cluster, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Allow kernel KERN `smem` bytes of dynamic shared memory on the current
// device (once a device: a host call saved on every launch).
template <auto KERN>
inline int set_smem(size_t smem) {
  return devcache::set_smem<KERN>(smem);
}

// Clusters of `cluster` blocks of KERN that the current device holds at
// once (at least 1): the grid of a persistent cluster kernel. Set the
// kernel's shared memory limit (set_smem) first.
template <auto KERN>
inline int resident_clusters(int cluster, int threads, size_t smem) {
  int n = 0;
  const int err = devcache::once<KERN>(
      cluster, &n, [cluster, threads, smem](int, int* v) {
        cudaLaunchAttribute attr;
        const cudaLaunchConfig_t cfg =
            cluster_config(cluster, threads, smem, cluster, nullptr, &attr);
        if (cudaOccupancyMaxActiveClusters(v, KERN, &cfg) != cudaSuccess ||
            *v < 1)
          *v = 1;
        return cudaSuccess;
      });
  return err == 0 ? n : 1;
}

// widest copy (bytes) that every row of C elements of `esize` bytes
// allows: 16, 8, 4, or 2 (bf16 with odd C: plain loads)
inline int copy_width(int C, int esize) {
  const int row = C * esize;
  return row % 16 == 0 ? 16 : row % 8 == 0 ? 8 : row % 4 == 0 ? 4 : 2;
}

template <class K>
__device__ __forceinline__ void tile_origin(const Geo& g, int tile, int* b,
                                            int* y0, int* x0) {
  const int per_img = g.tiles_x * g.tiles_y;
  *b = tile / per_img;
  const int r = tile % per_img;
  *y0 = (r / g.tiles_x) * K::TH;
  *x0 = (r % g.tiles_x) * K::TW;
}

// The strip of thread `tid`: channel pair, tile row and first column.
template <class K>
struct Strip {
  int pair, row, col0;
  __device__ __forceinline__ explicit Strip(int tid)
      : pair(tid % K::NP),
        row((tid / K::NP) % K::TH),
        col0((tid / K::NP) / K::TH * K::SW) {}
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <class K, int N, typename T>
__device__ __forceinline__ void stage_rows_n(T* dst, const T* img, int H,
                                             int W, int C, int y0, int x0,
                                             int c0) {
  constexpr int EPU = N / (int)sizeof(T);         // elements a copy
  constexpr int UPP = K::CK / EPU;                // copies a pixel
  for (int i = threadIdx.x; i < K::HR * K::HC * UPP; i += blockDim.x) {
    const int u = i % UPP;
    const int pix = i / UPP;
    const int r = pix / K::HC, q = pix % K::HC;
    const int gy = y0 - 3 + r, gx = x0 - 3 + q, ch = c0 + u * EPU;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < C;
    const T* src = ok ? img + ((size_t)gy * W + gx) * C + ch : img;
    T* d = dst + (r * K::RS + q) * K::CK + u * EPU;
    if constexpr (N >= 4)
      cp_async<N>(d, src, ok);
    else
      *d = ok ? *src : T(0.f);
  }
}

// Issue the copies of one chunk's halo tile (image `img`, tile origin y0,
// x0, channels c0 .. c0 + CK) into `dst`; padding and channels >= C land
// as zeros.
template <class K, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* img, int H,
                                           int W, int C, int y0, int x0,
                                           int c0, int width) {
  if (width == 16)
    stage_rows_n<K, 16>(dst, img, H, W, C, y0, x0, c0);
  else if (width == 8)
    stage_rows_n<K, 8>(dst, img, H, W, C, y0, x0, c0);
  else if (width == 4)
    stage_rows_n<K, 4>(dst, img, H, W, C, y0, x0, c0);
  else if constexpr (sizeof(T) == 2)
    stage_rows_n<K, 2>(dst, img, H, W, C, y0, x0, c0);
}

// Issue the copies of one chunk of the tile's own pixels (no halo) into
// `dst` [TH][TW + 1][CK] (the odd row stride, in pixels, keeps the two
// rows a warp reads on different banks); pixels outside and channels >= C
// land as zeros.
template <class K, int N, typename T>
__device__ __forceinline__ void stage_pixels_n(T* dst, const T* img, int H,
                                               int W, int C, int y0, int x0,
                                               int c0) {
  constexpr int EPU = N / (int)sizeof(T);
  constexpr int UPP = K::CK / EPU;
  for (int i = threadIdx.x; i < K::TH * K::TW * UPP; i += blockDim.x) {
    const int u = i % UPP;
    const int pix = i / UPP;
    const int r = pix / K::TW, q = pix % K::TW;
    const int gy = y0 + r, gx = x0 + q, ch = c0 + u * EPU;
    const bool ok = gy < H && gx < W && ch < C;
    const T* src = ok ? img + ((size_t)gy * W + gx) * C + ch : img;
    T* d = dst + (r * (K::TW + 1) + q) * K::CK + u * EPU;
    if constexpr (N >= 4)
      cp_async<N>(d, src, ok);
    else
      *d = ok ? *src : T(0.f);
  }
}

template <class K, typename T>
__device__ __forceinline__ void stage_pixels(T* dst, const T* img, int H,
                                             int W, int C, int y0, int x0,
                                             int c0, int width) {
  if (width == 16)
    stage_pixels_n<K, 16>(dst, img, H, W, C, y0, x0, c0);
  else if (width == 8)
    stage_pixels_n<K, 8>(dst, img, H, W, C, y0, x0, c0);
  else if (width == 4)
    stage_pixels_n<K, 4>(dst, img, H, W, C, y0, x0, c0);
  else if constexpr (sizeof(T) == 2)
    stage_pixels_n<K, 2>(dst, img, H, W, C, y0, x0, c0);
}

// Copies of the chunk's taps from the fp32 (49, C) tap matrix into
// `dst` [49][CK]; channels >= C land as zeros.
template <class K>
__device__ __forceinline__ void stage_taps(float* dst, const float* taps,
                                           int C, int c0) {
  constexpr int CK = K::CK;
  if (C % 4 == 0) {
    for (int i = threadIdx.x; i < 49 * (CK / 4); i += blockDim.x) {
      const int t = i / (CK / 4), ch = c0 + (i % (CK / 4)) * 4;
      const bool ok = ch < C;
      cp_async<16>(dst + t * CK + (ch - c0), ok ? taps + t * C + ch : taps,
                   ok);
    }
  } else {
    for (int i = threadIdx.x; i < 49 * CK; i += blockDim.x) {
      const int t = i / CK, ch = c0 + i % CK;
      const bool ok = ch < C;
      cp_async<4>(dst + i, ok ? taps + t * C + ch : taps, ok);
    }
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Channels c and c + 1 of a per-channel fp32 vector, 0 past C (C may be
// odd, and then the pair is not 8-byte aligned).
__device__ __forceinline__ float2 load2_global(const float* p, int c,
                                               int C) {
  if (c + 1 < C && (C % 2 == 0)) return load2(p);
  float2 v;
  v.x = c < C ? p[0] : 0.f;
  v.y = c + 1 < C ? p[1] : 0.f;
  return v;
}

__device__ __forceinline__ void store2(float* p, float2 v, int c, int C) {
  if (c + 1 < C && (C % 2 == 0)) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    if (c < C) p[0] = v.x;
    if (c + 1 < C) p[1] = v.y;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v, int c,
                                       int C) {
  if (c + 1 < C && (C % 2 == 0)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
  } else {
    if (c < C) p[0] = __float2bfloat16_rn(v.x);
    if (c + 1 < C) p[1] = __float2bfloat16_rn(v.y);
  }
}

// acc[o] += sum_{i,j} tile[row + i][col0 + o + j] * tap(i, j) for the
// thread's channel pair, o = 0 .. SW - 1, in staged (halo) coordinates.
// With FLIP the taps are read rotated by 180 degrees (tap 48 - (7 i + j)):
// the correlation that is the conv's input gradient.
template <class K, bool FLIP, typename T>
__device__ __forceinline__ void conv_strip(const T* tile, const float* taps,
                                           const Strip<K>& st,
                                           float2 (&acc)[K::SW]) {
  constexpr int CK = K::CK, SW = K::SW;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float2 w[7];
#pragma unroll
    for (int j = 0; j < 7; ++j)
      w[j] = load2(taps + (FLIP ? 48 - (7 * i + j) : 7 * i + j) * CK +
                   2 * st.pair);
    const T* src = tile + ((st.row + i) * K::RS + st.col0) * CK + 2 * st.pair;
#pragma unroll
    for (int q = 0; q < SW + 6; ++q) {
      const float2 v = load2(src + q * CK);
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int o = q - j;
        if (o >= 0 && o < SW) {
          acc[o].x = fmaf(v.x, w[j].x, acc[o].x);
          acc[o].y = fmaf(v.y, w[j].y, acc[o].y);
        }
      }
    }
  }
}

// sum of `n` values of each rank's `buf` at `at` (distributed shared
// memory), in rank order; the loads of all ranks are issued together
template <int N>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            float* buf, int stride, int at,
                                            int G, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = 0.f;
  float got[8][N];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r < G) {
      const float* rs = cluster.map_shared_rank(buf, r);
#pragma unroll
      for (int q = 0; q < N; ++q) got[r][q] = rs[q * stride + at];
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r < G) {
#pragma unroll
      for (int q = 0; q < N; ++q) v[q] += got[r][q];
    }
  }
}

// sum over the NP lanes that share a strip
template <class K>
__device__ __forceinline__ float strip_sum(float v) {
#pragma unroll
  for (int o = K::NP / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace dwcore
