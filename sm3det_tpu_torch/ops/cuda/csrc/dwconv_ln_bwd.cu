// Backward of the trainable 7x7 depthwise conv + LayerNorm, NHWC.
//
// Replaces: sm3det_tpu/ops/pallas/convnext_block_kernel.py,
//   fused_dwconv_ln_train's VJP (_fdl_fwd / _fdl_bwd, :344-371), which
//   recomputes the dw7x7 from the saved inputs and differentiates the fp32
//   formulation _dwconv_ln_math. The algebra, in fp32, per pixel p and
//   channel c (the plain version is dwconv_ln_bwd_ref in
//   convnext_block_kernel.py):
//     a = dw7x7(x) + dwb, d = a - mean_c a, v_raw = mean_c a^2 - mean^2,
//     r = (max(v_raw, 0) + eps)^-1/2, gh = g * lns,
//     dlnb = sum_p g, dlns = sum_p g * d * r,
//     da = r (gh - mean_c gh) - m r^3 mean_c(gh d) d, with m the clamp's
//       gradient as jnp.maximum gives it: 1 above 0, 1/2 at 0, 0 below,
//     ddwb = sum_p da, ddwk[c,i,j] = sum_p da[p,c] x[p + (i-3, j-3), c],
//     dx[q,c] = sum_ij da[q - (i-3, j-3), c] dwk[c,i,j].
//   Only the inputs are saved, as in JAX.
//
// Bound on the H100, over the 18 launches of the flagship train step
// (8 images of 800^2, bf16): bytes ~0.52 ms (x and g read, dx written once,
// as chip_smoke.py reckons them with the forward's), operations ~1.07 ms
// (the forward's 106 fp32 flops a value and the backward's two 7x7 passes
// and the LN's, ~220, at the 67 TFLOP/s of the CUDA cores).
//
// Design: three launches. The LN couples the channels of a pixel and the
// conv's gradients couple the pixels of a channel, so one pass would have
// to recompute the LN over a 3-pixel halo; instead
//   A (stats): the forward's clusters (dwconv_core.cuh): up to 8 blocks
//     share a pixel tile's C channels, each thread's accumulators in
//     registers. It recomputes a once and sums, per pixel, a, a^2, gh and
//     gh a over the cluster (distributed shared memory, rank order), then
//     writes da in fp32 to a scratch tensor and sums g and g x^ per channel
//     over its tiles. mean_c(gh d) is taken as mean(gh a) - mean(a)
//     mean(gh), in fp32 like the fast variance.
//   B (conv): channel-separable, so a block keeps one chunk of 32 channels
//     and walks a fixed list of pixel tiles, copying each tile's da and x
//     with their halos by cp.async into one buffer (50 KB in bf16: 4 blocks
//     an SM overlap one another's copies; two buffers held 2 blocks an SM
//     and measured 14% slower on the H100). dx is the
//     conv core on da with the taps turned by 180 degrees; ddwk is summed
//     by 112 threads, one a channel pair and tap row (7 x 2 accumulators in
//     registers for the whole walk), ddwb by the other 16.
//   C (reduce): A and B write per-block partials ([clusters][2][C] and
//     [groups][50][C], fp32), each block's sums taken in a fixed order;
//     C sums them over the blocks in a fixed order and rounds once to the
//     parameters' dtypes. No atomics: the same inputs give the same bits
//     on every run (the grid is fixed by the card's SM count and shape).
// da is the one large intermediate: 4 bytes a value written by A and read
// (with its halo, from L2) by B.

#include <algorithm>

#include "dwconv_core.cuh"

namespace {

using namespace dwcore;

template <class K, int NCB, typename Tin, typename Tg>
__global__ void __launch_bounds__(K::THREADS)
dwconv_ln_bwd_stats_kernel(const Tin* __restrict__ x,
                           const float* __restrict__ taps,
                           const float* __restrict__ dwb,
                           const float* __restrict__ lns,
                           const Tg* __restrict__ g, float* __restrict__ da,
                           float* __restrict__ part, Geo geo, int width,
                           int gwidth, float eps) {
  constexpr int CK = K::CK, SW = K::SW, NS = K::NS, TE = K::TILE_ELEMS;
  constexpr int TP = K::TH * K::TW, GP = K::TH * (K::TW + 1) * CK;
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* tiles = reinterpret_cast<Tin*>(smem);
  float* tapbuf = reinterpret_cast<float*>(smem + 2 * TE * sizeof(Tin));
  // [tile parity][4][TP]: this block's sums of a, a^2, gh, gh a
  float* sums = tapbuf + 2 * K::TAP_ELEMS;
  float* stats = sums + 8 * TP;              // [4][TP]: mean, r, mean gh, K
  float* red = stats + 4 * TP;               // [2][NS][CK]
  Tg* gbuf = reinterpret_cast<Tg*>(red + 2 * NS * CK);  // [2][NCB][GP]

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / G, ncl = gridDim.x / G;
  const int tid = threadIdx.x;
  const Strip<K> st(tid);
  const int H = geo.H, W = geo.W, C = geo.C;
  const int c_first = rank * NCB * CK;
  const int my_tiles = (geo.n_tiles - cid + ncl - 1) / ncl;
  const int steps = my_tiles * NCB;

  auto issue = [&](int s) {
    const int c0 = c_first + (s % NCB) * CK;
    if (c0 >= C) return;
    int b, y0, x0;
    tile_origin<K>(geo, cid + (s / NCB) * ncl, &b, &y0, &x0);
    stage_rows<K>(tiles + (s & 1) * TE, x + (size_t)b * H * W * C, H, W, C,
                  y0, x0, c0, width);
    stage_taps<K>(tapbuf + (s & 1) * K::TAP_ELEMS, taps, C, c0);
    stage_pixels<K>(gbuf + (((s / NCB) & 1) * NCB + s % NCB) * GP,
                    g + (size_t)b * H * W * C, H, W, C, y0, x0, c0, gwidth);
  };
  // the thread's g of chunk k and strip pixel o, from the staged tile
  auto g_at = [&](int it, int k, int o) {
    return load2(gbuf + (((it & 1) * NCB + k) * GP +
                         (st.row * (K::TW + 1) + st.col0 + o) * CK +
                         2 * st.pair));
  };

  // per channel of the thread's pairs, over all its tiles: sum of g x^ and
  // of g
  float2 pl[NCB], pb[NCB];
  float2 sc[NCB];
#pragma unroll
  for (int k = 0; k < NCB; ++k) {
    pl[k] = pb[k] = make_float2(0.f, 0.f);
    const int c = c_first + k * CK + 2 * st.pair;
    sc[k] = load2_global(lns + c, c, C);
  }

  if (steps > 0) issue(0);
  cp_commit();
  for (int it = 0; it < my_tiles; ++it) {
    int b, y0, x0;
    tile_origin<K>(geo, cid + it * ncl, &b, &y0, &x0);
    const int py = y0 + st.row, px0 = x0 + st.col0;
    const size_t pix0 = ((size_t)b * H + py) * W + px0;
    float2 acc[NCB][SW];
#pragma unroll
    for (int k = 0; k < NCB; ++k) {
      const int s = it * NCB + k;
      if (s + 1 < steps) issue(s + 1);
      cp_commit();
      cp_wait_one();
      __syncthreads();
      const int c = c_first + k * CK + 2 * st.pair;
      const float2 bias = load2_global(dwb + c, c, C);
#pragma unroll
      for (int o = 0; o < SW; ++o) acc[k][o] = bias;
      if (c_first + k * CK < C)
        conv_strip<K, false>(tiles + (s & 1) * TE,
                             tapbuf + (s & 1) * K::TAP_ELEMS, st, acc[k]);
      __syncthreads();
    }
    // this block's share of each pixel's sums of a, a^2, gh and gh a (g is
    // 0 at pixels outside and channels past C)
    float* my_sums = sums + (it & 1) * 4 * TP;
#pragma unroll
    for (int o = 0; o < SW; ++o) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < NCB; ++k) {
        const float2 gv = c_first + k * CK < C ? g_at(it, k, o)
                                               : make_float2(0.f, 0.f);
        const float2 a = acc[k][o];
        const float ghx = gv.x * sc[k].x, ghy = gv.y * sc[k].y;
        v[0] += a.x + a.y;
        v[1] = fmaf(a.x, a.x, fmaf(a.y, a.y, v[1]));
        v[2] += ghx + ghy;
        v[3] = fmaf(ghx, a.x, fmaf(ghy, a.y, v[3]));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = strip_sum<K>(v[q]);
      if (st.pair == 0) {
        const int pix = st.row * K::TW + st.col0 + o;
#pragma unroll
        for (int q = 0; q < 4; ++q) my_sums[q * TP + pix] = v[q];
      }
    }
    // one cluster barrier a tile (the sums alternate between two buffers)
    cluster.sync();
    if (tid < TP) {
      float v[4];
      cluster_sum(cluster, my_sums, TP, tid, G, v);
      const float inv_c = 1.f / (float)C;
      const float mean = v[0] * inv_c;
      const float v_raw = v[1] * inv_c - mean * mean;
      const float m = v_raw > 0.f ? 1.f : (v_raw == 0.f ? 0.5f : 0.f);
      const float r = rsqrtf(fmaxf(v_raw, 0.f) + eps);
      const float mg = v[2] * inv_c;
      stats[tid] = mean;
      stats[TP + tid] = r;
      stats[2 * TP + tid] = mg;
      stats[3 * TP + tid] = m * r * r * r * (v[3] * inv_c - mean * mg);
    }
    __syncthreads();
    // da, and the thread's channels' sums of g x^ and g
#pragma unroll
    for (int o = 0; o < SW; ++o) {
      if (py >= H || px0 + o >= W) continue;
      const int pix = st.row * K::TW + st.col0 + o;
      const float mean = stats[pix], r = stats[TP + pix];
      const float mg = stats[2 * TP + pix], kk = stats[3 * TP + pix];
#pragma unroll
      for (int k = 0; k < NCB; ++k) {
        const int c = c_first + k * CK + 2 * st.pair;
        if (c >= C) continue;
        const float2 gv = g_at(it, k, o);
        const float dxv = acc[k][o].x - mean, dyv = acc[k][o].y - mean;
        float2 d;
        d.x = r * (gv.x * sc[k].x - mg) - kk * dxv;
        d.y = r * (gv.y * sc[k].y - mg) - kk * dyv;
        store2(da + (pix0 + o) * C + c, d, c, C);
        pl[k].x = fmaf(gv.x, dxv * r, pl[k].x);
        pl[k].y = fmaf(gv.y, dyv * r, pl[k].y);
        pb[k].x += gv.x;
        pb[k].y += gv.y;
      }
    }
  }
  // the block's per-channel sums: over the strips in order, into part
  const int strip = tid / K::NP;
#pragma unroll
  for (int k = 0; k < NCB; ++k) {
    red[strip * CK + 2 * st.pair] = pl[k].x;
    red[strip * CK + 2 * st.pair + 1] = pl[k].y;
    red[(NS + strip) * CK + 2 * st.pair] = pb[k].x;
    red[(NS + strip) * CK + 2 * st.pair + 1] = pb[k].y;
    __syncthreads();
    if (tid < 2 * CK) {
      const int kind = tid / CK, c = c_first + k * CK + tid % CK;
      float v = 0.f;
#pragma unroll
      for (int si = 0; si < NS; ++si)
        v += red[(kind * NS + si) * CK + tid % CK];
      if (c < C) part[((size_t)cid * 2 + kind) * C + c] = v;
    }
    __syncthreads();
  }
  cluster.sync();      // no block leaves while another reads its sums
}

// the conv kernel's tiling: 8 strips, so 7 x 16 threads sum ddwk and 16
// sum ddwb
using KB = Tiling<4, 16, 32, 8>;

template <typename Tin>
__global__ void __launch_bounds__(KB::THREADS, 4)
dwconv_ln_bwd_conv_kernel(const Tin* __restrict__ x,
                          const float* __restrict__ da,
                          const float* __restrict__ taps,
                          Tin* __restrict__ dx, float* __restrict__ part,
                          Geo geo, int width_x, int width_da) {
  constexpr int CK = KB::CK, SW = KB::SW, NP = KB::NP, TE = KB::TILE_ELEMS;
  constexpr int RS = KB::RS, TH = KB::TH, TW = KB::TW;
  static_assert(KB::NS == 8, "7 tap rows of wgrad threads and one of ddwb");
  extern __shared__ __align__(16) unsigned char smem[];
  float* dabuf = reinterpret_cast<float*>(smem);              // [tile]
  Tin* xbuf = reinterpret_cast<Tin*>(dabuf + TE);              // [tile]
  float* tapbuf = reinterpret_cast<float*>(xbuf + TE);         // [49][CK]

  const int tid = threadIdx.x;
  const Strip<KB> st(tid);
  const int pair = st.pair;
  const int H = geo.H, W = geo.W, C = geo.C, nch = geo.n_chunks;
  const int chunk = blockIdx.x % nch, group = blockIdx.x / nch;
  const int n_groups = gridDim.x / nch;
  const int c0 = chunk * CK, c = c0 + 2 * pair;
  const int steps = (geo.n_tiles - group + n_groups - 1) / n_groups;
  // wgrad: threads 0 .. 111 own (channel pair, tap row); 112 .. 127 ddwb
  const bool wthread = tid < 7 * NP;
  const int wi = tid / NP;

  auto issue = [&](int s) {
    int b, y0, x0;
    tile_origin<KB>(geo, group + s * n_groups, &b, &y0, &x0);
    const size_t off = (size_t)b * H * W * C;
    stage_rows<KB>(dabuf, da + off, H, W, C, y0, x0, c0, width_da);
    stage_rows<KB>(xbuf, x + off, H, W, C, y0, x0, c0, width_x);
    if (s == 0) stage_taps<KB>(tapbuf, taps, C, c0);
  };

  float2 wacc[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) wacc[j] = make_float2(0.f, 0.f);

  for (int s = 0; s < steps; ++s) {
    issue(s);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    int b, y0, x0;
    tile_origin<KB>(geo, group + s * n_groups, &b, &y0, &x0);
    const float* dat = dabuf;
    const Tin* xt = xbuf;

    // dgrad: the conv core on da with the taps turned by 180 degrees
    float2 acc[SW];
#pragma unroll
    for (int o = 0; o < SW; ++o) acc[o] = make_float2(0.f, 0.f);
    conv_strip<KB, true>(dat, tapbuf, st, acc);
    const int py = y0 + st.row;
#pragma unroll
    for (int o = 0; o < SW; ++o) {
      const int px = x0 + st.col0 + o;
      if (py < H && px < W)
        store2(dx + (((size_t)b * H + py) * W + px) * C + c, acc[o], c, C);
    }

    if (wthread) {
      // wgrad: ddwk[wi][j] += sum over the tile of da[p] x[p + (wi, j)]
      // (staged coordinates; padding and pixels outside are zero)
#pragma unroll 1
      for (int r = 0; r < TH; ++r) {
#pragma unroll
        for (int cb = 0; cb < TW / SW; ++cb) {
          float2 dv[SW];
#pragma unroll
          for (int o = 0; o < SW; ++o)
            dv[o] = load2(dat + ((r + 3) * RS + cb * SW + 3 + o) * CK +
                          2 * pair);
          const Tin* xs = xt + ((r + wi) * RS + cb * SW) * CK + 2 * pair;
#pragma unroll
          for (int q = 0; q < SW + 6; ++q) {
            const float2 v = load2(xs + q * CK);
#pragma unroll
            for (int j = 0; j < 7; ++j) {
              const int o = q - j;
              if (o >= 0 && o < SW) {
                wacc[j].x = fmaf(dv[o].x, v.x, wacc[j].x);
                wacc[j].y = fmaf(dv[o].y, v.y, wacc[j].y);
              }
            }
          }
        }
      }
    } else {
      // ddwb: the sum of da over the tile
#pragma unroll 1
      for (int r = 0; r < TH; ++r) {
#pragma unroll
        for (int q = 0; q < TW; ++q) {
          const float2 v = load2(dat + ((r + 3) * RS + 3 + q) * CK + 2 * pair);
          wacc[0].x += v.x;
          wacc[0].y += v.y;
        }
      }
    }
    __syncthreads();
  }

  float* pg = part + (size_t)group * 50 * C;
  if (wthread) {
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const size_t k = (size_t)(7 * wi + j) * C;
      if (c < C) pg[k + c] = wacc[j].x;
      if (c + 1 < C) pg[k + c + 1] = wacc[j].y;
    }
  } else {
    if (c < C) pg[(size_t)49 * C + c] = wacc[0].x;
    if (c + 1 < C) pg[(size_t)49 * C + c + 1] = wacc[0].y;
  }
}

template <typename T>
__device__ __forceinline__ void put(void* dst, size_t i, float v) {
  static_cast<T*>(dst)[i] = T(v);
}

// out k < 49: ddwk[c][k]; 49: ddwb; 50: dlns; 51: dlnb; each the sum of
// its partials over the blocks, in block order, rounded once
__global__ void dwconv_ln_bwd_reduce_kernel(
    const float* __restrict__ part_b, int n_groups,
    const float* __restrict__ part_a, int n_stats, int C, void* ddwk,
    void* ddwb, void* dlns, void* dlnb, int bf16_mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 52 * C) return;
  const int k = i / C, c = i % C;
  float s = 0.f;
  if (k < 50) {
    for (int gi = 0; gi < n_groups; ++gi)
      s += part_b[((size_t)gi * 50 + k) * C + c];
  } else {
    for (int gi = 0; gi < n_stats; ++gi)
      s += part_a[((size_t)gi * 2 + (k - 50)) * C + c];
  }
  const int which = k < 49 ? 0 : k - 48;            // ddwk, ddwb, dlns, dlnb
  void* dst[4] = {ddwk, ddwb, dlns, dlnb};
  const size_t at = k < 49 ? (size_t)c * 49 + k : (size_t)c;
  if ((bf16_mask >> which) & 1)
    put<__nv_bfloat16>(dst[which], at, s);
  else
    put<float>(dst[which], at, s);
}

// n_stats: the rows of part_a, at most the stats kernel's clusters (G
// blocks each); n_groups: tile groups of the conv kernel (one block a
// group and channel chunk)
template <class K, int NCB, typename Tin, typename Tg>
int launch_k(const void* x, const float* taps, const float* dwb,
             const float* lns, const void* g, float* da, float* part_a,
             int n_stats, float* part_b, int n_groups, void* dx, void* ddwk,
             void* ddwb, void* dlns, void* dlnb, int B, int H, int W, int C,
             int G, int bf16_mask, float eps, cudaStream_t stream) {
  const Geo geo = make_geo<K>(B, H, W, C);
  const Geo geo_b = make_geo<KB>(B, H, W, C);
  if (n_stats < 1 || n_groups < 1 || n_groups > geo_b.n_tiles)
    return (int)cudaErrorInvalidValue;

  constexpr auto ka = dwconv_ln_bwd_stats_kernel<K, NCB, Tin, Tg>;
  const size_t smem_a =
      2 * K::TILE_ELEMS * sizeof(Tin) + 2 * K::TAP_ELEMS * 4 +
      12 * K::TH * K::TW * 4 + 2 * K::NS * K::CK * 4 +
      2 * NCB * K::TH * (K::TW + 1) * K::CK * sizeof(Tg);
  int err = set_smem<ka>(smem_a);
  if (err != 0) return err;
  n_stats = std::min({n_stats, geo.n_tiles,
                      resident_clusters<ka>(G, K::THREADS, smem_a)});
  err = launch_clusters(ka, n_stats * G, K::THREADS, smem_a, G, stream,
                        static_cast<const Tin*>(x), taps, dwb, lns,
                        static_cast<const Tg*>(g), da, part_a, geo,
                        copy_width(C, sizeof(Tin)),
                        copy_width(C, sizeof(Tg)), eps);
  if (err != 0) return err;

  const size_t smem_b = KB::TILE_ELEMS * (4 + sizeof(Tin)) +
                        KB::TAP_ELEMS * 4;
  constexpr auto kb = dwconv_ln_bwd_conv_kernel<Tin>;
  err = set_smem<kb>(smem_b);
  if (err != 0) return err;
  kb<<<n_groups * geo_b.n_chunks, KB::THREADS, smem_b, stream>>>(
      static_cast<const Tin*>(x), da, taps, static_cast<Tin*>(dx), part_b,
      geo_b, copy_width(C, sizeof(Tin)), copy_width(C, 4));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_out = 52 * C;
  dwconv_ln_bwd_reduce_kernel<<<(n_out + 255) / 256, 256, 0, stream>>>(
      part_b, n_groups, part_a, n_stats, C, ddwk, ddwb, dlns, dlnb,
      bf16_mask);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tg>
int launch(const void* x, const float* taps, const float* dwb,
           const float* lns, const void* g, float* da, float* part_a,
           int n_stats, float* part_b, int n_groups, void* dx, void* ddwk,
           void* ddwb, void* dlns, void* dlnb, int B, int H, int W, int C,
           int bf16_mask, float eps, cudaStream_t stream) {
  using K = Tiling<4, 16, 32, 8>;
  const Split sp = split_channels(C, K::CK);
#define SM3DET_BWD_NCB(N)                                                    \
  return launch_k<K, N, Tin, Tg>(x, taps, dwb, lns, g, da, part_a, n_stats,  \
                                 part_b, n_groups, dx, ddwk, ddwb, dlns,     \
                                 dlnb, B, H, W, C, sp.g, bf16_mask, eps,     \
                                 stream)
  switch (sp.ncb) {
    case 1: SM3DET_BWD_NCB(1);
    case 2: SM3DET_BWD_NCB(2);
    case 3: SM3DET_BWD_NCB(3);
    case 4: SM3DET_BWD_NCB(4);
    case 6: SM3DET_BWD_NCB(6);
    default: SM3DET_BWD_NCB(8);
  }
#undef SM3DET_BWD_NCB
}

}  // namespace

extern "C" int sm3det_dwconv_ln_bwd(
    const void* x, const float* taps, const float* dwb, const float* lns,
    const void* g, float* da, float* part_a, int n_stats, float* part_b,
    int n_groups, void* dx, void* ddwk, void* ddwb, void* dlns, void* dlnb,
    int B, int H, int W, int C, int in_bf16, int g_bf16, int bf16_mask,
    float eps, cudaStream_t stream) {
  if (C <= 0 || C > dwcore::MAX_CHANNELS) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
#define SM3DET_BWD(TI, TG)                                                   \
  return launch<TI, TG>(x, taps, dwb, lns, g, da, part_a, n_stats, part_b,   \
                        n_groups, dx, ddwk, ddwb, dlns, dlnb, B, H, W, C,    \
                        bf16_mask, eps, stream)
  if (in_bf16 && g_bf16) SM3DET_BWD(bf, bf);
  if (in_bf16) SM3DET_BWD(bf, float);
  if (g_bf16) SM3DET_BWD(float, bf);
  SM3DET_BWD(float, float);
#undef SM3DET_BWD
}
