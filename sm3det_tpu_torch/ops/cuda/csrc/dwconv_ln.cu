// 7x7 depthwise convolution followed by LayerNorm over channels, NHWC.
//
// Replaces: sm3det_tpu/ops/pallas/convnext_block_kernel.py,
//   fused_dwconv_ln (the whole Pallas kernel) and the dw7x7 + LN prefix of
//   fused_convnext_block (_make_block_kernel); also the forward of
//   fused_dwconv_ln_train.
//
// Contract (that of _make_block_kernel): the 49 taps accumulate in fp32 on
// top of the conv bias, with zero padding 3; the LN statistics are taken on
// the unrounded fp32 accumulator, var = max(E[x^2] - mean^2, 0), eps given;
// the normalised value is scaled, shifted and rounded once to the output
// type. Input fp32 or bf16, output fp32 or bf16, any C <= 2048, any H, W.
//
// Bound on the H100: the fp32 FMA rate. Each output element needs 49 FMAs
// and ~8 flops of LN (~106 flops at the 67 TFLOP/s of the CUDA cores: the
// taps are not a matrix product) against one element read and one written:
// 4 bytes in bf16 (1.2 ps at 3.35 TB/s) for 1.6 ps of arithmetic. Over the
// 18 launches of an 8-image 800^2 forward: 0.35 ms.
//
// Design (dwconv_core.cuh): a cluster of up to 8 blocks owns a 4 x 16
// pixel tile and all C channels of it (the LN reduces over C); each block
// takes ncb of the C / 32 channel chunks (C = 96: 3 blocks of 1 chunk;
// 384: 6 of 2; 768: 8 of 3; ConvNeXt-L's 1536: 8 of 6; -XL's 2048: 8 of
// 8), so a thread keeps all its accumulators of the tile in registers: a
// channel pair x a strip of 8 pixels x ncb chunks.
// The chunks' halo tiles (10 x 22 pixels, 3.4x of the input, from L2) are
// copied by cp.async into two buffers, the next one in flight while this
// one computes, across tiles too: the clusters are persistent and walk a
// fixed list of tiles. Each block sums a and a^2 of its channels per pixel
// (registers, then the 16 lanes of a strip by shuffles) into shared memory;
// after a cluster barrier (one a tile) 64 threads add the blocks' sums
// through distributed shared memory, in rank order, and every block
// normalises its own accumulators: one sweep over the taps, 5.3 FMAs a
// shared-memory load.
//
// Why clusters: the LN needs each pixel's statistics over all C before any
// output is written. Holding a tile's fp32 accumulators for all C in one
// block's shared memory costs 96 KB at C = 768 for a 32-pixel tile (one
// block an SM); sweeping the chunks twice, statistics then output, doubles
// the FMAs and leaves the small stages short of blocks (25^2 x 768 with 8
// images: 112 tiles of 48 serial steps each). The cluster split keeps one
// sweep, 42 KB of shared memory a block (bf16), and up to 8 blocks a tile.

#include <algorithm>

#include "dwconv_core.cuh"

namespace {

using namespace dwcore;

template <class K, int NCB, typename Tin, typename Tout>
__global__ void __launch_bounds__(K::THREADS)
dwconv_ln_kernel(const Tin* __restrict__ x, const float* __restrict__ taps,
                 const float* __restrict__ dwb, const float* __restrict__ lns,
                 const float* __restrict__ lnb, Tout* __restrict__ out,
                 Geo geo, int width, float eps) {
  constexpr int CK = K::CK, SW = K::SW, TE = K::TILE_ELEMS;
  constexpr int TP = K::TH * K::TW;
  extern __shared__ __align__(16) unsigned char smem[];
  Tin* tiles = reinterpret_cast<Tin*>(smem);
  float* tapbuf = reinterpret_cast<float*>(smem + 2 * TE * sizeof(Tin));
  // [tile parity][2][TP]: this block's sums of a, a^2; then mean, rstd
  float* sums = tapbuf + 2 * K::TAP_ELEMS;
  float* stats = sums + 4 * TP;

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
  };

  if (steps > 0) issue(0);
  cp_commit();
  for (int it = 0; it < my_tiles; ++it) {
    int b, y0, x0;
    tile_origin<K>(geo, cid + it * ncl, &b, &y0, &x0);
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
    // this block's share of each pixel's sums of a and a^2
    float* my_sums = sums + (it & 1) * 2 * TP;
#pragma unroll
    for (int o = 0; o < SW; ++o) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < NCB; ++k) {
        s1 += acc[k][o].x + acc[k][o].y;
        s2 = fmaf(acc[k][o].x, acc[k][o].x,
                  fmaf(acc[k][o].y, acc[k][o].y, s2));
      }
      s1 = strip_sum<K>(s1);
      s2 = strip_sum<K>(s2);
      if (st.pair == 0) {
        const int pix = st.row * K::TW + st.col0 + o;
        my_sums[pix] = s1;
        my_sums[TP + pix] = s2;
      }
    }
    // one cluster barrier a tile: the sums alternate between two buffers,
    // so the next tile's writes cannot meet this tile's remote reads (the
    // next barrier lies between them)
    cluster.sync();
    if (tid < TP) {
      float v[2];
      cluster_sum(cluster, my_sums, TP, tid, G, v);
      const float inv_c = 1.f / (float)C;
      const float mean = v[0] * inv_c;
      stats[tid] = mean;
      stats[TP + tid] = rsqrtf(fmaxf(v[1] * inv_c - mean * mean, 0.f) + eps);
    }
    __syncthreads();
    const int py = y0 + st.row;
#pragma unroll
    for (int k = 0; k < NCB; ++k) {
      const int c = c_first + k * CK + 2 * st.pair;
      if (c >= C || py >= H) continue;
      const float2 sc = load2_global(lns + c, c, C);
      const float2 sh = load2_global(lnb + c, c, C);
#pragma unroll
      for (int o = 0; o < SW; ++o) {
        const int px = x0 + st.col0 + o;
        const int pix = st.row * K::TW + st.col0 + o;
        if (px < W) {
          const float mean = stats[pix], rstd = stats[TP + pix];
          float2 v;
          v.x = (acc[k][o].x - mean) * rstd * sc.x + sh.x;
          v.y = (acc[k][o].y - mean) * rstd * sc.y + sh.y;
          store2(out + (((size_t)b * H + py) * W + px) * C + c, v, c, C);
        }
      }
    }
  }
  cluster.sync();      // no block leaves while another reads its sums
}

template <class K, int NCB, typename Tin, typename Tout>
int launch_k(const void* x, const float* taps, const float* dwb,
             const float* lns, const float* lnb, void* out, int B, int H,
             int W, int C, int G, float eps, cudaStream_t stream) {
  constexpr auto kern = dwconv_ln_kernel<K, NCB, Tin, Tout>;
  const Geo geo = make_geo<K>(B, H, W, C);
  const size_t smem = 2 * K::TILE_ELEMS * sizeof(Tin) +
                      2 * K::TAP_ELEMS * sizeof(float) +
                      6 * K::TH * K::TW * sizeof(float);
  const int err = set_smem<kern>(smem);
  if (err != 0) return err;
  const int n_clusters = std::min(
      geo.n_tiles, resident_clusters<kern>(G, K::THREADS, smem));
  return launch_clusters(kern, n_clusters * G, K::THREADS, smem, G, stream,
                         static_cast<const Tin*>(x), taps, dwb, lns, lnb,
                         static_cast<Tout*>(out), geo,
                         copy_width(C, sizeof(Tin)), eps);
}

template <typename Tin, typename Tout>
int launch(const void* x, const float* taps, const float* dwb,
           const float* lns, const float* lnb, void* out, int B, int H, int W,
           int C, float eps, cudaStream_t stream) {
  using K = Tiling<4, 16, 32, 8>;
  const Split sp = split_channels(C, K::CK);
#define SM3DET_FWD_NCB(N)                                                    \
  return launch_k<K, N, Tin, Tout>(x, taps, dwb, lns, lnb, out, B, H, W, C,  \
                                   sp.g, eps, stream)
  switch (sp.ncb) {
    case 1: SM3DET_FWD_NCB(1);
    case 2: SM3DET_FWD_NCB(2);
    case 3: SM3DET_FWD_NCB(3);
    case 4: SM3DET_FWD_NCB(4);
    case 6: SM3DET_FWD_NCB(6);
    default: SM3DET_FWD_NCB(8);
  }
#undef SM3DET_FWD_NCB
}

}  // namespace

extern "C" int sm3det_dwconv_ln(const void* x, const float* taps,
                                const float* dwb, const float* lns,
                                const float* lnb, void* out, int B, int H,
                                int W, int C, int in_bf16, int out_bf16,
                                float eps, cudaStream_t stream) {
  if (C <= 0 || C > dwcore::MAX_CHANNELS) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
#define SM3DET_FWD(TI, TO)                                                   \
  return launch<TI, TO>(x, taps, dwb, lns, lnb, out, B, H, W, C, eps, stream)
  if (in_bf16 && out_bf16) SM3DET_FWD(bf, bf);
  if (in_bf16) SM3DET_FWD(bf, float);
  if (out_bf16) SM3DET_FWD(float, bf);
  SM3DET_FWD(float, float);
#undef SM3DET_FWD
}
