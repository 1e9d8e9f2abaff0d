// Fused bf16 FFN for Hopper: both products by wgmma, tiles by TMA, and the
// hidden activation kept on chip. One launch computes
//
//   h = round_bf16(gelu_tanh(round_bf16(x @ W1[e] + b1[e])))     fp32 sums
//   MoE:    y = round_bf16(h @ W2[e] + b2[e])
//   dense:  y = round_bf16(shortcut + gamma * (h @ W2[e] + b2[e]))  in fp32
//
// with e = tile_expert[row0 / tile_rows] for every 128-row tile (e = 0 when
// there is no tile_expert: a dense block). x (M, C), W1 (E, C, H) and
// W2 (E, H, C) are row-major bf16, the JAX layout, read as they are: W1
// and W2 are the MN-major (transposed) B operands of wgmma. b1, b2 and
// gamma are read in their own dtype (bf16 or fp32) and widened here.
//
// Replaces: sm3det_tpu/ops/pallas/moe_groupgemm_kernel.py::_kernel (the
// MoE expert FFN over the group-aligned slot layout) and the MLP half of
// convnext_block_kernel.py::_make_block_kernel (the same FFN with one
// expert, layer scale and residual). Both TPU kernels keep the hidden
// activation in VMEM; this one keeps it in shared memory.
//
// Bound on the H100: 4 M C H flops against (2 M C + E 2 C H) bf16 elements
// of traffic: at the ConvNeXt-T shapes (M >= 5,000, C >= 96, H = 4C) some
// 100 flops a byte and more, so the tensor cores' 989 TFLOP/s bound it.
// The two-launch design it replaces wrote and read back an (M, 4C) bf16
// hidden tensor, 0.8 ms of device-memory traffic a forward on its own.
//
// Design:
// - A cluster of NC blocks owns 128 rows; block r owns the output columns
//   [G r, G r + G), each block two consumer warpgroups of 64 rows. The
//   variant follows from C: one block of G = 96 or 192 up to C = 192,
//   clusters of 2 and 4 blocks of 192 up to C = 384 and 768, above that
//   clusters of 8 blocks of 128 (the portable cluster size) that cover
//   C in passes of 1024 columns (one pass up to C = 1024; each further
//   pass recomputes the hidden activation). The hidden dimension is
//   walked in chunks of 64 NC units. For each chunk, block r computes
//   units [64 r, 64 r + 64) of it: fc1 over K = C by wgmma (64 x 64 a
//   warpgroup, fp32 in registers); bias, bf16 rounding and GELU in
//   registers; the bf16 result into panel r of the warpgroup's
//   128-byte-swizzled h chunk, and from there by bulk copies into panel r
//   of every other block of the cluster (distributed shared memory). Then
//   each block runs fc2 by wgmma over the whole chunk for its columns,
//   accumulating the 64 x G output of each warpgroup in registers across
//   the whole hidden walk. Neither h nor the output pre-activation passes
//   through device memory, and no block recomputes another's fc1.
// - Registers: the output accumulator (G/2 a thread) and two fc1
//   accumulators (32 each) stay in the register file: the consumers take
//   232 registers a thread from the producer warpgroup (setmaxnreg).
// - One producer thread keeps two rings of stages full by TMA: W1 k-blocks
//   (64 x 64) of the block's hidden units, and W2 k-blocks (64 x G) of its
//   columns, of the tile's expert; full/empty mbarriers pace it against
//   the consumers. For C <= 384 the x tile is loaded once a tile and stays
//   resident, and fc1 of chunk j + 1 and fc2 of chunk j - 1 run on the
//   tensor cores while the GELU of chunk j runs on the CUDA cores (two
//   fc1 accumulators take turns); above that x streams with W1 and a
//   chunk's steps run in turn. TMA zero-fills rows past M, columns past C
//   and units past H; the epilogue masks its stores.
// - The h exchange, a warpgroup's leader thread for the warpgroup: it
//   waits on hfree (every block's leader has seen its fc2 of the previous
//   chunk complete), copies its panel to the other blocks, where the copy
//   completes as transaction bytes on their hfull, and posts on its own
//   hfull the bytes it expects from them.
// - Persistent: one cluster walks its work items (a 128-row tile, or a
//   column pass of one) in order; tiles are sorted by expert, so clusters
//   running at the same time read the same expert's weights from L2.
// - Deterministic: every output element is one accumulator summed in a
//   fixed order, no atomics.
// - GELU: 0.5 v (1 + tanh u) with tanh.approx.f32 (max relative error
//   ~2^-11, mostly hidden by the bf16 rounding that follows).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "device_cache.cuh"
#include "wgmma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int BM = 128;          // rows of a tile
constexpr int KB = 64;           // depth of a k-block (one 128-byte row)
constexpr int HU = 64;           // hidden units a block computes a chunk
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
constexpr int PANEL = 64 * 64 * 2;         // 64 x 64 bf16: 8 KB
constexpr int X_PANEL = BM * KB * 2;       // 128 x 64 bf16: 16 KB
constexpr int MAX_STAGES = 16;

// G: output columns a block; NC: blocks a cluster; XRES: x stays resident
template <int G, int NC, bool XRES>
struct Cfg {
  static constexpr int HC = HU * NC;           // hidden units a chunk
  static constexpr int GP = (G + 63) / 64;     // 64-wide panels of G
  static constexpr int H_BYTES = NC * PANEL;   // a warpgroup's h chunk
  // W1 ring: a k-block of the block's W1 units, with its x panel if x
  // streams; W2 ring: a k-block (64 hidden rows) of the block's columns
  static constexpr int ST1 = PANEL + (XRES ? 0 : X_PANEL);
  static constexpr int ST2 = GP * PANEL;
};

// read-only loads (the non-coherent path), so the compiler may issue them
// ahead of the stores they do not alias: two neighbouring elements i,
// i + 1 (i even) of a bf16 or fp32 vector in one load
__device__ __forceinline__ float2 load_pair(const void* p, size_t i, int bf) {
  if (bf)
    return __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p) + i / 2));
  return __ldg(reinterpret_cast<const float2*>(p) + i / 2);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 0.5 v (1 + tanh u): tanh.approx.f32 (max relative error ~2^-11; the bf16
// rounding after it hides most of that)
__device__ __forceinline__ float gelu_tanh(float v) {
  // u = sqrt(2/pi) (v + 0.044715 v^3)
  const float u = v * fmaf(0.035677408136300125f, v * v, 0.79788456080286536f);
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(u));
  const float hv = 0.5f * v;
  return fmaf(hv, t, hv);
}

struct Params {
  const void* tile_expert;
  int tile_rows;
  const void* b1;
  const void* b2;
  const bf16* shortcut;   // never null: every load below stays inside
  const void* gamma;      // its array, so none can fault if hoisted
  bf16* out;
  int M, C, H, n_tiles, s1, s2;                // s1, s2: ring stages
  int npass;              // column passes a tile: work item w is tile
                          // w / npass, columns from (w % npass) NC G
  int flags;              // bits 0-2: b1, b2, gamma in bf16; bit 3:
                          // tile_expert in int64; bit 4: the residual
                          // epilogue (else shortcut and gamma are unread)
};

__device__ __forceinline__ int tile_expert_of(const Params& p, int row0) {
  if (!p.tile_expert) return 0;
  const int t = row0 / p.tile_rows;
  return (p.flags & 8)
             ? static_cast<int>(static_cast<const long long*>(p.tile_expert)[t])
             : static_cast<const int*>(p.tile_expert)[t];
}

// a position in a ring of stages and the parity of its current pass
struct Ring {
  int s, n;
  uint32_t ph;
  __device__ __forceinline__ void next() {
    if (++s == n) { s = 0; ph ^= 1; }
  }
};

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// one arrival a warp on the ring's next `count` empty barriers, in order
__device__ __forceinline__ void release(uint64_t* empty, Ring& rel, int count,
                                        int lane) {
  __syncwarp();
  for (int i = 0; i < count; ++i) {
    if (lane == 0) mbar_arrive(empty + rel.s);
    rel.next();
  }
}

// the consumer warpgroups' side of the pipeline
template <int G, int NC, bool XRES>
struct Pipe {
  using K = Cfg<G, NC, XRES>;
  static constexpr int GP = K::GP;
  const Params& p;
  unsigned char* x_s;
  unsigned char* ring1;
  unsigned char* ring2;
  uint64_t* full1;
  uint64_t* empty1;
  uint64_t* full2;
  uint64_t* empty2;
  uint64_t* hfull;        // this warpgroup's
  uint64_t* hfree;
  uint32_t h_addr;        // this warpgroup's h chunk
  int kp, wg, lane, r_lo, cq, rank;
  bool lead;              // thread 0 of the warpgroup
  Ring r1, r2;            // next stage to consume
  Ring q1, q2;            // next stage to release
  uint32_t hfull_ph, hfree_ph;

  // fc1 of the block's 64 units of a chunk: acc (64 x 64) = x rows x W1
  // k-blocks, one wgmma group, each k-block issued as its stage arrives.
  // drain: keep at most one k-block in flight and release the stages as
  // they complete (all but the last); else leave the group in flight
  __device__ __forceinline__ void fc1(float (&acc)[HU / 2], bool drain) {
    fence_regs(acc);
    for (int kb = 0; kb < kp; ++kb) {
      mbar_wait(full1 + r1.s, r1.ph);
      unsigned char* st = ring1 + r1.s * K::ST1;
      const uint32_t a0 =
          smem_u32(XRES ? x_s + kb * X_PANEL : st + PANEL) + wg * (64 * 128);
      const uint32_t b0 = smem_u32(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        Wgmma<HU>::mma(acc, desc_sw128(a0 + kk * 32, 16, 1024),
                       desc_sw128(b0 + kk * 16 * 128, PANEL, 1024),
                       kb > 0 || kk > 0);          // the first: acc = A B
      r1.next();
      if (drain) {
        wgmma_commit();
        wgmma_wait<1>();
        if (kb > 0) release(empty1, q1, 1, lane);
      }
    }
    if (!drain) wgmma_commit();
    fence_regs(acc);
  }

  // fc2 of the chunk in h: acc (64 x G) += h x W2[chunk rows, columns],
  // NC k-blocks; drain as fc1 does
  __device__ __forceinline__ void fc2(float (&acc)[G / 2], bool drain) {
    fence_regs(acc);
    for (int kb = 0; kb < NC; ++kb) {
      mbar_wait(full2 + r2.s, r2.ph);
      const uint32_t b0 = smem_u32(ring2 + r2.s * K::ST2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        Wgmma<G>::mma(acc, desc_sw128(h_addr + kb * PANEL + kk * 32, 16,
                                      1024),
                      desc_sw128(b0 + kk * 16 * 128, PANEL, 1024), 1);
      r2.next();
      if (drain) {
        wgmma_commit();
        wgmma_wait<1>();
        if (kb > 0) release(empty2, q2, 1, lane);
      }
    }
    if (!drain) wgmma_commit();
    fence_regs(acc);
  }

  // b1 of the block's units of chunk j at this thread's columns (8i + cq,
  // + 1), clamped into the array (the GELU zeroes units past H): issued
  // ahead of the GELU that first uses them, so that their latency hides
  // behind the fc1 issue
  __device__ __forceinline__ void load_b1(float (&bias)[HU / 4], int j,
                                          int e) {
    const bool bf = p.flags & 1;
#pragma unroll
    for (int i = 0; i < HU / 8; ++i) {
      const int hu = min(j * K::HC + rank * HU + 8 * i + cq, p.H - 2);
      const float2 b =
          load_pair(p.b1, static_cast<size_t>(e) * p.H + hu, bf);
      bias[2 * i] = b.x;
      bias[2 * i + 1] = b.y;
    }
  }

  // bias, bf16 rounding and GELU of the fc1 accumulator of chunk j, as
  // bf16 pairs (units past H: 0)
  __device__ __forceinline__ void gelu(const float (&acc)[HU / 2],
                                       const float (&bias)[HU / 4], int j,
                                       uint32_t (&v)[HU / 8][2]) {
#pragma unroll
    for (int i = 0; i < HU / 8; ++i) {
      const bool live = j * K::HC + rank * HU + 8 * i + cq < p.H;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        __nv_bfloat162 b = __floats2bfloat162_rn(0.f, 0.f);
        if (live)
          b = __floats2bfloat162_rn(
              gelu_tanh(round_bf16(acc[4 * i + 2 * hr] + bias[2 * i])),
              gelu_tanh(round_bf16(acc[4 * i + 2 * hr + 1] + bias[2 * i + 1])));
        v[i][hr] = *reinterpret_cast<uint32_t*>(&b);
      }
    }
  }

  // the pairs into panel `rank` of this block's h chunk; with a cluster,
  // once every block has finished the previous chunk's fc2, the
  // warpgroup's leader copies the panel into the same place in every other
  // block (bulk copies that complete on their hfull) and expects the
  // other blocks' panels on its own hfull
  __device__ __forceinline__ void share(const uint32_t (&v)[HU / 8][2]) {
    const uint32_t panel = h_addr + rank * PANEL;
#pragma unroll
    for (int i = 0; i < HU / 8; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r_lo + 8 * hr;
        st_shared_u32(panel + row * 128 + ((i ^ (row % 8)) * 16) + cq * 2,
                      v[i][hr]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (NC > 1 && lead) {
      mbar_wait_cluster(hfree, hfree_ph ^ 1);
#pragma unroll
      for (int r = 0; r < NC; ++r)
        if (r != rank)
          bulk_copy_to_rank(map_to_rank(panel, r), panel, PANEL,
                            map_to_rank(smem_u32(hfull), r));
      mbar_expect_tx(hfull, (NC - 1) * PANEL);
    }
    hfree_ph ^= 1;
  }

  // the h chunk is whole in this block
  __device__ __forceinline__ void wait_h() {
    if (NC == 1) return;
    mbar_wait(hfull, hfull_ph);
    hfull_ph ^= 1;
  }

  // this warpgroup has finished reading its h chunk: every block of the
  // cluster may overwrite it
  __device__ __forceinline__ void free_h() {
    if (NC > 1 && lead) {
#pragma unroll
      for (int r = 0; r < NC; ++r)
        mbar_arrive_remote(map_to_rank(smem_u32(hfree), r));
    }
  }

  // the previous chunk's fc2 has completed: its W2 stages go back, and
  // the h chunk is free
  __device__ __forceinline__ void fc2_done() {
    release(empty2, q2, NC, lane);
    free_h();
  }

  // chunk j of the resident-x schedule: fc1 of chunk j + 1 and fc2 of
  // chunk j - 1 run on the tensor cores while the GELU of chunk j runs on
  // the CUDA cores
  __device__ __forceinline__ void step(float (&cur)[HU / 2],
                                       float (&nxt)[HU / 2],
                                       float (&acc2)[G / 2], int j, int nch,
                                       int e, uint64_t* x_empty) {
    float bias[HU / 4];
    uint32_t v[HU / 8][2];
    load_b1(bias, j, e);
    const bool more = j + 1 < nch;
    if (more) fc1(nxt, false);
    gelu(cur, bias, j, v);
    if (j > 0) {                           // fc2 of chunk j - 1
      if (more)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(acc2);
      fc2_done();
    }
    share(v);
    if (more) {
      wgmma_wait<0>();            // fc1 of chunk j + 1
      fence_regs(nxt);
      release(empty1, q1, kp, lane);
      if (j + 2 == nch) {
        __syncwarp();
        if (lane == 0) mbar_arrive(x_empty);   // the next tile's x may load
      }
    }
    wait_h();
    fc2(acc2, false);
  }
};

template <int G, int NC, bool XRES>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fused_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_w2,
                 const Params p) {
  using K = Cfg<G, NC, XRES>;
  constexpr int HC = K::HC, GP = K::GP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kp = (p.C + KB - 1) / KB;    // k-blocks of fc1
  const int nch = (p.H + HC - 1) / HC;   // hidden chunks
  const int rank = NC > 1 ? (int)cluster_rank() : 0;
  const int first = NC > 1 ? (int)cluster_id() : blockIdx.x;
  const int stride = NC > 1 ? (int)cluster_count() : gridDim.x;
  unsigned char* x_s = smem;                               // XRES only
  unsigned char* h_s = x_s + (XRES ? kp * X_PANEL : 0);    // 2 h chunks
  unsigned char* ring1 = h_s + 2 * K::H_BYTES;
  unsigned char* ring2 = ring1 + p.s1 * K::ST1;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(ring2 + p.s2 * K::ST2);
  uint64_t* empty1 = full1 + p.s1;
  uint64_t* full2 = empty1 + p.s1;
  uint64_t* empty2 = full2 + p.s2;
  uint64_t* x_full = empty2 + p.s2;
  uint64_t* x_empty = x_full + 1;
  uint64_t* hfull = x_empty + 1;          // one a warpgroup
  uint64_t* hfree = hfull + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.s1; ++s) {
      mbar_init(full1 + s, 1);
      mbar_init(empty1 + s, CONSUMERS / 32);   // one arrival a warp
    }
    for (int s = 0; s < p.s2; ++s) {
      mbar_init(full2 + s, 1);
      mbar_init(empty2 + s, CONSUMERS / 32);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, CONSUMERS / 32);
    for (int w = 0; w < 2; ++w) {
      mbar_init(hfull + w, 1);        // the leader's expect_tx + the copies
      mbar_init(hfree + w, NC);       // each block's leader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // no block arrives on another's barriers before they exist
  if (NC > 1)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----------------------
    regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS) {
      Ring r1{0, p.s1, 0}, r2{0, p.s2, 0};
      uint32_t xph = 0;
      for (int w = first; w < p.n_tiles * p.npass; w += stride) {
        const int row0 = w / p.npass * BM;
        const int col0 = (w % p.npass * NC + rank) * G;
        const int e = tile_expert_of(p, row0);
        if (XRES) {
          mbar_wait(x_empty, xph ^ 1);
          mbar_expect_tx(x_full, kp * X_PANEL);
          for (int kb = 0; kb < kp; ++kb)
            tma_load_2d(x_s + kb * X_PANEL, &map_x, x_full, kb * KB, row0);
          xph ^= 1;
        }
        // W1 of chunk j: rows kb, the block's units (with x if it streams)
        auto load_w1 = [&](int j) {
          for (int kb = 0; kb < kp; ++kb) {
            mbar_wait(empty1 + r1.s, r1.ph ^ 1);
            unsigned char* st = ring1 + r1.s * K::ST1;
            mbar_expect_tx(full1 + r1.s, K::ST1);
            tma_load_3d(st, &map_w1, full1 + r1.s, j * HC + rank * HU,
                        kb * KB, e);
            if (!XRES)
              tma_load_2d(st + PANEL, &map_x, full1 + r1.s, kb * KB, row0);
            r1.next();
          }
        };
        // W2 of chunk j: its rows, the block's columns
        auto load_w2 = [&](int j) {
          for (int kb = 0; kb < NC; ++kb) {
            mbar_wait(empty2 + r2.s, r2.ph ^ 1);
            unsigned char* st = ring2 + r2.s * K::ST2;
            mbar_expect_tx(full2 + r2.s, K::ST2);
#pragma unroll
            for (int q = 0; q < GP; ++q)
              tma_load_3d(st + q * PANEL, &map_w2, full2 + r2.s,
                          col0 + q * 64, j * HC + kb * KB, e);
            r2.next();
          }
        };
        // in the order the consumers take them: with x resident, fc1 of
        // chunk j + 1 is issued before fc2 of chunk j
        if (XRES) load_w1(0);
        for (int j = 0; j < nch; ++j) {
          if (!XRES)
            load_w1(j);
          else if (j + 1 < nch)
            load_w1(j + 1);
          load_w2(j);
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups, 64 rows each -------------------------
    regs_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int r_lo = 16 * warp + lane / 4;      // row in the warpgroup's 64
    const int cq = 2 * (lane % 4);              // column pair in an 8-group
    Pipe<G, NC, XRES> c{p, x_s, ring1, ring2, full1, empty1, full2, empty2,
                        hfull + wg, hfree + wg, smem_u32(h_s + wg * K::H_BYTES),
                        kp, wg, lane, r_lo, cq, rank, t == 0,
                        {0, p.s1, 0}, {0, p.s2, 0}, {0, p.s1, 0},
                        {0, p.s2, 0}, 0, 0};
    uint32_t xph = 0;

    const int n_work = p.n_tiles * p.npass;
    for (int w = first; w < n_work; w += stride) {
      const int row0 = w / p.npass * BM;
      const int col0 = (w % p.npass * NC + rank) * G;
      const int e = tile_expert_of(p, row0);
      const bool last_work = w + stride >= n_work;
      float acc2[G / 2];
      zero(acc2);
      if (XRES) {
        float acc_a[HU / 2], acc_b[HU / 2];   // the first wgmma of each
        zero(acc_a);                          // fc1 overwrites them
        zero(acc_b);
        mbar_wait(x_full, xph);
        xph ^= 1;
        c.fc1(acc_a, false);
        wgmma_wait<0>();
        fence_regs(acc_a);
        release(empty1, c.q1, kp, lane);
        if (nch == 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(x_empty);
        }
        for (int j = 0; j < nch; j += 2) {
          c.step(acc_a, acc_b, acc2, j, nch, e, x_empty);
          if (j + 1 < nch) c.step(acc_b, acc_a, acc2, j + 1, nch, e, x_empty);
        }
        wgmma_wait<0>();                         // the last fc2
        fence_regs(acc2);
      } else {
        float acc1[HU / 2];
        zero(acc1);
        for (int j = 0; j < nch; ++j) {
          float bias[HU / 4];
          uint32_t v[HU / 8][2];
          c.load_b1(bias, j, e);
          c.fc1(acc1, true);
          wgmma_wait<0>();
          fence_regs(acc1);
          release(empty1, c.q1, 1, lane);
          c.gelu(acc1, bias, j, v);
          c.share(v);
          c.wait_h();
          c.fc2(acc2, true);
          wgmma_wait<0>();
          fence_regs(acc2);
          release(empty2, c.q2, 1, lane);
          if (j + 1 < nch) c.free_h();
        }
      }
      // the next work item's first chunk may overwrite h (after the
      // cluster's last, no block waits for it: no arrival on a finished
      // block)
      if (XRES) release(empty2, c.q2, NC, lane);
      if (!last_work) c.free_h();

      // epilogue: bias (+ layer scale and residual), one bf16 rounding;
      // in batches whose loads all issue before their stores
      // 8-column groups a batch: 12 (G = 96, 192) or 8 (G = 128)
      constexpr int EB = G / 8 % 12 == 0 ? 12 : 8;
      static_assert(G / 8 % EB == 0, "batches must tile G");
      const bool residual = p.flags & 16;
#pragma unroll
      for (int i0 = 0; i0 < G / 8; i0 += EB) {
        float bb[EB][2], gg[EB][2];
        __nv_bfloat162 sc[EB][2];
#pragma unroll
        for (int ii = 0; ii < EB; ++ii) {
          // clamped into the arrays; the stores below mask by the real
          // column and row
          const int col = min(col0 + 8 * (i0 + ii) + cq, p.C - 2);
          const float2 b = load_pair(
              p.b2, static_cast<size_t>(e) * p.C + col, p.flags & 2);
          const float2 g = load_pair(p.gamma, col, p.flags & 4);
          bb[ii][0] = b.x;
          bb[ii][1] = b.y;
          gg[ii][0] = g.x;
          gg[ii][1] = g.y;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = min(row0 + 64 * wg + r_lo + 8 * hr, p.M - 1);
            sc[ii][hr] = __ldg(reinterpret_cast<const __nv_bfloat162*>(
                p.shortcut + static_cast<size_t>(row) * p.C + col));
          }
        }
#pragma unroll
        for (int ii = 0; ii < EB; ++ii) {
          const int i = i0 + ii;
          const int col = col0 + 8 * i + cq;
          if (col >= p.C) continue;              // C % 8 == 0: pairs whole
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + 64 * wg + r_lo + 8 * hr;
            if (row >= p.M) continue;
            float v0 = acc2[4 * i + 2 * hr] + bb[ii][0];
            float v1 = acc2[4 * i + 2 * hr + 1] + bb[ii][1];
            if (residual) {
              v0 = __bfloat162float(sc[ii][hr].x) + gg[ii][0] * v0;
              v1 = __bfloat162float(sc[ii][hr].y) + gg[ii][1] * v1;
            }
            *reinterpret_cast<__nv_bfloat162*>(
                p.out + static_cast<size_t>(row) * p.C + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, taken from the libcuda the process
// already holds (no link-time dependence on the driver library)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a bf16 tensor of up to 3 dims (innermost first), 64 x rows boxes,
// 128-byte swizzle, zero fill outside
bool make_map(CUtensorMap* map, const void* base, int rank,
              const uint64_t* dims, const uint64_t* strides_bytes,
              uint32_t box_rows) {
  EncodeTiled enc = encode_fn();
  if (!enc) return false;
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), dims, strides_bytes, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the launch of one instantiation: column passes, ring sizes from the
// shared memory the card allows, and as many clusters as it holds at once
template <int G, int NC, bool XRES>
int launch(const CUtensorMap& mx, const CUtensorMap& m1,
           const CUtensorMap& m2, Params p, cudaStream_t stream) {
  using K = Cfg<G, NC, XRES>;
  auto kern = ffn_fused_kernel<G, NC, XRES>;
  const int kp = (p.C + KB - 1) / KB;
  // 1024: alignment slack; 48: the x and h barriers; 16 a stage
  const int fixed = 1024 + (XRES ? kp * X_PANEL : 0) + 2 * K::H_BYTES + 48;
  // the resident-x schedule holds a chunk's W1 and W2 k-blocks at once
  p.s2 = XRES && NC > 2 ? NC : 2;
  p.npass = (p.C + NC * G - 1) / (NC * G);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = NC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // dynamic shared memory the kernel may use, set once a device
  int avail = 0;
  int err = devcache::once<ffn_fused_kernel<G, NC, XRES>>(
      0, &avail, [kern](int dev, int* v) {
        int optin = 0;
        cudaFuncAttributes fa;
        cudaError_t e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
        if (e != cudaSuccess) return e;
        *v = optin - (int)fa.sharedSizeBytes;    // left for dynamic
        return cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *v);
      });
  if (err != 0) return err;
  p.s1 = (avail - fixed - p.s2 * (K::ST2 + 16)) / (K::ST1 + 16);
  if (p.s1 > MAX_STAGES) p.s1 = MAX_STAGES;
  if (p.s1 < (XRES ? kp : 2)) return (int)cudaErrorInvalidValue;
  cfg.dynamicSmemBytes = fixed + p.s1 * (K::ST1 + 16) + p.s2 * (K::ST2 + 16);
  int resident = 0;                              // clusters held at once
  err = devcache::once<ffn_fused_kernel<G, NC, XRES>>(
      (long long)cfg.dynamicSmemBytes + 1, &resident,
      [kern, cfg](int, int* v) mutable {
        cfg.gridDim = dim3(NC);
        if (cudaOccupancyMaxActiveClusters(v, kern, &cfg) != cudaSuccess ||
            *v < 1)
          return cudaErrorInvalidConfiguration;
        return cudaSuccess;
      });
  if (err != 0) return err;
  const int n_work = p.n_tiles * p.npass;
  const int clusters = n_work < resident ? n_work : resident;
  cfg.gridDim = dim3(clusters * NC);
  err = (int)cudaLaunchKernelEx(&cfg, kern, mx, m1, m2, p);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, C), w1 (E, C, H), w2 (E, H, C), shortcut and out (M, C): bf16;
// b1 (E, H), b2 (E, C), gamma (C,): bf16 or fp32 by flags (bit 0 b1,
// bit 1 b2, bit 2 gamma); tile_expert (M / tile_rows,) int32, or int64 with
// flags bit 3, or null (E = 1). flags bit 4: the dense block's epilogue;
// without it, the MoE epilogue (shortcut and gamma still point at arrays of
// their shapes and dtypes, which are not read).
extern "C" int sm3det_ffn_fused(const void* x, const void* tile_expert,
                                int tile_rows, const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* shortcut, const void* gamma,
                                void* out, int M, int C, int H, int E,
                                int flags, cudaStream_t stream) {
  if (M <= 0 || C <= 0 || C % 8 || H <= 0 || H % 8 ||
      (tile_expert && (tile_rows <= 0 || tile_rows % BM)) ||
      !shortcut || !gamma || (uintptr_t)x % 16 || (uintptr_t)w1 % 16 ||
      (uintptr_t)w2 % 16 || (uintptr_t)out % 4 || (uintptr_t)shortcut % 4)
    return (int)cudaErrorInvalidValue;
  const uint64_t dx[2] = {(uint64_t)C, (uint64_t)M};
  const uint64_t sx[1] = {(uint64_t)C * 2};
  const uint64_t d1[3] = {(uint64_t)H, (uint64_t)C, (uint64_t)E};
  const uint64_t s1[2] = {(uint64_t)H * 2, (uint64_t)C * H * 2};
  const uint64_t d2[3] = {(uint64_t)C, (uint64_t)H, (uint64_t)E};
  const uint64_t s2[2] = {(uint64_t)C * 2, (uint64_t)H * C * 2};
  CUtensorMap mx, m1, m2;
  if (!make_map(&mx, x, 2, dx, sx, BM) ||
      !make_map(&m1, w1, 3, d1, s1, KB) || !make_map(&m2, w2, 3, d2, s2, KB))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.tile_expert = tile_expert;
  p.tile_rows = tile_rows;
  p.b1 = b1;
  p.b2 = b2;
  p.shortcut = static_cast<const bf16*>(shortcut);
  p.gamma = gamma;
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.C = C;
  p.H = H;
  p.n_tiles = (M + BM - 1) / BM;
  p.flags = flags;
  p.s1 = p.s2 = p.npass = 0;
  // the narrowest variant that holds C; x stays resident up to C = 384
  // (96 KB a tile)
  if (C <= 96) return launch<96, 1, true>(mx, m1, m2, p, stream);
  if (C <= 192) return launch<192, 1, true>(mx, m1, m2, p, stream);
  if (C <= 384) return launch<192, 2, true>(mx, m1, m2, p, stream);
  if (C <= 768) return launch<192, 4, false>(mx, m1, m2, p, stream);
  return launch<128, 8, false>(mx, m1, m2, p, stream);
}
