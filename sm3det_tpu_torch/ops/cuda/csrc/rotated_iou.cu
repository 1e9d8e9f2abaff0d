// Pairwise IoU of rotated boxes (cx, cy, w, h, theta), batched over images:
// as a matrix, or as the packed suppression bits of greedy NMS.
//
// Replaces: sm3det_tpu/ops/pallas/rotated_iou_kernel.py::_iou_block_kernel
//   and ::_iou_block_kernel_banded (box_iou_rotated_pallas), the
//   suppression matrix of the rotated NMS.
//
// Contract: the sort-free Green's-theorem clipping of
// sm3det_tpu_torch/ops/rotated_iou.py. The boundary of A n B is (A's edges
// inside B) + (B's edges inside A); an edge p + t d is inside a convex quad
// on one interval [t_lo, t_hi] and adds 0.5 * cross(P(t_lo), P(t_hi)).
// A's edges are tested with the half-planes shifted by +1e-4 px, B's by
// -1e-4 px, so a shared boundary counts once. iou = inter / max(union,
// 1e-8) where union > 1e-8, else 0. Every operation is rounded on its own
// (exact_math.cuh), in the order of the plain version, because the NMS
// compares the result with a threshold. Both modes call one pair function
// (pair_iou).
//
// Matrix mode (sm3det_rotated_iou). triu: a tile strictly below the
// diagonal of tiles is written as zeros, uncomputed. Banded
// (groups1/groups2 given, ascending per image): a tile is computed only
// where the group ranges of its rows and of its columns overlap and
// neither side is all inert (group >= 1 << 20); other tiles are zeros.
// Rows and columns past N, M count as inert.
//
// Mask mode (sm3det_rotated_nms_mask): the self-IoU of N boxes, compared
// with thr in registers and packed by a warp ballot into (B, N, W) 32-bit
// words, W = ceil(N / 32): bit j % 32 of word j / 32 of row i is set iff
// j > i, j < N, iou(i, j) > thr and, banded, both groups are equal and
// below the inert group. A tile's 32 columns are exactly one word. Tiles
// below the diagonal or outside the band write their zero words
// uncomputed (128 bytes, against the matrix's 4 KB of zeros); inside a
// computed tile, pairs whose bit is 0 by position or group skip the
// clipping.
//
// Bound on the H100: operations. A computed pair costs ~650 fp32
// operations, 96 of them IEEE divisions, against 4 bytes written (the
// matrix) or 1 bit (the mask).
//
// Design: nothing of the TPU layout is kept (no (5, N) transpose, no
// 128-lane tiles). A block owns a 32 x 32 tile of one image (grid z). Its
// first 64 threads turn the tile's row and column boxes into corners, edge
// vectors, edge lengths and areas once, into shared memory, so sinf, cosf
// and sqrtf run per box and not per pair. Then one thread per pair, four
// pairs a thread: a warp shares its row box (a broadcast read) and reads
// 32 column boxes at an odd stride (no bank conflict), and stores 32
// consecutive floats, or one ballot word. The small tile makes the band
// and the triangle tight: at 26 classes of ~77 candidates a 128-wide tile
// would compute four times the pairs.

#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int GEOM = 21;  // 4 corners (x, y), 4 edges (x, y), 4 lengths, area
constexpr float EPS = 1e-8f;
constexpr int INERT_GROUP = 1 << 20;

// geometry record: [0..3] corner x, [4..7] corner y, [8..11] edge x,
// [12..15] edge y, [16..19] edge length, [20] area
__device__ void box_geometry(const float* __restrict__ box, float* g) {
  using namespace exact;
  const float x = box[0], y = box[1], w = box[2], h = box[3], a = box[4];
  const float ca = cosf(a), sa = sinf(a);
  const float wx = mul(mul(0.5f, w), ca), wy = mul(mul(0.5f, w), sa);
  const float hx = mul(mul(-0.5f, h), sa), hy = mul(mul(0.5f, h), ca);
  g[0] = sub(sub(x, wx), hx);
  g[4] = sub(sub(y, wy), hy);
  g[1] = sub(add(x, wx), hx);
  g[5] = sub(add(y, wy), hy);
  g[2] = add(add(x, wx), hx);
  g[6] = add(add(y, wy), hy);
  g[3] = add(sub(x, wx), hx);
  g[7] = add(sub(y, wy), hy);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ex = sub(g[(k + 1) & 3], g[k]);
    const float ey = sub(g[4 + ((k + 1) & 3)], g[4 + k]);
    g[8 + k] = ex;
    g[12 + k] = ey;
    g[16 + k] = fmaxf(root(add(mul(ex, ex), mul(ey, ey))), EPS);
  }
  g[20] = mul(w, h);
}

// Green's contribution of the edges of quad s clipped to the inside of
// quad c, half-planes shifted by eps_inside.
__device__ __forceinline__ float clip_contrib(const float (&s)[GEOM],
                                              const float (&c)[GEOM],
                                              float eps_inside) {
  using namespace exact;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float px = s[i], py = s[4 + i], dx = s[8 + i], dy = s[12 + i];
    float t_lo = 0.f, t_hi = 1.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float ox = c[k], oy = c[4 + k];
      const float ex = c[8 + k], ey = c[12 + k], el = c[16 + k];
      const float a0 = add(
          div(sub(mul(ex, sub(py, oy)), mul(ey, sub(px, ox))), el),
          eps_inside);
      const float b0 = div(sub(mul(ex, dy), mul(ey, dx)), el);
      const bool degenerate = fabsf(b0) < EPS;
      const float tc = div(-a0, degenerate ? EPS : b0);
      if (b0 > EPS && tc > t_lo) t_lo = tc;
      if (b0 < -EPS && tc < t_hi) t_hi = tc;
      if (degenerate && a0 < 0.f) {
        t_lo = 1.f;
        t_hi = 0.f;
      }
    }
    if (t_hi > t_lo) {
      const float x0 = add(px, mul(t_lo, dx)), y0 = add(py, mul(t_lo, dy));
      const float x1 = add(px, mul(t_hi, dx)), y1 = add(py, mul(t_hi, dy));
      total = add(total, mul(0.5f, sub(mul(x0, y1), mul(y0, x1))));
    }
  }
  return total;
}

__device__ __forceinline__ float pair_iou(const float (&q1)[GEOM],
                                          const float (&q2)[GEOM]) {
  const float inter = fmaxf(
      exact::add(clip_contrib(q1, q2, 1e-4f), clip_contrib(q2, q1, -1e-4f)),
      0.f);
  const float uni = exact::sub(exact::add(q1[20], q2[20]), inter);
  return uni > EPS ? exact::div(inter, fmaxf(uni, EPS)) : 0.f;
}

// MASK: boxes2 is boxes1, groups2 is groups1, out holds (B, N, W) words
template <bool MASK>
__global__ void __launch_bounds__(THREADS)
rotated_iou_kernel(const float* __restrict__ boxes1,
                   const float* __restrict__ boxes2,
                   const int* __restrict__ groups1,
                   const int* __restrict__ groups2, void* __restrict__ out,
                   int N, int M, int triu, float thr) {
  __shared__ float s1[TILE][GEOM];
  __shared__ float s2[TILE][GEOM];
  __shared__ int bounds[4];  // min, max of the row groups; of the columns
  __shared__ int gs[2][TILE];  // the row and column groups (mask mode)
  const int bi = blockIdx.y, bj = blockIdx.x, b = blockIdx.z;
  const int i0 = bi * TILE, j0 = bj * TILE;
  const int tid = threadIdx.x;
  const int W = (N + TILE - 1) / TILE;
  float* ob = static_cast<float*>(out) + (size_t)b * N * M;
  unsigned* mb = static_cast<unsigned*>(out) + (size_t)b * N * W;

  bool need = !(triu && bj < bi);
  if (need && groups1 != nullptr) {
    // the first warp reduces the row groups, the second the column groups
    if (tid < 2 * TILE) {
      const bool row = tid < TILE;
      const int lane = tid & (TILE - 1);
      const int idx = (row ? i0 : j0) + lane;
      const int lim = row ? N : M;
      const int* g = row ? groups1 + (size_t)b * N : groups2 + (size_t)b * M;
      const int v = idx < lim ? g[idx] : INERT_GROUP;
      const int lo = __reduce_min_sync(0xffffffffu, v);
      const int hi = __reduce_max_sync(0xffffffffu, v);
      if (MASK) gs[row ? 0 : 1][lane] = v;
      if (lane == 0) {
        bounds[row ? 0 : 2] = lo;
        bounds[row ? 1 : 3] = hi;
      }
    }
    __syncthreads();
    need = bounds[1] >= bounds[2] && bounds[3] >= bounds[0] &&
           bounds[0] < INERT_GROUP && bounds[2] < INERT_GROUP;
  }

  if (!need) {
    if (MASK) {
      if (tid < TILE && i0 + tid < N) mb[(size_t)(i0 + tid) * W + bj] = 0u;
      return;
    }
    for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
      const int gi = i0 + idx / TILE, gj = j0 + idx % TILE;
      if (gi < N && gj < M) ob[(size_t)gi * M + gj] = 0.f;
    }
    return;
  }

  if (tid < 2 * TILE) {
    const bool row = tid < TILE;
    const int lane = tid & (TILE - 1);
    const int idx = (row ? i0 : j0) + lane;
    float* g = row ? s1[lane] : s2[lane];
    if (idx < (row ? N : M)) {
      const float* src = row ? boxes1 + ((size_t)b * N + idx) * 5
                             : boxes2 + ((size_t)b * M + idx) * 5;
      box_geometry(src, g);
    } else {
      for (int k = 0; k < GEOM; ++k) g[k] = 0.f;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
    // a warp holds one row r and its 32 columns c
    const int r = idx / TILE, c = idx % TILE;
    const int gi = i0 + r, gj = j0 + c;
    if (MASK) {
      if (gi >= N) continue;  // uniform across the warp
      bool bit = gj > gi && gj < N;
      if (groups1 != nullptr)
        bit = bit && gs[0][r] == gs[1][c] && gs[0][r] < INERT_GROUP;
      if (bit) {
        float q1[GEOM], q2[GEOM];
#pragma unroll
        for (int k = 0; k < GEOM; ++k) {
          q1[k] = s1[r][k];
          q2[k] = s2[c][k];
        }
        bit = pair_iou(q1, q2) > thr;
      }
      const unsigned word = __ballot_sync(0xffffffffu, bit);
      if (c == 0) mb[(size_t)gi * W + bj] = word;
      continue;
    }
    if (gi >= N || gj >= M) continue;
    float q1[GEOM], q2[GEOM];
#pragma unroll
    for (int k = 0; k < GEOM; ++k) {
      q1[k] = s1[r][k];
      q2[k] = s2[c][k];
    }
    ob[(size_t)gi * M + gj] = pair_iou(q1, q2);
  }
}

}  // namespace

// groups1 == groups2 == nullptr: every tile (on or above the diagonal, with
// triu) is computed.
extern "C" int sm3det_rotated_iou(const float* boxes1, const float* boxes2,
                                  const int* groups1, const int* groups2,
                                  float* out, int B, int N, int M, int triu,
                                  cudaStream_t stream) {
  if ((groups1 == nullptr) != (groups2 == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + TILE - 1) / TILE, (N + TILE - 1) / TILE, B);
  rotated_iou_kernel<false><<<grid, THREADS, 0, stream>>>(
      boxes1, boxes2, groups1, groups2, out, N, M, triu, 0.f);
  return (int)cudaGetLastError();
}

// boxes (B, N, 5) fp32; groups (B, N) int32 ascending, or nullptr (not
// banded); out (B, N, ceil(N / 32)) words
extern "C" int sm3det_rotated_nms_mask(const float* boxes, const int* groups,
                                       unsigned* out, int B, int N, float thr,
                                       cudaStream_t stream) {
  const int W = (N + TILE - 1) / TILE;
  dim3 grid(W, W, B);
  rotated_iou_kernel<true><<<grid, THREADS, 0, stream>>>(
      boxes, boxes, groups, groups, out, N, N, 1, thr);
  return (int)cudaGetLastError();
}
