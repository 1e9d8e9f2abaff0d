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
// compares the result with a threshold and the assigner takes its argmax.
// Both modes call one pair function (pair_iou), or decide the pair without
// it where its result is sure to be 0 (apart, below).
//
// Matrix mode (sm3det_rotated_iou). triu: a 32 x 32 tile strictly below
// the diagonal of tiles is written as zeros, uncomputed. Banded
// (groups1/groups2 given, ascending per image): a 32 x 32 tile is computed
// only where the group ranges of its rows and of its columns overlap and
// neither side is all inert (group >= 1 << 20); other tiles are zeros.
// Rows and columns past N, M count as inert.
//
// Mask mode (sm3det_rotated_nms_mask): the self-IoU of N boxes, compared
// with thr and packed into (B, N, W) 32-bit words, W = ceil(N / 32): bit
// j % 32 of word j / 32 of row i is set iff j > i, j < N, iou(i, j) > thr
// and, banded, both groups are equal and below the inert group. Tiles
// below the diagonal or outside the band write their zero words
// uncomputed; pairs whose bit is 0 by position or group are not computed.
//
// Bound on the H100: operations. A pair that goes through pair_iou costs
// ~650 fp32 operations, 96 of them IEEE divisions (~10 instructions each),
// against 4 bytes written (the matrix) or 1 bit (the mask). Most pairs of
// the NMS and of the assigner are boxes far apart, whose IoU is 0.
//
// Sure zeros (apart): two boxes whose rectangles are separated, along one
// of their four edge normals, by more than margin = 1e-3 + 2^-16 (S_a +
// S_b) px, S = |cx| + |cy| + w + h, have inter == +0 in pair_iou, so their
// IoU is +0 (matrix mode writes 0, mask mode sets the bit iff 0 > thr),
// with no clipping at all. It applies to regular boxes only: finite, |theta|
// <= 1e3, w >= 2^-15 S and h >= 2^-15 S (w, h > 0). The argument, u =
// 2^-24:
//  1. The computed corners (box_geometry) lie within 6u S of the ideal
//     rectangle's (cosf/sinf within 2 ulp, each add/multiply within u of
//     its result), so a computed edge e has |e| >= 2^-15 S (1 - 2^-8) and
//     turns by at most phi <= 13u S / |e| < 0.026 rad from the ideal edge;
//     the computed quad's corner angles are within 2 phi of 90 degrees.
//     The separation test itself (apart) is off by at most 8u (S_a + S_b),
//     so the ideal rectangles are at least D >= 1e-3 + 248u (S_a + S_b)
//     apart, and every point of one quad's edges is at Euclidean distance
//     >= D - 12u S from the other quad.
//  2. A point P at distance D' from a convex quad whose corner angles are
//     within 0.052 rad of 90 degrees has, for some edge k, signed outward
//     distance >= D' cos(pi/4 + 0.026) >= 0.689 D' from edge k's line
//     (nearest point on edge k: D'; at a corner: P lies in its normal
//     cone, at most pi/2 + 0.052 wide). Edge k's computed half-plane value
//     a0 + t b0 (a0, b0 as clip_contrib rounds them, read as reals) is that
//     distance, sign flipped, plus eps_inside, within 25u S + 0.026 D'
//     (the corner offsets, the turn phi over |P - o_k| <= D' + |e|, and
//     the rounding of A, B and the divisions by el). So a0 + t b0 <=
//     -0.663 D' + 25u S + 1e-4 < -1e-8 for every point of the edge being
//     clipped, for some k depending on t.
//  3. clip_contrib: a k with |b0| <= 1e-8 and a0 >= 0 has a0 + t b0 >=
//     -1e-8 on [0, 1], so it excludes no t; one with |b0| <= 1e-8 and a0 <
//     0 makes the edge invalid. Otherwise every t in [0, 1] is excluded by
//     some k with |b0| > 1e-8, so the real interval [max(0, -a0/b0 : b0 >
//     0), min(1, -a0/b0 : b0 < 0)] is empty; rounding is monotone, so the
//     rounded bounds have t_hi <= t_lo, and `t_hi > t_lo` is false. Every
//     edge of both quads adds nothing: inter = max(+0 + +0, 0) = +0, and
//     iou = +0 / max(union, 1e-8) or 0, +0 either way.
// Irregular boxes (no size, tiny against their coordinates, not finite)
// and pairs closer than the margin go through pair_iou.
//
// The band (mask mode, built only with SM3DET_ROTATED_IOU_BAND=1, by
// tools/profiling/torch_rotated_iou_band.py, which times it against this
// kernel: slower on every input measured, PERF.md section 6, so the
// shipped kernel clips every pair that is not apart). fast_decide decides
// a pair of regular boxes with S <= 2^30 that is not apart, at a thr that
// is a positive normal float, with no IEEE division where the decision is
// sure, and pair_iou runs only where it is not. Below, E is pair_iou's
// arithmetic, F fast_decide's and R the real-number value of pair_iou's
// formulas on the same floats; P + t d is an edge of s clipped to c, O_k +
// t e_k with length el the edges of c, eps = +-1e-4 the shift.
//  1. Shared terms. F computes A = e_k x (P - O_k) and B = e_k x d with
//     clip_contrib's own operations, so E and F hold the same floats, and
//     they read the same corners, edges, el and areas. E rounds a0 =
//     fl(fl(A / el) + eps), b0 = fl(B / el) and tc = fl(-a0 / b0); in R,
//     tc = -(A + eps el) / B.
//  2. The branches, taken by F only where E's is sure: |b0| < EPS where
//     |B| < fl(EPS el) (1 - 2^-20) (then |B / el| < EPS (1 - 13u), and so
//     is its rounding); |b0| > EPS, with the sign of B, where |B| >
//     fl(EPS el) (1 + 2^-20). A degenerate k empties the edge (a0 < 0) iff
//     fl(A / el) < -eps: sure where A < T - |T| 2^-20 (empty) or A > T +
//     |T| 2^-20 (not), T = fl(-eps el). The shifted half-planes of a
//     shared edge (A / el ~ 0 against -eps) are decided here, by the same
//     A as E's. Otherwise F is unsure.
//  3. A candidate tc (non-degenerate): E's is within 4.01u (|A| + |eps|
//     el) / |B| of R's (the divisions and the add, each within u of its
//     result: the A / el term is why |A| and not |A + eps el|); F's, fl(
//     -fma(eps, el, A) * r) with r = __fdividef(1, B) within 2 ulp (4u),
//     within 6.01u |tc|. So |tc_F - tc_E| <= e = 2^-20 (|A| + |eps| el) /
//     |B| (16u; e's own rounding, ~6u of it, fits the slack).
//  4. max / min. E and F both take t_lo = max(0, tc : b0 > EPS) and t_hi =
//     min(1, tc : b0 < -EPS); an emptied edge stays empty in both. A
//     candidate with tc_F + e <= 0 is <= 0 in both and moves no t_lo (tc_F
//     - e >= 1: no t_hi; rounded up and down); over the rest a max or min
//     moves by at most their largest e, e_lo or e_hi. Where t_lo,F - e_lo
//     >= t_hi,F + e_hi, the edge adds nothing in E, F or R.
//  5. The sums. In R an edge adds 0.5 max(t_hi - t_lo, 0) K, K = P x d,
//     which is continuous in the ts (t_hi = t_lo adds 0 from either side),
//     so F's ts move it by <= 0.5 |K| (e_lo + e_hi). E rounds P + t d, the
//     two products and their difference: an edge it adds (t in [0, 1]) is
//     within 6.01u X Y of R's, X = |P_x| + |d_x|, Y = |P_y| + |d_y|, and
//     its seven additions move the sum by <= 7.01u sum X Y; F's edges and
//     their fma's by <= 5.6u sum X Y. So |sum_E - sum_F| <= delta =
//     (2^-19 (N_1 + N_2) + 0.5 sum |K| (e_lo + e_hi)) (1 + 2^-16), N = sum
//     of X Y over a box's edges: 32u against the 18.7u needed (its own
//     rounding fits the slack).
//  6. The quotient. inter_E = max(sum_E, 0) lies in [i_lo, i_hi] =
//     [max(sum_F - delta, 0), max(sum_F + delta, 0)] (rounded down, up).
//     E's iou = fl(i / fl(s - i)), s = fl(a_1 + a_2), does not decrease in
//     i while fl(s - i_hi) > EPS, which also makes E's union > EPS. So iou_E
//     > thr where iou_above_sure finds fl(i_lo / fl(s - i_lo)) > thr, and
//     iou_E <= thr where it finds fl(i_hi / fl(s - i_hi)) <= thr (i_hi = 0:
//     iou_E = 0). Otherwise F is unsure.
// Large coordinates: under the multi-class NMS's class offsets (S to ~1e5
// px, where the shoelace sum of a small box is rounding noise) N ~ S^2
// and delta reaches the boxes' areas; only pair_iou can say what E's sum
// is there. Phase 1 sends a pair to pair_iou directly where 2^-19 (N_1 +
// N_2) alone leaves no room for a decision. Why the band loses on the
// H100: an IEEE division's common path is a few instructions, about what
// the band spends on its bounds and margins, and at the class offsets of
// the multi-class NMS (its main input) almost no pair is left to it.
//
// Design: nothing of the TPU layout is kept (no (5, N) transpose, no
// 128-lane tiles). A block owns ROWS (32, 16 or 8) rows and 32 columns of
// one image (grid z); the 32 x 32 tile rules above are the kernel's
// either way. Its first threads turn the block's boxes into corners, edge
// vectors, edge lengths, area, N and the separation test's terms once,
// into shared memory, so sinf, cosf and sqrtf run per box and not per
// pair. Phase 1: every pair gets a thread (a warp a row, four pairs a
// thread at 32 rows), which writes the zeros it can decide (apart) and
// queues the rest in shared memory. Phase 2: the queued pairs, one a
// thread, packed, through pair_iou, so a warp's 32 lanes all clip. With
// the band, phase 1 queues the pairs it may decide apart; phase 2 takes
// them through fast_decide where a block has more than BAND_MIN_PAIRS of
// them (fewer take a round or two of pair_iou's latency, which the band
// does not shorten) and phase 3 clips those it leaves unsure. The matrix
// mode takes ROWS = 16 or 8 where 32-row blocks would not fill the card
// (the assigner's (2016, 16) per image); the mask mode builds a row's word
// from a ballot of its phase-1 bits and the later phases' bits (shared
// atomicOr).

#include <cuda_runtime.h>

#include "device_cache.cuh"
#include "exact_math.cuh"

#ifndef SM3DET_ROTATED_IOU_BAND
#define SM3DET_ROTATED_IOU_BAND 0
#endif

namespace {

constexpr bool BAND = SM3DET_ROTATED_IOU_BAND != 0;

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int GEOM = 21;  // 4 corners (x, y), 4 edges (x, y), 4 lengths, area
// cx, cy, cos, sin, w / 2, h / 2, S (< 0: irregular), N (the band's)
constexpr int SEP = 8;
constexpr float EPS = 1e-8f;
constexpr int INERT_GROUP = 1 << 20;
constexpr float BAND_MAX_S = 0x1p30f;  // S of the boxes fast_decide takes
constexpr int UNSURE = -1;
constexpr int BAND_MIN_PAIRS = 2 * THREADS;  // a block's band pairs, at least

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

// clip_contrib without IEEE division (band steps 1-5): adds F's
// contributions of s's edges into sum and |K| (e_lo + e_hi) of each into
// lip; false where a branch of clip_contrib is not sure.
__device__ __forceinline__ bool clip_fast(const float* __restrict__ s,
                                          const float* __restrict__ c,
                                          float eps_inside, float& sum,
                                          float& lip) {
  using namespace exact;
  const float aeps = fabsf(eps_inside);
  float cq[20];  // c's corners, edges and lengths, read once
#pragma unroll
  for (int k = 0; k < 20; ++k) cq[k] = c[k];
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const float px = s[i], py = s[4 + i], dx = s[8 + i], dy = s[12 + i];
    float t_lo = 0.f, t_hi = 1.f, e_lo = 0.f, e_hi = 0.f;
    bool empty = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float ox = cq[k], oy = cq[4 + k];
      const float ex = cq[8 + k], ey = cq[12 + k], el = cq[16 + k];
      const float A = sub(mul(ex, sub(py, oy)), mul(ey, sub(px, ox)));
      const float B = sub(mul(ex, dy), mul(ey, dx));
      const float lim = mul(EPS, el), aB = fabsf(B);
      if (aB < lim * (1.f - 0x1p-20f)) {           // |b0| < EPS
        const float T = mul(-eps_inside, el);      // a0 < 0 iff A < ~T
        const float m = fabsf(T) * 0x1p-20f;
        if (A < T - m)
          empty = true;
        else if (!(A > T + m))
          return false;
      } else if (aB > lim * (1.f + 0x1p-20f)) {    // |b0| > EPS
        const float r = __fdividef(1.f, B);
        const float t = -fmaf(eps_inside, el, A) * r;
        const float e = fmaf(aeps, el, fabsf(A)) * fabsf(r) * 0x1p-20f;
        if (B > 0.f) {
          if (__fadd_ru(t, e) > 0.f) {
            t_lo = fmaxf(t_lo, t);
            e_lo = fmaxf(e_lo, e);
          }
        } else if (__fsub_rd(t, e) < 1.f) {
          t_hi = fminf(t_hi, t);
          e_hi = fmaxf(e_hi, e);
        }
      } else {
        return false;
      }
    }
    if (empty || __fsub_rd(t_lo, e_lo) >= __fadd_ru(t_hi, e_hi)) continue;
    const float K = fmaf(px, dy, -(py * dx));
    sum = fmaf(0.5f * fmaxf(t_hi - t_lo, 0.f), K, sum);
    lip = fmaf(fabsf(K), e_lo + e_hi, lip);
  }
  return true;
}

// 1 if pair_iou(q1, q2) > thr, 0 if not, UNSURE where the band does not
// decide (band steps 5-6); n12 = N_1 + N_2, thr a positive normal float.
// q1, q2: geometry records in shared memory; one quad at a time is held
// in registers.
__device__ __forceinline__ int fast_decide(const float* __restrict__ q1,
                                           const float* __restrict__ q2,
                                           float n12, float thr) {
  float sum = 0.f, lip = 0.f;
  if (!clip_fast(q1, q2, 1e-4f, sum, lip) ||
      !clip_fast(q2, q1, -1e-4f, sum, lip))
    return UNSURE;
  const float delta = fmaf(0x1p-19f, n12, 0.5f * lip) * (1.f + 0x1p-16f);
  const float i_lo = fmaxf(__fsub_rd(sum, delta), 0.f);
  const float i_hi = fmaxf(__fadd_ru(sum, delta), 0.f);
  if (i_hi == 0.f) return 0;
  const float s = exact::add(q1[20], q2[20]);
  const float u_hi = exact::sub(s, i_hi);
  if (!(u_hi > EPS)) return UNSURE;
  bool unsure;
  if (exact::iou_above_sure(i_lo, exact::sub(s, i_lo), thr, true, unsure))
    return 1;
  const bool above = exact::iou_above_sure(i_hi, u_hi, thr, true, unsure);
  return unsure || above ? UNSURE : 0;
}

// The separation test's terms of one box: centre, cos, sin (as
// box_geometry takes them), half sizes and S = |cx| + |cy| + w + h, or S =
// -1 for a box the test does not apply to (see "Sure zeros" above); and
// the band's N from its geometry record g.
__device__ void sep_terms(const float* __restrict__ box, const float* g,
                          float* t) {
  const float x = box[0], y = box[1], w = box[2], h = box[3], a = box[4];
  const float S = fabsf(x) + fabsf(y) + w + h;
  const bool regular = S <= 1e30f && fabsf(a) <= 1e3f && w > 0.f &&
                       h > 0.f && w >= 0x1p-15f * S && h >= 0x1p-15f * S;
  t[0] = x;
  t[1] = y;
  t[2] = cosf(a);
  t[3] = sinf(a);
  t[4] = 0.5f * w;
  t[5] = 0.5f * h;
  t[6] = regular ? S : -1.f;
  float n = 0.f;
#pragma unroll
  for (int i = 0; BAND && i < 4; ++i)
    n += (fabsf(g[i]) + fabsf(g[8 + i])) * (fabsf(g[4 + i]) +
                                            fabsf(g[12 + i]));
  t[7] = n;
}

// Whether the two boxes are apart: separated by more than the margin along
// one of the four edge normals (a's (cos, sin) and (-sin, cos), b's).
__device__ __forceinline__ bool apart(const float* a, const float* b) {
  if (!(a[6] >= 0.f && b[6] >= 0.f)) return false;
  const float dx = b[0] - a[0], dy = b[1] - a[1];
  const float c = fabsf(a[2] * b[2] + a[3] * b[3]);  // |cos(b - a)|
  const float s = fabsf(a[3] * b[2] - a[2] * b[3]);  // |sin(b - a)|
  const float margin = 1e-3f + 0x1p-16f * (a[6] + b[6]);
  return fabsf(dx * a[2] + dy * a[3]) > a[4] + b[4] * c + b[5] * s + margin ||
         fabsf(dy * a[2] - dx * a[3]) > a[5] + b[4] * s + b[5] * c + margin ||
         fabsf(dx * b[2] + dy * b[3]) > b[4] + a[4] * c + a[5] * s + margin ||
         fabsf(dy * b[2] - dx * b[3]) > b[5] + a[4] * s + a[5] * c + margin;
}

// Whether the band may decide a pair of boxes (terms a, b, areas aa, ab)
// at thr (positive normal): both regular with S <= 2^30, and delta's first
// term (band step 5) leaves room for one of step 6's decisions.
__device__ __forceinline__ bool band_may_decide(const float* a,
                                                const float* b, float aa,
                                                float ab, float thr) {
  if (!(a[6] >= 0.f && b[6] >= 0.f && a[6] <= BAND_MAX_S &&
        b[6] <= BAND_MAX_S))
    return false;
  const float noise = 0x1p-19f * (a[7] + b[7]) * (1.f + thr);
  const float s = aa + ab;
  return noise < fmaxf(thr * s, fminf(aa, ab) * (1.f + thr) - thr * s);
}

// MASK: boxes2 is boxes1, groups2 is groups1, out holds (B, N, W) words;
// a block: rows i0 .. i0 + rows - 1 (rows divides TILE), columns j0 .. j0 +
// 31 of image b
template <bool MASK>
__global__ void __launch_bounds__(THREADS)
rotated_iou_kernel(const float* __restrict__ boxes1,
                   const float* __restrict__ boxes2,
                   const int* __restrict__ groups1,
                   const int* __restrict__ groups2, void* __restrict__ out,
                   int N, int M, int triu, float thr, int rows) {
  __shared__ float s1[TILE][GEOM];
  __shared__ float s2[TILE][GEOM];
  __shared__ float t1[TILE][SEP];
  __shared__ float t2[TILE][SEP];
  __shared__ int bounds[4];  // min, max of the row groups; of the columns
  __shared__ int gs[2][TILE];  // the row and column groups (mask mode)
  __shared__ unsigned short band_q[BAND && MASK ? TILE * TILE : 1];
  __shared__ unsigned short exact_q[TILE * TILE];
  __shared__ int n_band, n_exact, n_unsure;
  __shared__ unsigned words[TILE];
  const int bj = blockIdx.x, b = blockIdx.z;
  const int i0 = blockIdx.y * rows, j0 = bj * TILE;
  const int ti0 = i0 / TILE * TILE;        // the row tile of the rules
  const int tid = threadIdx.x;
  const int W = (N + TILE - 1) / TILE;
  float* ob = static_cast<float*>(out) + (size_t)b * N * M;
  unsigned* mb = static_cast<unsigned*>(out) + (size_t)b * N * W;

  bool need = !(triu && bj < i0 / TILE);
  if (need && groups1 != nullptr) {
    // the first warp reduces the row tile's groups, the second the columns'
    if (tid < 2 * TILE) {
      const bool row = tid < TILE;
      const int lane = tid & (TILE - 1);
      const int idx = (row ? ti0 : j0) + lane;
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
      if (tid < rows && i0 + tid < N) mb[(size_t)(i0 + tid) * W + bj] = 0u;
      return;
    }
    for (int idx = tid; idx < rows * TILE; idx += THREADS) {
      const int gi = i0 + idx / TILE, gj = j0 + idx % TILE;
      if (gi < N && gj < M) ob[(size_t)gi * M + gj] = 0.f;
    }
    return;
  }

  if (tid < rows + TILE) {
    const bool row = tid < rows;
    const int lane = row ? tid : tid - rows;
    const int idx = (row ? i0 : j0) + lane;
    float* g = row ? s1[lane] : s2[lane];
    float* t = row ? t1[lane] : t2[lane];
    if (idx < (row ? N : M)) {
      const float* src = row ? boxes1 + ((size_t)b * N + idx) * 5
                             : boxes2 + ((size_t)b * M + idx) * 5;
      box_geometry(src, g);
      sep_terms(src, g, t);
    } else {
      for (int k = 0; k < GEOM; ++k) g[k] = 0.f;
      for (int k = 0; k < SEP; ++k) t[k] = 0.f;
      t[6] = -1.f;
    }
  }
  if (tid == 0) {
    n_band = 0;
    n_exact = 0;
    n_unsure = 0;
  }
  __syncthreads();

  // phase 1: a warp a row, its 32 columns; sure zeros now, the rest queued
  const bool zero_bit = 0.f > thr;
  const bool thr_normal = thr >= 0x1p-126f && thr <= 1e30f;
  for (int idx = tid; idx < rows * TILE; idx += THREADS) {
    const int r = idx / TILE, c = idx % TILE;
    const int gi = i0 + r, gj = j0 + c;
    if (MASK) {
      if (gi >= N) continue;  // uniform across the warp
      bool want = gj > gi && gj < N;
      const int rg = i0 - ti0 + r;
      if (groups1 != nullptr)
        want = want && gs[0][rg] == gs[1][c] && gs[0][rg] < INERT_GROUP;
      const bool sure = want && apart(t1[r], t2[c]);
      if (want && !sure) {
        if (BAND && thr_normal &&
            band_may_decide(t1[r], t2[c], s1[r][20], s2[c][20], thr))
          band_q[atomicAdd(&n_band, 1)] = (unsigned short)idx;
        else
          exact_q[atomicAdd(&n_exact, 1)] = (unsigned short)idx;
      }
      const unsigned word = __ballot_sync(0xffffffffu, sure && zero_bit);
      if (c == 0) words[r] = word;
      continue;
    }
    if (gi >= N || gj >= M) continue;
    if (apart(t1[r], t2[c]))
      ob[(size_t)gi * M + gj] = 0.f;
    else
      exact_q[atomicAdd(&n_exact, 1)] = (unsigned short)idx;
  }
  __syncthreads();

  // phase 2: the queued pairs, one a thread, packed, through pair_iou;
  // with the band, its queue after pair_iou's, through fast_decide where
  // the block has more than BAND_MIN_PAIRS of them, the pairs it leaves
  // unsure queued after pair_iou's
  const int n_b = BAND && MASK ? n_band : 0, n_e = n_exact;
  const bool band = n_b > BAND_MIN_PAIRS;
  auto exact_pair = [&](int idx) {
    const int r = idx / TILE, c = idx % TILE;
    float q1[GEOM], q2[GEOM];
#pragma unroll
    for (int k = 0; k < GEOM; ++k) {
      q1[k] = s1[r][k];
      q2[k] = s2[c][k];
    }
    const float iou = pair_iou(q1, q2);
    if (MASK) {
      if (iou > thr) atomicOr(&words[r], 1u << c);
    } else {
      ob[(size_t)(i0 + r) * M + j0 + c] = iou;
    }
  };
  for (int q = tid; q < n_e + n_b; q += THREADS) {
    const int idx = q < n_e ? exact_q[q] : band_q[q - n_e];
    if (band && q >= n_e) {
      const int r = idx / TILE, c = idx % TILE;
      const int d = fast_decide(s1[r], s2[c], t1[r][7] + t2[c][7], thr);
      if (d == UNSURE)
        exact_q[n_e + atomicAdd(&n_unsure, 1)] = (unsigned short)idx;
      else if (d)
        atomicOr(&words[r], 1u << c);
      continue;
    }
    exact_pair(idx);
  }
  // phase 3: the pairs the band left unsure
  if (band) {
    __syncthreads();
    const int n_u = n_unsure;
    for (int q = tid; q < n_u; q += THREADS) exact_pair(exact_q[n_e + q]);
  }
  if (MASK) {
    __syncthreads();
    if (tid < rows && i0 + tid < N) mb[(size_t)(i0 + tid) * W + bj] =
        words[tid];
  }
}

}  // namespace

// groups1 == groups2 == nullptr: every tile (on or above the diagonal, with
// triu) is computed. Blocks of 32 rows, or 16 or 8 where fewer than two
// blocks an SM would run.
extern "C" int sm3det_rotated_iou(const float* boxes1, const float* boxes2,
                                  const int* groups1, const int* groups2,
                                  float* out, int B, int N, int M, int triu,
                                  cudaStream_t stream) {
  if ((groups1 == nullptr) != (groups2 == nullptr))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = devcache::once<rotated_iou_kernel<false>>(
      0, &sms, [](int dev, int* v) {
        return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount,
                                      dev);
      });
  if (err != 0) return err;
  const long long col_tiles = (M + TILE - 1) / TILE;
  int rows = TILE;
  while (rows > 8 &&
         (long long)B * col_tiles * ((N + rows - 1) / rows) < 2LL * sms)
    rows /= 2;
  dim3 grid((M + TILE - 1) / TILE, (N + rows - 1) / rows, B);
  rotated_iou_kernel<false><<<grid, THREADS, 0, stream>>>(
      boxes1, boxes2, groups1, groups2, out, N, M, triu, 0.f, rows);
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
      boxes, boxes, groups, groups, out, N, N, 1, thr, TILE);
  return (int)cudaGetLastError();
}
