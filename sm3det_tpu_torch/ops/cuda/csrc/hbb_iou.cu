// Pairwise IoU of axis-aligned boxes (xyxy), batched over images: as a
// matrix, or as the packed suppression bits of greedy NMS.
//
// Replaces: sm3det_tpu/ops/pallas/hbb_iou_kernel.py::_hbb_block_kernel
//   (hbb_iou_pallas), the suppression matrix of the GFL and RPN NMS.
//
// Contract: mmdet bbox_overlaps in iou mode, inter / max(union, eps),
// evaluated as (x2-x1)*(y2-y1) areas, clamped intersection widths and
// union = area1 + area2 - inter, each operation rounded on its own (no
// fused multiply-add), so the result equals the PyTorch formulation bit
// for bit. Both modes take inter and max(union, eps) from one device
// function (pair_terms); the matrix mode divides, the mask mode decides
// iou > thr exactly as the rounded quotient would (iou_above_sure in
// exact_math.cuh).
//
// Matrix mode (sm3det_hbb_iou): (B, N, M) fp32. With triu, every 128x128
// tile strictly below the diagonal of tiles is written as zeros without
// being computed. Bound on the H100: the output write (16 MB an image at
// N = M = 2000) over 3.35 TB/s.
//
// Mask mode (sm3det_hbb_nms_mask): the self-IoU of N score-ordered boxes,
// compared with thr in registers and packed into (B, N, W) 32-bit words,
// W = ceil(N / 32): bit j % 32 of word j / 32 of row i is set iff j > i,
// j < N and iou(i, j) > thr. Words wholly at or below the diagonal are
// written as 0 uncomputed. The output is 32x smaller than the matrix
// (0.5 MB an image at N = 2000), so the ~12 operations of each
// upper-triangle pair bound it (fp32 rate), not the bytes.
//
// Design, matrix mode: one block per 128x128 output tile and image (grid
// z = image). The tile's 2 x 128 boxes are staged in shared memory;
// consecutive threads write consecutive columns, so the stores are
// coalesced.
//
// Design, mask mode: a thread owns a row; a block of 64 rows spans 8
// words (256 columns) of one image, whose boxes and areas are staged once
// in shared memory and read as broadcasts (every thread reads the same
// column at once). A thread builds its 8 words bit by bit from 32
// independent pairs a word, in registers, with no division and no branch:
// the quotient is needed only within 2^-21 of thr (iou_above_sure), and
// those rare pairs are divided after the word's 32. The words go through
// shared memory, so each row's 32 bytes leave in one coalesced store.

#include <cuda_runtime.h>

#include "exact_math.cuh"

namespace {

constexpr int BLK = 128;
constexpr int THREADS = 256;

constexpr int MASK_ROWS = 64;   // rows (threads) of a mask block
constexpr int MASK_WORDS = 8;   // words of a mask block's column span

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// inter and max(union, eps) of one pair, given both areas
__device__ __forceinline__ void pair_terms(float ax1, float ay1, float ax2,
                                           float ay2, float area1, float bx1,
                                           float by1, float bx2, float by2,
                                           float area2, float eps,
                                           float& inter, float& uni) {
  const float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.f);
  inter = __fmul_rn(iw, ih);
  uni = fmaxf(__fsub_rn(__fadd_rn(area1, area2), inter), eps);
}

__global__ void __launch_bounds__(THREADS)
hbb_iou_kernel(const float* __restrict__ boxes1,
               const float* __restrict__ boxes2, float* __restrict__ out,
               int N, int M, int triu, float eps) {
  __shared__ float s1[4][BLK];
  __shared__ float s2[4][BLK];
  const int bi = blockIdx.y, bj = blockIdx.x, b = blockIdx.z;
  const int i0 = bi * BLK, j0 = bj * BLK;
  const int tid = threadIdx.x;
  float* ob = out + (size_t)b * N * M;

  if (triu && bj < bi) {
    for (int idx = tid; idx < BLK * BLK; idx += THREADS) {
      const int gi = i0 + idx / BLK, gj = j0 + idx % BLK;
      if (gi < N && gj < M) ob[(size_t)gi * M + gj] = 0.f;
    }
    return;
  }

  const float* b1 = boxes1 + (size_t)b * N * 4;
  const float* b2 = boxes2 + (size_t)b * M * 4;
  for (int idx = tid; idx < 4 * BLK; idx += THREADS) {
    const int r = idx / 4, c = idx % 4;
    s1[c][r] = i0 + r < N ? b1[(size_t)(i0 + r) * 4 + c] : 0.f;
    s2[c][r] = j0 + r < M ? b2[(size_t)(j0 + r) * 4 + c] : 0.f;
  }
  __syncthreads();

  for (int idx = tid; idx < BLK * BLK; idx += THREADS) {
    const int r = idx / BLK, c = idx % BLK;
    const int gi = i0 + r, gj = j0 + c;
    if (gi >= N || gj >= M) continue;
    float inter, uni;
    pair_terms(s1[0][r], s1[1][r], s1[2][r], s1[3][r],
               box_area(s1[0][r], s1[1][r], s1[2][r], s1[3][r]), s2[0][c],
               s2[1][c], s2[2][c], s2[3][c],
               box_area(s2[0][c], s2[1][c], s2[2][c], s2[3][c]), eps, inter,
               uni);
    ob[(size_t)gi * M + gj] = __fdiv_rn(inter, uni);
  }
}

__global__ void __launch_bounds__(MASK_ROWS)
hbb_nms_mask_kernel(const float4* __restrict__ boxes,
                    unsigned* __restrict__ out, int N, int W, float thr,
                    float eps) {
  __shared__ float4 cols[MASK_WORDS * 32];
  __shared__ float areas[MASK_WORDS * 32];
  __shared__ unsigned words[MASK_ROWS][MASK_WORDS + 1];
  const int b = blockIdx.z, tid = threadIdx.x;
  const int i0 = blockIdx.y * MASK_ROWS, w0 = blockIdx.x * MASK_WORDS;
  const int i = i0 + tid;
  const int nw = min(MASK_WORDS, W - w0);  // words of this span
  const bool thr_normal = thr >= 0x1p-126f && thr <= 1e30f;
  const float4* bx = boxes + (size_t)b * N;
  unsigned* ob = out + (size_t)b * N * W;

  // every column of the span at or left of every row: all words are 0
  const bool zero = min((w0 + MASK_WORDS) * 32, N) - 1 <= i0;
  if (!zero) {
    for (int t = tid; t < MASK_WORDS * 32; t += MASK_ROWS) {
      const int j = w0 * 32 + t;
      const float4 c = j < N ? bx[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      cols[t] = c;
      areas[t] = box_area(c.x, c.y, c.z, c.w);
    }
  }
  __syncthreads();

  if (i < N) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float area = 0.f;
    if (!zero) {
      a = bx[i];
      area = box_area(a.x, a.y, a.z, a.w);
    }
#pragma unroll
    for (int w = 0; w < MASK_WORDS; ++w) {
      const int j0 = (w0 + w) * 32;
      unsigned word = 0u;
      if (!zero && w < nw && j0 + 31 > i) {
        // columns j <= i or j >= N give no bit; both only in edge words
        const unsigned valid =
            (j0 > i ? 0xffffffffu : 0xfffffffeu << (i - j0)) &
            (N - j0 >= 32 ? 0xffffffffu : (1u << (N - j0)) - 1u);
        unsigned unsure = 0u;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float4 c = cols[w * 32 + k];
          float inter, uni;
          pair_terms(a.x, a.y, a.z, a.w, area, c.x, c.y, c.z, c.w,
                     areas[w * 32 + k], eps, inter, uni);
          bool u;
          word |= (unsigned)exact::iou_above_sure(inter, uni, thr,
                                                   thr_normal, u)
                  << k;
          unsure |= (unsigned)u << k;
        }
        // the pairs within 2^-21 of thr (rare): the rounded quotient
        for (unsigned m = unsure & valid; m; m &= m - 1) {
          const int k = __ffs(m) - 1;
          const float4 c = cols[w * 32 + k];
          float inter, uni;
          pair_terms(a.x, a.y, a.z, a.w, area, c.x, c.y, c.z, c.w,
                     areas[w * 32 + k], eps, inter, uni);
          if (__fdiv_rn(inter, uni) > thr) word |= 1u << k;
        }
        word &= valid;
      }
      words[tid][w] = word;
    }
  }
  __syncthreads();

  // row r's nw words are consecutive in device memory: consecutive
  // threads write consecutive words
  for (int t = tid; t < MASK_ROWS * MASK_WORDS; t += MASK_ROWS) {
    const int r = t / MASK_WORDS, w = t % MASK_WORDS;
    if (i0 + r < N && w < nw) ob[(size_t)(i0 + r) * W + w0 + w] = words[r][w];
  }
}

}  // namespace

extern "C" int sm3det_hbb_iou(const float* boxes1, const float* boxes2,
                              float* out, int B, int N, int M, int triu,
                              float eps, cudaStream_t stream) {
  dim3 grid((M + BLK - 1) / BLK, (N + BLK - 1) / BLK, B);
  hbb_iou_kernel<<<grid, THREADS, 0, stream>>>(boxes1, boxes2, out, N, M,
                                               triu, eps);
  return (int)cudaGetLastError();
}

// boxes (B, N, 4) fp32, 16-byte aligned; out (B, N, ceil(N / 32)) words
extern "C" int sm3det_hbb_nms_mask(const float* boxes, unsigned* out, int B,
                                   int N, float thr, float eps,
                                   cudaStream_t stream) {
  const int W = (N + 31) / 32;
  dim3 grid((W + MASK_WORDS - 1) / MASK_WORDS,
            (N + MASK_ROWS - 1) / MASK_ROWS, B);
  hbb_nms_mask_kernel<<<grid, MASK_ROWS, 0, stream>>>(
      reinterpret_cast<const float4*>(boxes), out, N, W, thr, eps);
  return (int)cudaGetLastError();
}
