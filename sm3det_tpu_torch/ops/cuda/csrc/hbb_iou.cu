// Pairwise IoU of axis-aligned boxes (xyxy), batched over images.
//
// Replaces: sm3det_tpu/ops/pallas/hbb_iou_kernel.py::_hbb_block_kernel
//   (hbb_iou_pallas), the suppression matrix of the GFL NMS.
//
// Contract: mmdet bbox_overlaps in iou mode, inter / max(union, eps),
// evaluated as (x2-x1)*(y2-y1) areas, clamped intersection widths and
// union = area1 + area2 - inter, each operation rounded on its own (no
// fused multiply-add), so the result equals the PyTorch formulation bit
// for bit. With triu, every 128x128 tile strictly below the diagonal of
// tiles is written as zeros without being computed: the greedy NMS reads
// only the strict upper triangle of the score-ordered matrix.
//
// Bound on the H100: device memory, the N*M fp32 output write (16 MB per
// image at N = M = 2000); ~12 flops per output element, so the bound is
// the output bytes over 3.35 TB/s.
//
// Design: one block per 128x128 output tile and image (grid z = image, so
// the 8 images of a batch are one launch). The tile's 2 x 128 boxes are
// staged in shared memory; consecutive threads write consecutive columns,
// so the stores, the only traffic that matters, are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;
constexpr int THREADS = 256;

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
    const float ax1 = s1[0][r], ay1 = s1[1][r], ax2 = s1[2][r],
                ay2 = s1[3][r];
    const float bx1 = s2[0][c], by1 = s2[1][c], bx2 = s2[2][c],
                by2 = s2[3][c];
    const float area1 = __fmul_rn(__fsub_rn(ax2, ax1), __fsub_rn(ay2, ay1));
    const float area2 = __fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1));
    const float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(area1, area2), inter);
    ob[(size_t)gi * M + gj] = __fdiv_rn(inter, fmaxf(uni, eps));
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
