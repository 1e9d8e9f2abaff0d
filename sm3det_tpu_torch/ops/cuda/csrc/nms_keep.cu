// Greedy NMS keep decisions from packed suppression bits, one block per
// image.
//
// Replaces: no Pallas kernel. It is the port's counterpart of the jnp
//   greedy_keep (sm3det_tpu/ops/nms.py:135), which resolves the keeps by
//   a scan of fixpoint sweeps; in the port those sweeps checked their
//   convergence on the host after each one.
//
// Contract: mask (B, N, W) 32-bit words from the IoU kernels' mask mode
// (bit j % 32 of word j / 32 of row i: box i, earlier in score order,
// suppresses box j; only bits j > i are read), eligible (B, N) bytes,
// keep (B, N) bytes. keep[i] = eligible[i] and no kept j < i suppresses i:
// exactly sequential greedy NMS. It walks every box: it does not stop
// after max_out keeps, because the grouped rotated NMS walks its boxes
// group-major, where the first max_out keeps are not the first in score
// order.
//
// Bound on the H100: the walk is serial. The bytes (row i's words from its
// diagonal word i / 32 rightwards, about half of N * W * 4, in) and the
// work (an OR of each kept row's words) are small; the latency of the
// chain of 32-box steps sets the time.
//
// Design: the removed bitmap (W words) lives in shared memory, initialised
// from ~eligible. The boxes go in steps of 32, one word column c: every
// warp reads the 32 rows' diagonal words (word c), a row a lane, and
// resolves the step's 32 decisions against removed[c] by a fixpoint of
// warp-wide ORs (the same result in every warp, so no barrier hands it
// on). Then the kept rows' words right of c are ORed into removed, one
// word a thread. The 32 rows of step c + 1 are copied into shared memory by
// cp.async while step c runs (two buffers), so the serial walk reads
// shared memory only; one barrier a step. Rows too wide for two buffers
// in shared memory (N > ~28,000) are read from device memory instead.

#include <cuda_runtime.h>

#include "device_cache.cuh"

namespace {

constexpr int THREADS = 256;  // 32 rows x 8 threads when staging
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ void copy4(unsigned* dst, const unsigned* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows 32 c .. 32 c + 31 of one image, words c .. W - 1, into dst (32 x W):
// eight threads a row
__device__ __forceinline__ void stage_step(unsigned* dst,
                                           const unsigned* rows, int c,
                                           int N, int W) {
  const int r = threadIdx.x / 8;
  if (32 * c + r < N)
    for (int w = c + threadIdx.x % 8; w < W; w += 8)
      copy4(dst + r * W + w, rows + (size_t)r * W + w);
  copy_commit();
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const unsigned* __restrict__ mask,
                const unsigned char* __restrict__ eligible,
                unsigned char* __restrict__ keep, int N, int W) {
  extern __shared__ unsigned smem[];
  unsigned* removed = smem;                 // W words
  unsigned* stage = smem + ((W + 3) & ~3);  // 2 x 32 x W words, if STAGED
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
  const unsigned* mb = mask + (size_t)b * N * W;
  const unsigned char* eb = eligible + (size_t)b * N;
  unsigned char* kb = keep + (size_t)b * N;

  for (int w = tid; w < W; w += THREADS) {
    unsigned gone = 0u;
    for (int k = 0; k < 32; ++k) {
      const int j = 32 * w + k;
      if (j >= N || !eb[j]) gone |= 1u << k;
    }
    removed[w] = gone;
  }
  if (STAGED) stage_step(stage, mb, 0, N, W);

  for (int c = 0; c < W; ++c) {
    const unsigned* rows;  // row r of step c, word w: rows[r * W + w]
    if (STAGED) {
      copy_wait_all();
      rows = stage + (c & 1) * 32 * W;
    } else {
      rows = mb + (size_t)32 * c * W;
    }
    // step c's rows have landed; removed[c] holds every earlier step's
    // suppression; nobody reads the other buffer any more
    __syncthreads();
    if (STAGED && c + 1 < W)
      stage_step(stage + ((c + 1) & 1) * 32 * W, mb + (size_t)32 * (c + 1) * W,
                 c + 1, N, W);

    // lane k holds row 32 c + k's bits right of k in word c; the step's
    // keeps are the fixpoint of kept = ~removed[c] & ~(what kept rows
    // suppress): after round t the first t decisions are exact, so it
    // ends within 33 rounds, and in a few where few boxes chain
    const unsigned diag = 32 * c + lane < N
        ? rows[lane * W + c] & (0xfffffffeu << lane) : 0u;
    const unsigned live = ~removed[c];
    unsigned kept = live, prev;
    do {
      prev = kept;
      kept = live & ~__reduce_or_sync(FULL, (kept >> lane) & 1u ? diag : 0u);
    } while (kept != prev);
    if (tid < 32 && 32 * c + tid < N) kb[32 * c + tid] = (kept >> tid) & 1u;

    if (kept)
      for (int w = c + 1 + tid; w < W; w += THREADS) {
        unsigned acc = 0u;
#pragma unroll
        for (int k = 0; k < 32; ++k)  // independent loads, in flight at once
          if ((kept >> k) & 1u) acc |= rows[k * W + w];
        removed[w] |= acc;
      }
  }
}

template <bool STAGED>
int launch(const unsigned* mask, const unsigned char* eligible,
           unsigned char* keep, int B, int N, int W, size_t smem,
           cudaStream_t stream) {
  const int err = devcache::set_smem<nms_keep_kernel<STAGED>>(smem);
  if (err != 0) return err;
  nms_keep_kernel<STAGED><<<B, THREADS, smem, stream>>>(mask, eligible, keep,
                                                        N, W);
  return (int)cudaGetLastError();
}

}  // namespace

// mask (B, N, ceil(N / 32)) words, eligible and keep (B, N) bytes (bool)
extern "C" int sm3det_nms_keep(const unsigned* mask,
                               const unsigned char* eligible,
                               unsigned char* keep, int B, int N,
                               cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const size_t removed = (size_t)((W + 3) & ~3) * 4;
  const size_t staged = removed + (size_t)2 * 32 * W * 4;
  if (staged <= MAX_SMEM)
    return launch<true>(mask, eligible, keep, B, N, W, staged, stream);
  if (removed <= MAX_SMEM)
    return launch<false>(mask, eligible, keep, B, N, W, removed, stream);
  return (int)cudaErrorInvalidValue;
}
