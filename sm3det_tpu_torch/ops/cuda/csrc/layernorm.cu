// LayerNorm over the trailing (channel) axis, fp32 statistics.
//
// Replaces: sm3det_tpu/ops/pallas/convnext_block_kernel.py::fused_layernorm
//   (_ln_kernel). The JAX package leaves its own LayerNormOpt to XLA; the
//   port runs the backbone's stem, downsample and output LayerNorms
//   through this kernel.
//
// Contract (that of layernorm_math): mean and E[x^2] of the row in fp32,
// var = max(E[x^2] - mean^2, 0), y = (x - mean) * (rstd(var + eps) *
// scale) + bias in fp32, rounded once to the output type. Input fp32 or
// bf16, output fp32 or bf16, scale and bias each fp32 or bf16 (read as
// they are: a bf16 value is exact in fp32), any C <= 2048.
//
// Bound on the H100: device memory. Each element is read once and written
// once for ~8 flops, so the least time is (input + output bytes) /
// 3.35 TB/s. What matters is how many bytes are in flight.
//
// Design: a persistent grid, as many blocks of 256 threads as the card
// holds at once, each walking the chunks blockIdx.x, + gridDim.x, ... of
// x. A chunk is R whole rows, one contiguous span of ~12 KB, copied into
// shared memory by one 1-D TMA bulk copy (cp.async.bulk) that completes on
// an mbarrier; three stages, so two chunks are on their way while one is
// normalised. R is a multiple of the row groups of a block, so every
// chunk starts on a 16-byte boundary; a tail under 16 bytes at the very
// end of x is copied by the thread that starts the copy, before it
// arrives. Each row is reduced by a group of `lanes` threads sized to C
// (about four 16-byte reads a lane: 4 lanes at C = 96 in bf16, 16 at 384,
// a warp at 768), reading its vectors from shared memory, with shuffles
// for the two sums; the output goes straight to device memory in 16-byte
// stores (or 8 bytes, fp32 in and bf16 out). Scale and bias are read once
// a block, in their own dtype, into fp32 shared memory. Where a row's
// bytes are not a multiple of 16 (C odd in bf16, C % 4 != 0 in fp32) the
// same pipeline runs with scalar reads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_cache.cuh"
#include "dwconv_core.cuh"
#include "vec_io.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;
using namespace vec_io;

constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int CHUNK_BYTES = 12 * 1024;   // bytes of x a chunk aims at
constexpr int BAR_BYTES = 64;            // the stages' mbarriers

// shared memory: the mbarriers, scale and bias (fp32, C each), then the
// stages, each R rows of x rounded up to 16 bytes
__host__ __device__ inline size_t stage_offset(int C) {
  return (BAR_BYTES + 2 * (size_t)C * 4 + 127) / 128 * 128;
}
__host__ __device__ inline size_t stage_bytes(int C, int R, int esize) {
  return ((size_t)R * C * esize + 15) / 16 * 16;
}

template <typename Tin, typename Tout, bool VEC>
__global__ void __launch_bounds__(THREADS)
layernorm_kernel(const Tin* __restrict__ x, const void* __restrict__ scale,
                 const void* __restrict__ bias, Tout* __restrict__ out,
                 long long rows, int C, int R, int lanes, int param_bf16,
                 float eps) {
  constexpr int EPV = VEC ? 16 / (int)sizeof(Tin) : 1;  // elements a read
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_scale = reinterpret_cast<float*>(smem + BAR_BYTES);
  float* s_bias = s_scale + C;
  unsigned char* stages = smem + stage_offset(C);
  const size_t sbytes = stage_bytes(C, R, sizeof(Tin));

  const long long n_chunks = (rows + R - 1) / R;
  const int my_n =
      (int)((n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int tid = threadIdx.x;

  // thread 0 sends the j-th chunk of this block on its way into stage
  // j % STAGES
  auto load_chunk = [&](int j) {
    const long long r0 = (blockIdx.x + (long long)j * gridDim.x) * R;
    const long long nr = rows - r0 < R ? rows - r0 : R;
    const size_t bytes = (size_t)nr * C * sizeof(Tin);
    const uint32_t bulk = (uint32_t)(bytes & ~(size_t)15);
    unsigned char* dst = stages + (j % STAGES) * sbytes;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(x + r0 * C);
    for (size_t i = bulk; i < bytes; i += sizeof(Tin))   // end of x only
      *reinterpret_cast<Tin*>(dst + i) =
          *reinterpret_cast<const Tin*>(src + i);
    mbar_expect_tx(bars + j % STAGES, bulk);
    if (bulk) bulk_load(dst, src, bulk, bars + j % STAGES);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < C; c += THREADS) {
    s_scale[c] = (param_bf16 & 1)
                     ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(scale)[c])
                     : static_cast<const float*>(scale)[c];
    s_bias[c] = (param_bf16 & 2)
                    ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(bias)[c])
                    : static_cast<const float*>(bias)[c];
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < STAGES && j < my_n; ++j) load_chunk(j);

  const int group = tid / lanes, gl = tid % lanes;
  const int n_groups = THREADS / lanes;
  const int nv = C / EPV;
  const float inv_c = 1.f / (float)C;
  for (int j = 0; j < my_n; ++j) {
    mbar_wait(bars + j % STAGES, (uint32_t)((j / STAGES) & 1));
    const long long r0 = (blockIdx.x + (long long)j * gridDim.x) * R;
    const int nr = (int)(rows - r0 < R ? rows - r0 : R);
    const Tin* buf = reinterpret_cast<const Tin*>(stages +
                                                  (j % STAGES) * sbytes);
    // R is a multiple of n_groups: every lane runs the same trip count,
    // so the whole warp meets the shuffles
    for (int r = group; r < R; r += n_groups) {
      const bool live = r < nr;
      const Tin* row = buf + (size_t)r * C;
      float s1 = 0.f, s2 = 0.f;
      if (live) {
        for (int v = gl; v < nv; v += lanes) {
          float f[EPV];
          unpack<EPV>(row + v * EPV, f);
#pragma unroll
          for (int e = 0; e < EPV; ++e) {
            s1 += f[e];
            s2 = fmaf(f[e], f[e], s2);
          }
        }
      }
      for (int o = lanes / 2; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (!live) continue;
      const float mean = s1 * inv_c;
      const float rstd =
          rsqrtf(fmaxf(s2 * inv_c - mean * mean, 0.f) + eps);
      Tout* orow = out + (r0 + r) * C;
      for (int v = gl; v < nv; v += lanes) {
        float f[EPV], sc[EPV], sh[EPV];
        unpack<EPV>(row + v * EPV, f);
        unpack<EPV>(s_scale + v * EPV, sc);
        unpack<EPV>(s_bias + v * EPV, sh);
        float y[EPV];
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          y[e] = (f[e] - mean) * (rstd * sc[e]) + sh[e];
        pack_store<EPV>(orow + v * EPV, y);
      }
    }
    __syncthreads();             // every read of this stage is done
    if (tid == 0 && j + STAGES < my_n) load_chunk(j + STAGES);
  }
}

template <typename Tin, typename Tout, bool VEC>
int launch(const void* x, const void* scale, const void* bias, void* out,
           long long rows, int C, int param_bf16, float eps,
           cudaStream_t stream) {
  constexpr auto kern = layernorm_kernel<Tin, Tout, VEC>;
  constexpr int EPV = VEC ? 16 / (int)sizeof(Tin) : 1;
  // lanes a row: the power of two that gives each about 4 reads of 16
  // bytes, at most a warp; R: whole rows for every group, ~CHUNK_BYTES
  const int nv = C / EPV;
  int lanes = 1;
  while (lanes < 32 && lanes * 4 < nv) lanes *= 2;
  const int n_groups = THREADS / lanes;
  const long long row_bytes = (long long)C * sizeof(Tin);
  long long per = CHUNK_BYTES / (row_bytes * n_groups);
  const int R = n_groups * (int)(per < 1 ? 1 : per);
  const size_t smem = stage_offset(C) + STAGES * stage_bytes(C, R,
                                                             sizeof(Tin));
  // blocks the card holds at once with this much shared memory
  int resident = 0;
  int err = devcache::set_smem<kern>(smem);
  if (err == 0)
    err = devcache::resident_blocks<kern>(THREADS, smem, &resident);
  if (err != 0) return err;
  const long long n_chunks = (rows + R - 1) / R;
  const int blocks = (int)(n_chunks < resident ? n_chunks : resident);
  kern<<<blocks, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), scale, bias, static_cast<Tout*>(out), rows,
      C, R, lanes, param_bf16, eps);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_any(const void* x, const void* scale, const void* bias, void* out,
               long long rows, int C, int param_bf16, float eps,
               cudaStream_t stream) {
  if ((C * sizeof(Tin)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch<Tin, Tout, true>(x, scale, bias, out, rows, C, param_bf16,
                                   eps, stream);
  return launch<Tin, Tout, false>(x, scale, bias, out, rows, C, param_bf16,
                                  eps, stream);
}

}  // namespace

// x (rows, C) contiguous at a 16-byte address; param_bf16: bit 0 scale is
// bf16, bit 1 bias is bf16 (else fp32)
extern "C" int sm3det_layernorm(const void* x, const void* scale,
                                const void* bias, void* out, long long rows,
                                int C, int in_bf16, int out_bf16,
                                int param_bf16, float eps,
                                cudaStream_t stream) {
  if (C <= 0 || C > dwcore::MAX_CHANNELS || rows < 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  using bf = __nv_bfloat16;
#define SM3DET_LN(TI, TO)                                                    \
  return launch_any<TI, TO>(x, scale, bias, out, rows, C, param_bf16, eps,   \
                            stream)
  if (in_bf16 && out_bf16) SM3DET_LN(bf, bf);
  if (in_bf16) SM3DET_LN(bf, float);
  if (out_bf16) SM3DET_LN(float, bf);
  SM3DET_LN(float, float);
#undef SM3DET_LN
}
