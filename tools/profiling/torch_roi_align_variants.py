#!/usr/bin/env python3
"""Row 7's design choices timed on one CUDA card: the pyramid rotated RoI
align forward (``sm3det_tpu_torch/ops/cuda/csrc/roi_align_rotated.cu``)
against variants of itself, on the joint forward's shapes.

Run from the root of the repository on a machine with a card:

    python3 tools/profiling/torch_roi_align_variants.py [--rounds 4]
        [--iters 20] [--seed 0]

Each variant is the shipped source with one part replaced, built with the
library's nvcc flags into ``ops/cuda/_build/variants/`` (all in parallel)
and called through its own C entry:

- ``staged``: the shipped kernel (a RoI's whole footprint staged in
  shared memory by bulk copies where it fits the 32 KB stage, else its
  taps read from device memory);
- ``direct``: no stage and no footprint: the samples placed, then every
  tap read from device memory;
- ``banded``: a RoI whose footprint does not fit is walked in bands of
  bin rows, each band staged where it fits (down to one bin row, which
  reads from device memory if it does not fit either);
- ``*_l2``: the same, with the taps read from device memory sent past L1
  (``ld.global.cg``), to see what L1 does for repeated taps.

Inputs: 8 images of 800^2 at strides 4-32, C = 256 bf16, random features,
and two sets of 16000 RoIs: log-uniform synthetic RoIs of 8-720 px (as
``chip_smoke.py`` phase 3), and the proposals the joint forward's RPN
gives for [8 SAR : 4 RGB : 4 infrared] random images (the full-width
bf16 ``TriSourceDetector``, random weights from ``--seed``). Every
variant is held against the plain version (bf16: 0.0078 of the scale)
and against the shipped kernel's bits, then timed with CUDA events:
``--iters`` launches a round, ``--rounds`` rounds, the variants in
turn, their order reversed every other round. It also prints
``chip_smoke.align_read_model``'s estimate of what each RoI set reads.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

IMG = 800
STRIDES = (4, 8, 16, 32)

# the direct variant's kernel: the samples' taps as image indices, then
# the bins; no stage (STAGE_BYTES 0)
DIRECT_KERNEL = r"""template <typename T, int VE, int OUT, int SN>
__global__ void __launch_bounds__(THREADS)
roi_align_rotated_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ lvls, T* __restrict__ out,
                         int B, int C, int out_rt, int sn_rt, int max_rows) {
  const int out_size = OUT ? OUT : out_rt;
  const int sn = SN ? SN : sn_rt;
  const int per_bin = sn * sn, n_bins = out_size * out_size;
  const int n_samples = n_bins * per_bin;
  extern __shared__ __align__(16) unsigned char smem[];
  int (*s_idx)[4] = reinterpret_cast<int (*)[4]>(smem + STAGE_BYTES);
  float (*s_wgt)[4] = reinterpret_cast<float (*)[4]>(s_idx + n_samples);
  const int n = blockIdx.x;
  const float* roi = rois + (size_t)n * 6;
  int lvl, b;
  roi_level_batch(roi, lvls, n, B, &lvl, &b);
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  const T* feat = static_cast<const T*>(pyr.feat[lvl]) + (size_t)b * H * W * C;
  for (int s = threadIdx.x; s < n_samples; s += THREADS) {
    const int bin = s / per_bin, k = s % per_bin;
    int yx[4];
    sample_taps(pyr, roi, lvl, bin / out_size, bin % out_size, k / sn,
                k % sn, out_size, sn, yx, s_wgt[s]);
    s_idx[s][0] = yx[0] * W + yx[1];
    s_idx[s][1] = yx[0] * W + yx[3];
    s_idx[s][2] = yx[2] * W + yx[1];
    s_idx[s][3] = yx[2] * W + yx[3];
  }
  __syncthreads();
  pool_bins<T, VE, SN>(feat, s_idx, s_wgt, n_bins, per_bin, C,
                       out + (size_t)n * n_bins * C);
}

"""

# the banded variant's kernel
BANDED_KERNEL = r"""template <typename T, int VE, int OUT, int SN>
__global__ void __launch_bounds__(THREADS)
roi_align_rotated_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ lvls, T* __restrict__ out,
                         int B, int C, int out_rt, int sn_rt, int max_rows) {
  const int out_size = OUT ? OUT : out_rt;
  const int sn = SN ? SN : sn_rt;
  const int per_bin = sn * sn, n_bins = out_size * out_size;
  const int row_samples = out_size * per_bin;   // samples of a bin row
  const int n_samples = out_size * row_samples;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  int (*s_idx)[4] = reinterpret_cast<int (*)[4]>(smem + STAGE_BYTES);
  float (*s_wgt)[4] = reinterpret_cast<float (*)[4]>(s_idx + n_samples);
  int* xlo = reinterpret_cast<int*>(s_wgt + n_samples);
  int* xhi = xlo + max_rows;
  int* rbase = xhi + max_rows;
  int* misc = rbase + max_rows;             // ymin, ymax, P
  uint64_t* bar = reinterpret_cast<uint64_t*>(misc + 4);

  const int n = blockIdx.x, tid = threadIdx.x;
  const float* roi = rois + (size_t)n * 6;
  int lvl, b;
  roi_level_batch(roi, lvls, n, B, &lvl, &b);
  const int H = pyr.h[lvl], W = pyr.w[lvl];
  const T* feat = static_cast<const T*>(pyr.feat[lvl]) + (size_t)b * H * W * C;
  T* orow = out + (size_t)n * n_bins * C;
  // pixels of C channels the stage holds; with reads of a channel pair
  // (C * sizeof(T) not a multiple of 16) nothing is staged
  const int cap =
      VE * sizeof(T) == 16 ? STAGE_BYTES / (C * (int)sizeof(T)) : 0;

  // 1. the samples: their taps' rows and columns (in s_idx until their
  // band is pooled) and weights
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int s = tid; s < n_samples; s += THREADS) {
    const int bin = s / per_bin, k = s % per_bin;
    sample_taps(pyr, roi, lvl, bin / out_size, bin % out_size, k / sn,
                k % sn, out_size, sn, s_idx[s], s_wgt[s]);
  }
  __syncthreads();

  // 2. the bands: bin rows [ph0, ph0 + nb), all of them first, fewer while
  // their footprint exceeds the stage, down to one bin row, which reads
  // its taps from device memory if its own footprint does not fit
  uint32_t phase = 0;
  for (int ph0 = 0, nb = out_size; ph0 < out_size;) {
    nb = min(nb, out_size - ph0);
    const int s0 = ph0 * row_samples, s1 = (ph0 + nb) * row_samples;
    int P = INT_MAX, ymin = 0, rows = 0;
    if (cap > 0) {
      // the band's rows of the level, each row's span of columns, and
      // where each span starts in the footprint (warp 0 scans)
      if (tid == 0) {
        misc[0] = INT_MAX;
        misc[1] = -1;
      }
      for (int r = tid; r < max_rows; r += THREADS) {
        xlo[r] = INT_MAX;
        xhi[r] = -1;
      }
      __syncthreads();
      int ylo = INT_MAX, yhi = -1;
      for (int s = s0 + tid; s < s1; s += THREADS) {
        ylo = min(ylo, s_idx[s][0]);
        yhi = max(yhi, s_idx[s][2]);
      }
      if (yhi >= 0) {
        atomicMin(misc, ylo);
        atomicMax(misc + 1, yhi);
      }
      __syncthreads();
      ymin = misc[0];
      rows = misc[1] - ymin + 1;
      for (int s = s0 + tid; s < s1; s += THREADS) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = s_idx[s][2 * q] - ymin;
          atomicMin(xlo + r, s_idx[s][1]);
          atomicMax(xhi + r, s_idx[s][3]);
        }
      }
      __syncthreads();
      if (tid < 32) {
        int carry = 0;
        for (int r0 = 0; r0 < rows; r0 += 32) {
          const int r = r0 + tid;
          const int len =
              r < rows && xhi[r] >= xlo[r] ? xhi[r] - xlo[r] + 1 : 0;
          int incl = len;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (tid >= o) incl += v;
          }
          if (r < rows) rbase[r] = carry + incl - len;
          carry += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (tid == 0) misc[2] = carry;
      }
      __syncthreads();
      P = misc[2];
      if (P > cap && nb > 1) {              // fewer bin rows, same ph0
        nb = max(1, min(nb - 1, nb * cap / P));
        continue;
      }
    }
    // the band's footprint, all C channels, one bulk copy a row, where it
    // fits the stage
    const bool staged = P <= cap;
    if (staged && tid < 32) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, (uint32_t)(P * C * sizeof(T)));
      }
      __syncwarp();
      for (int r = tid; r < rows; r += 32) {
        const int len = xhi[r] >= xlo[r] ? xhi[r] - xlo[r] + 1 : 0;
        if (len > 0)
          bulk_load(stage + (size_t)rbase[r] * C,
                    feat + ((size_t)(ymin + r) * W + xlo[r]) * C,
                    (uint32_t)(len * C * sizeof(T)), bar);
      }
    }
    // 3. the band's tap rows / columns -> indices into the footprint (or
    // the image), while the copies are in flight
    for (int s = s0 + tid; s < s1; s += THREADS) {
      const int y0 = s_idx[s][0], x0 = s_idx[s][1];
      const int y1 = s_idx[s][2], x1 = s_idx[s][3];
      if (staged) {
        const int b0 = rbase[y0 - ymin] - xlo[y0 - ymin];
        const int b1 = rbase[y1 - ymin] - xlo[y1 - ymin];
        s_idx[s][0] = b0 + x0;
        s_idx[s][1] = b0 + x1;
        s_idx[s][2] = b1 + x0;
        s_idx[s][3] = b1 + x1;
      } else {
        s_idx[s][0] = y0 * W + x0;
        s_idx[s][1] = y0 * W + x1;
        s_idx[s][2] = y1 * W + x0;
        s_idx[s][3] = y1 * W + x1;
      }
    }
    __syncthreads();
    // 4. the band's bins
    T* bout = orow + (size_t)ph0 * out_size * C;
    if (staged) {
      mbar_wait(bar, phase);
      phase ^= 1;
      pool_bins<T, VE, SN>(stage, s_idx + s0, s_wgt + s0, nb * out_size,
                           per_bin, C, bout);
    } else {
      pool_bins<T, VE, SN>(feat, s_idx + s0, s_wgt + s0, nb * out_size,
                           per_bin, C, bout);
    }
    ph0 += nb;
    __syncthreads();             // the stage and the spans are free again
  }
}
"""

# reads of 16 bytes from device memory through L2 only
UNPACK_CG = r"""
template <int N, typename T>
__device__ __forceinline__ void unpack_cg(const T* p, float (&v)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 q = __ldcg(reinterpret_cast<const uint4*>(p));
    unpack<N>(reinterpret_cast<const T*>(&q), v);
  } else {
    unpack<N>(p, v);
  }
}
"""

KERNEL_START = "template <typename T, int VE, int OUT, int SN>\n__global__"
LAUNCH_START = "template <typename T, int VE, int OUT, int SN>\nint launch_k"
POOL_START = ("template <typename T, int VE, int SN>\n"
              "__device__ __forceinline__ void pool_bins(")


def log(*a):
    print(*a, flush=True)


def variant_source(src, name):
    """The shipped source with the variant's parts replaced."""
    body, l2 = name.split("_")[0], name.endswith("_l2")
    i, j = src.index(KERNEL_START), src.index(LAUNCH_START)
    if body == "direct":
        src = src[:i] + DIRECT_KERNEL + src[j:]
        src = src.replace("constexpr int STAGE_BYTES = 32 * 1024;",
                          "constexpr int STAGE_BYTES = 0;")
    elif body == "banded":
        src = src[:i] + BANDED_KERNEL + src[j:]
    if l2:
        a = src.index(POOL_START)
        b = src.index("\n}\n", a) + 3
        pool = src[a:b].replace("void pool_bins(", "void pool_bins_cg(")
        pool = pool.replace("unpack<VE>(bp", "unpack_cg<VE>(bp")
        src = src[:b] + UNPACK_CG + pool + src[b:]
        assert src.count("pool_bins<T, VE, SN>(feat,") == 1, name
        src = src.replace("pool_bins<T, VE, SN>(feat,",
                          "pool_bins_cg<T, VE, SN>(feat,")
    return src


def build_variants(names):
    from sm3det_tpu_torch.ops.cuda import build
    csrc = build.CSRC
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (csrc / "roi_align_rotated.cu").read_text()
    procs = {}
    for name in names:
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-shared",
               "-o", str(out / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        text, _ = p.communicate()
        (out / f"{name}.log").write_text(text)
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = lib.sm3det_roi_align_rotated
        fn.argtypes = build._SIGNATURES["sm3det_roi_align_rotated"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from chip_smoke import align_read_model, nvidia_smi_line
    from sm3det_tpu_torch.models.detectors.trisource import (
        DEFAULT_MODEL_CFG, TriSourceDetector)
    from sm3det_tpu_torch.ops.roi_align_rotated import (
        roi_align_rotated_pyramid, route_levels, sample_taps)

    names = ["staged", "direct", "banded", "staged_l2", "direct_l2",
             "banded_l2"]
    t0 = time.perf_counter()
    fns = build_variants(names)
    log(f"[build] {len(names)} variants {time.perf_counter() - t0:.1f} s")
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{nvidia_smi_line()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def launch(name, feats, rois, lvls):
        n, ch = rois.shape[0], feats[0].shape[-1]
        out = torch.empty((n, 7, 7, ch), device=dev, dtype=feats[0].dtype)
        rc = fns[name](
            *[f.data_ptr() for f in feats[:4]],
            *[f.shape[1] for f in feats[:4]], *[f.shape[2] for f in feats[:4]],
            *[1.0 / s for s in STRIDES], rois.data_ptr(), lvls.data_ptr(),
            out.data_ptr(), feats[0].shape[0], ch, n, 7, 2,
            int(feats[0].dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return out

    def study(what, feats, rois):
        rois = rois.float().contiguous()
        lvls = route_levels(rois).contiguous()
        log(f"[{what}] {rois.shape[0]} RoIs, per level "
            f"{torch.bincount(lvls, minlength=4).tolist()}; read model "
            f"{align_read_model(torch, sample_taps, feats, rois, lvls)}")
        ref = roi_align_rotated_pyramid(feats, rois, lvls, 7)
        scale = max(ref.float().abs().max().item(), 1.0)
        shipped = launch("staged", feats, rois, lvls)
        ok = True
        for name in names:
            a = launch(name, feats, rois, lvls)
            b = launch(name, feats, rois, lvls)
            err = (a.float() - ref.float()).abs().max().item()
            good = err <= 0.0078 * scale and torch.equal(a, b)
            ok = ok and good
            log(f"[{what}]   {name}: max err {err:.5f} (scale {scale:.3f}), "
                f"runs bit-equal {torch.equal(a, b)}, the shipped kernel's "
                f"bits {torch.equal(a, shipped)}{'' if good else ' FAIL'}")
        ms = {name: [] for name in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                for _ in range(3):
                    launch(name, feats, rois, lvls)
                torch.cuda.synchronize()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(args.iters):
                    launch(name, feats, rois, lvls)
                e.record()
                torch.cuda.synchronize()
                ms[name].append(s.elapsed_time(e) / args.iters)
        for name in names:
            log(f"[{what}]   {name}: ms a launch, by round "
                f"{' '.join(f'{x:.4f}' for x in ms[name])}; median "
                f"{statistics.median(ms[name]):.4f}")
        return ok, {k: statistics.median(v) for k, v in ms.items()}

    feats = [torch.randn(8, IMG // s, IMG // s, 256, generator=gen,
                         device=dev).to(torch.bfloat16) for s in STRIDES]
    u = lambda n: torch.rand(n, generator=gen, device=dev)  # noqa: E731
    n = 16000
    side, asp = 8 * 2 ** (u(n) * 6.5), 2 ** ((u(n) - 0.5) * 3)
    rois = torch.stack([
        torch.randint(0, 8, (n,), generator=gen, device=dev).float(),
        (u(n) * 1.2 - 0.1) * IMG, (u(n) * 1.2 - 0.1) * IMG, side * asp,
        side / asp, (u(n) - 0.5) * 3.14], -1)
    rois[::11, 1:] = 0.0
    rois[5::50, 1:3] = -3.0 * IMG
    ok1, syn = study("synthetic", feats, rois)
    del feats

    cfg = json.loads(json.dumps(DEFAULT_MODEL_CFG))
    cfg["compute_dtype"] = "bfloat16"
    model = TriSourceDetector(cfg, seed=args.seed)
    imgs = [torch.rand(k, IMG, IMG, 3, generator=gen, device=dev)
            for k in (8, 4, 4)]
    with torch.no_grad():
        _, x, rpn = model.head_joint(*imgs)
        props, _, _ = model.get_proposals(*rpn)
    del model
    idx = torch.arange(props.shape[0], device=dev, dtype=props.dtype)
    rois_j = torch.cat([idx.repeat_interleave(props.shape[1])[:, None],
                        props.reshape(-1, 5)], -1)
    ok2, prop = study("proposals", [f.contiguous() for f in x[:4]], rois_j)
    print(json.dumps({"synthetic_ms": syn, "proposals_ms": prop,
                      "ok": ok1 and ok2}))
    if not (ok1 and ok2):
        sys.exit(1)


if __name__ == "__main__":
    main()
