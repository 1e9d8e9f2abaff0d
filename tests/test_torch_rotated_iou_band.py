"""The band of ``csrc/rotated_iou.cu`` (``fast_decide``: ``iou > thr``
decided without IEEE division where a bound on ``pair_iou``'s rounding
allows) held against ``pair_iou`` itself on the CPU.

The source's pair functions are compiled by the host C++ compiler with
the CUDA rounding intrinsics spelt as host operations: round-to-nearest
fp32 arithmetic with no contraction (``-ffp-contract=off``), directed
rounding through ``fesetround``, and ``__fdividef`` as the correctly
rounded quotient moved by up to its documented 2 ulp (at random, or always
up, or always down). Clustered rotated boxes (duplicates, shared edges,
axis-aligned ones, sizes 0.5-400 px), with the multi-class NMS's class
offsets scaled by 0, 0.2 or 1, are decided at fixed thresholds, at IoUs
that occur and the floats beside them, and at each pair's own IoU: every
decision the band makes must equal ``pair_iou(q1, q2) > thr``. A copy
whose bound is set to 0 must be caught.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "sm3det_tpu_torch" / "ops" \
    / "cuda" / "csrc"

SHIM = r"""
#pragma once
#include <cfenv>
#include <cmath>
#include <random>
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
extern std::mt19937 g_rng;
extern int g_div_mode;  // 0: within 2 ulp at random; 1: +2 ulp; 2: -2 ulp
#define SM3DET_RN(name, expr) \
  static inline float name(float a, float b) { volatile float r = expr; \
                                               return r; }
SM3DET_RN(__fadd_rn, a + b)
SM3DET_RN(__fsub_rn, a - b)
SM3DET_RN(__fmul_rn, a * b)
SM3DET_RN(__fdiv_rn, a / b)
static inline float __fsqrt_rn(float a) {
  volatile float r = std::sqrt(a);
  return r;
}
static inline float __fadd_ru(float a, float b) {
  std::fesetround(FE_UPWARD);
  volatile float x = a, y = b;
  volatile float r = x + y;
  std::fesetround(FE_TONEAREST);
  return r;
}
static inline float __fsub_rd(float a, float b) {
  std::fesetround(FE_DOWNWARD);
  volatile float x = a, y = b;
  volatile float r = x - y;
  std::fesetround(FE_TONEAREST);
  return r;
}
static inline float __fdividef(float a, float b) {
  float r = (float)((double)a / (double)b);
  const int k = g_div_mode == 0 ? (int)(g_rng() % 5) - 2
                                : (g_div_mode == 1 ? 2 : -2);
  for (int i = 0; i < k; ++i) r = std::nextafter(r, INFINITY);
  for (int i = 0; i > k; --i) r = std::nextafter(r, -INFINITY);
  return r;
}
"""

PROGRAM = r"""
#include <cuda_runtime.h>
#include "exact_math.cuh"
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <vector>
std::mt19937 g_rng(1);
int g_div_mode = 0;
#include "pair_part.inc"

struct P { float g[GEOM]; float t[SEP]; };

int main(int argc, char** argv) {
  const int seed = atoi(argv[1]);
  const double offset_scale = atof(argv[2]);
  g_div_mode = atoi(argv[3]);
  const int n_clusters = atoi(argv[4]);
  std::mt19937 rng(seed);
  std::uniform_real_distribution<float> U(0.f, 1.f);
  std::normal_distribution<float> Nd(0.f, 1.f);
  std::vector<std::vector<float>> boxes;
  std::vector<int> cluster;
  for (int c = 0; c < n_clusters; ++c) {
    const float cx = 800 * U(rng), cy = 800 * U(rng);
    const float sz = std::exp(std::log(4.f) + std::log(100.f) * U(rng));
    const float ar = std::exp(Nd(rng) * 0.6f);
    const int kind = rng() % 6;
    float ang = (U(rng) - 0.5f) * 3.14159265f;
    if (kind == 0) ang = 0.f;
    if (kind == 1) ang = 1.5707964f;
    const float off = (float)(offset_scale * (rng() % 26) * 2.0 * 851.0);
    const int m = 4 + rng() % 12;
    for (int k = 0; k < m; ++k) {
      const int e = rng() % 10;
      if (e < 2 && !boxes.empty() && cluster.back() == c) {
        std::vector<float> q = boxes.back();
        if (e == 1) {  // shares an edge, or nearly
          const float ca = std::cos(q[4]), sa = std::sin(q[4]);
          const float gap = rng() % 3 == 0 ? 0.f : (U(rng) - 0.5f) * 1e-3f;
          if (rng() % 2) {
            q[0] += (q[2] + gap) * ca;
            q[1] += (q[2] + gap) * sa;
          } else {
            q[0] -= (q[3] + gap) * sa;
            q[1] += (q[3] + gap) * ca;
          }
        }
        boxes.push_back(q);  // e == 0: a duplicate
        cluster.push_back(c);
        continue;
      }
      const float ra = std::sqrt(ar);
      const float w = std::max(0.5f, sz * ra * (1 + 0.2f * Nd(rng)));
      const float h = std::max(0.5f, sz / ra * (1 + 0.2f * Nd(rng)));
      const float a = ang + (kind < 2 && k % 2 ? 0.f : 0.15f * Nd(rng));
      boxes.push_back({cx + 0.25f * sz * Nd(rng) + off,
                       cy + 0.25f * sz * Nd(rng) + off, w, h, a});
      cluster.push_back(c);
    }
  }
  const int n = boxes.size();
  std::vector<P> ps(n);
  for (int i = 0; i < n; ++i) {
    box_geometry(boxes[i].data(), ps[i].g);
    sep_terms(boxes[i].data(), ps[i].g, ps[i].t);
  }
  std::vector<float> thrs = {0.05f, 0.1f, 0.3f, 0.5f, 0.7f, 0.9f};
  std::vector<float> occur;
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n && cluster[j] == cluster[i]; ++j) {
      const float v = pair_iou(ps[i].g, ps[j].g);
      if (v > 0.01f && v < 0.99f) occur.push_back(v);
    }
  std::shuffle(occur.begin(), occur.end(), rng);
  for (int k = 0; k < 6 && k < (int)occur.size(); ++k) {
    thrs.push_back(occur[k]);
    thrs.push_back(std::nextafter(occur[k], 1.f));
    thrs.push_back(std::nextafter(occur[k], 0.f));
  }
  long long clipped = 0, eligible = 0, decided = 0, wrong = 0;
  auto check = [&](int i, int j, float thr, float iou) {
    const P &a = ps[i], &b = ps[j];
    if (!band_may_decide(a.t, b.t, a.g[20], b.g[20], thr)) return;
    ++eligible;
    const int d = fast_decide(a.g, b.g, a.t[7] + b.t[7], thr);
    if (d == UNSURE) return;
    ++decided;
    if (d != (int)(iou > thr)) ++wrong;
  };
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n && j < i + 24; ++j) {
      if (apart(ps[i].t, ps[j].t)) continue;
      ++clipped;
      const float v = pair_iou(ps[i].g, ps[j].g);
      for (float thr : thrs) check(i, j, thr, v);
      if (v > 0x1p-100f) {
        const float own[] = {v, std::nextafter(v, 1.f), std::nextafter(v, 0.f),
                             v * (1 + 1e-6f), v * (1 - 1e-6f)};
        for (float thr : own) check(i, j, thr, v);
      }
    }
  printf("clipped %lld eligible %lld decided %lld wrong %lld\n", clipped,
         eligible, decided, wrong);
  return 0;
}
"""


def _pair_part(unsound=False):
    src = (CSRC / "rotated_iou.cu").read_text()
    part = src[src.index("namespace {"):
               src.index("// MASK: boxes2 is boxes1")] + "}  // namespace\n"
    if unsound:
        old = "fmaf(0x1p-19f, n12, 0.5f * lip) * (1.f + 0x1p-16f)"
        assert part.count(old) == 1
        part = part.replace(old, "0.f")
    return part


def _compile(tmp: Path, unsound=False) -> Path:
    (tmp / "shim").mkdir(exist_ok=True)
    (tmp / "shim" / "cuda_runtime.h").write_text(SHIM)
    (tmp / "band_check.cpp").write_text(PROGRAM)
    (tmp / "pair_part.inc").write_text(_pair_part(unsound))
    exe = tmp / "band_check"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-frounding-math", "-DSM3DET_ROTATED_IOU_BAND=1",
                    "-I", str(tmp / "shim"), "-I", str(tmp), "-I",
                    str(CSRC), "-o", str(exe), str(tmp / "band_check.cpp")],
                   check=True, capture_output=True, text=True)
    return exe


def _run(exe, seed, offset, div_mode, clusters=150):
    out = subprocess.run([str(exe), str(seed), str(offset), str(div_mode),
                          str(clusters)], check=True, capture_output=True,
                         text=True).stdout
    m = re.search(r"clipped (\d+) eligible (\d+) decided (\d+) wrong (\d+)",
                  out)
    return dict(zip(("clipped", "eligible", "decided", "wrong"),
                    map(int, m.groups())))


@pytest.fixture(scope="module")
def band_check(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    return _compile(tmp_path_factory.mktemp("band"))


@pytest.mark.parametrize("div_mode", [0, 1, 2])
@pytest.mark.parametrize("offset", [0.0, 0.2, 1.0])
def test_band_decisions_equal_pair_iou(band_check, offset, div_mode):
    """Every pair the band decides is decided as pair_iou's result is;
    without class offsets most eligible pairs are decided."""
    r = _run(band_check, seed=int(10 * offset) + 3 * div_mode + 1,
             offset=offset, div_mode=div_mode)
    assert r["wrong"] == 0, r
    assert r["decided"] > 0, r
    if offset == 0.0:
        assert r["decided"] > 0.5 * r["eligible"], r


def test_band_check_catches_an_unsound_band(tmp_path):
    """The same check on a copy whose bound (delta) is 0 finds decisions
    that differ from pair_iou's: the check can fail."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    r = _run(_compile(tmp_path, unsound=True), seed=1, offset=0.0,
             div_mode=0)
    assert r["wrong"] > 0, r
