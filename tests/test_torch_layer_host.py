"""The fused transformer layer's CUDA source compiled for the host and held
against its plain PyTorch version on the CPU.

The kernel is written as barrier-separated phases, each a function of
(sample, thread, thread count) whose threads write disjoint outputs and
read only what earlier phases wrote.  Here the source is built with g++
against a header that defines the CUDA keywords away, and each phase runs
for every thread in turn, one sample after another, through the same
checks and pointer order the CUDA launch uses
(`ops.attention._launch`).  This checks the kernel's arithmetic, indexing
and shared-memory layout without a card; the card runs it through
tests/test_torch_attention_cuda.py and chip_smoke.py.  Skipped where no
g++ is installed.

Tolerance atol 2e-5, rtol 1e-4 (tests/test_pallas.py's for the JAX fused
layer): float32 sums taken in another order than torch's matmuls.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vision4leg_torch.ops import attention as att
from vision4leg_torch.ops import nvcc

_HOST_HEADER = """
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
"""

_HOST_LAUNCH = """
#include <vector>
extern "C" int transformer_layer_launch(
    const void* x, void* out, const void* wq, const void* bq, const void* wk,
    const void* bk, const void* wv, const void* bv, const void* wo,
    const void* bo, const void* ln1s, const void* ln1b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2s,
    const void* ln2b, int B, int T, int D, int F, void* res) {
  LayerArgs a{(const float*)x, (float*)out, (const float*)wq,
              (const float*)bq, (const float*)wk, (const float*)bk,
              (const float*)wv, (const float*)bv, (const float*)wo,
              (const float*)bo, (const float*)ln1s, (const float*)ln1b,
              (const float*)w1, (const float*)b1, (const float*)w2,
              (const float*)b2, (const float*)ln2s, (const float*)ln2b,
              T, D, F, (float*)res, B};
  // garbage in the shared memory, as on the card
  std::vector<float> smem(tl_smem_floats(T, D, F), NAN);
  for (int b = 0; b < B; ++b)
    for (int ph = 0; ph < TL_NUM_PHASES; ++ph)
      for (int tid = 0; tid < TL_THREADS; ++tid)
        tl_phase(ph, a, smem.data(), b, tid, TL_THREADS);
  return 0;
}

extern "C" int transformer_layer_bwd_launch(
    const void* g, void* res, const void* wqt, const void* wkt,
    const void* wvt, const void* wot, const void* w1t, const void* w2t,
    const void* ln1s, const void* ln2s, void* dx, void* dqkv, void* dr1,
    void* dh, void* dz2, void* part, int B, int T, int D, int F) {
  BwdArgs a{(const float*)g, (float*)res, (const float*)wqt,
            (const float*)wkt, (const float*)wvt, (const float*)wot,
            (const float*)w1t, (const float*)w2t, (const float*)ln1s,
            (const float*)ln2s, (float*)dx, (float*)dqkv, (float*)dr1,
            (float*)dh, (float*)dz2, (float*)part, B, T, D, F};
  std::vector<float> smem(tlb_smem_floats(T, D, F), NAN);
  for (int b = 0; b < B; ++b)
    for (int ph = 0; ph < TLB_NUM_PHASES; ++ph)
      for (int tid = 0; tid < TL_THREADS; ++tid)
        tlb_phase(ph, a, smem.data(), b, tid, TL_THREADS);
  return 0;
}
"""


def build_host(d, src):
  """Compile kernel source text `src` for the host in directory d; returns
  the library (both launches: forward, then backward, as the CUDA launches
  take them without the stream)."""
  gxx = shutil.which("g++")
  if gxx is None:
    pytest.skip("needs g++ to build the kernel source for the host")
  (d / "cuda_runtime.h").write_text(_HOST_HEADER)
  (d / "kernel.cpp").write_text(src + _HOST_LAUNCH)
  so = d / "kernel.so"
  proc = subprocess.run(
      [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
       "-Wno-unknown-pragmas", "-I", str(d), "-o", str(so),
       str(d / "kernel.cpp")], capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert "warning" not in proc.stderr, proc.stderr
  lib = ctypes.CDLL(str(so))
  lib.transformer_layer_launch.argtypes = [ctypes.c_void_p] * 18 + [
      ctypes.c_int] * 4 + [ctypes.c_void_p]
  lib.transformer_layer_bwd_launch.argtypes = [ctypes.c_void_p] * 16 + [
      ctypes.c_int] * 4
  for fn in (lib.transformer_layer_launch, lib.transformer_layer_bwd_launch):
    fn.restype = ctypes.c_int
  return lib


@pytest.fixture(scope="module")
def host_launch(tmp_path_factory):
  with open(nvcc.SOURCES["transformer_layer"]) as f:
    src = f.read()
  return build_host(tmp_path_factory.mktemp("host_layer"),
                    src).transformer_layer_launch


def _weights(rng, D, F):
  """Random weights at the scale of lecun-normal init, LayerNorm scales
  and biases off their init values."""
  shapes = dict(wq=(D, D), bq=(D,), wk=(D, D), bk=(D,), wv=(D, D), bv=(D,),
                wo=(D, D), bo=(D,), ln1_scale=(D,), ln1_bias=(D,),
                w1=(D, F), b1=(F,), w2=(F, D), b2=(D,), ln2_scale=(D,),
                ln2_bias=(D,))
  out = {}
  for name, shape in shapes.items():
    if len(shape) == 2:
      x = rng.normal(0, 1 / np.sqrt(shape[0]), shape)
    elif "scale" in name:
      x = 1 + 0.1 * rng.normal(size=shape)
    else:
      x = 0.1 * rng.normal(size=shape)
    out[name] = torch.tensor(x, dtype=torch.float32)
  return att.LayerWeights(**out)


@pytest.mark.parametrize("B,T,D,F", [(3, 17, 64, 256), (2, 5, 16, 40),
                                     (1, 1, 8, 8), (2, 32, 128, 512),
                                     (2, 18, 33, 70)])
def test_layer_source_matches_plain_on_host(host_launch, B, T, D, F):
  rng = np.random.default_rng(B * 1000 + T)
  x = torch.tensor(rng.normal(size=(B, T, D)), dtype=torch.float32)
  w = _weights(rng, D, F)
  before = att.fused_transformer_layer.launches
  got = att._launch(x, w, launch=host_launch)
  assert att.fused_transformer_layer.launches == before + 1
  ref = att.layer_math(x, w)
  np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                             rtol=1e-4)
