"""The fused transformer layer's CUDA source compiled for the host and held
against its plain PyTorch version, and the JAX package's layer, on the CPU.

The forward kernel runs a tile of samples as barrier-separated phases
(`TL_PHASE`), each a function of (tile, warp, lane) whose warps write
disjoint outputs in the tile's shared memory and read only what earlier
phases wrote.  Here the source is built with g++ against a header that
defines the CUDA keywords away and makes each phase run for warps 0..11
in turn (or in reverse), a warp as one lane doing all 32 lanes' work:
the warp-level tile product `tl_unit_mma` has a host body that computes
the same 3xTF32 split in loops.  Tiles are those of a card with one SM
(G = min(B, what fits)), each on shared memory filled with NaN and
followed by a guard band that must stay NaN, through the same checks and
pointer order the CUDA launch uses (`ops.attention._launch`).  This checks
the kernel's arithmetic, indexing and shared-memory layout without a
card; the fragment layouts of the tensor-core products run only on the
card (tests/test_torch_attention_cuda.py and chip_smoke.py).  The
backward kernel's phases run thread by thread.  Skipped where no g++ is
installed.

Tolerance atol 2e-5, rtol 1e-4 (tests/test_pallas.py's for the JAX fused
layer): float32 sums taken in another order than torch's matmuls, and
products in 3xTF32.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.ops import attention as jatt
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
// with reversed set, the warps of a phase run in the opposite order
static int reversed = 0;
// a forward phase: its statement for warps 0..TL_WARPS-1 in turn, each
// warp as one lane (lane 0, TL_LANES = 1) that does all 32 lanes' work
#define TL_PHASE(wait, call)                                     \\
  for (int tl_i = 0; tl_i < TL_WARPS; ++tl_i) {                  \\
    const int warp = reversed ? TL_WARPS - 1 - tl_i : tl_i;      \\
    const int lane = 0;                                          \\
    call;                                                        \\
  }
"""

_HOST_LAUNCH = """
#include <algorithm>
#include <vector>
extern "C" void transformer_layer_host_reverse(int r) { reversed = r; }

// The tiles one after another, each on shared memory filled with NaN, as
// garbage, and followed by a guard band that must stay NaN; tiles as on a
// card with one SM (G = min(B, what fits)).
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
  const TlPlan pl = tl_make_plan(B, T, D, F, 1);
  const int guard = 64;
  std::vector<float> smem(pl.floats + guard);
  for (int tile = 0; tile < pl.tiles; ++tile) {
    std::fill(smem.begin(), smem.end(), NAN);
    // the instantiation the CUDA launch takes at this T
    if (T <= 32)
      tl_tile<TL_ATTN_SMALL>(a, pl, smem.data(), tile, 0, 0);
    else
      tl_tile<TL_ATTN_LARGE>(a, pl, smem.data(), tile, 0, 0);
    for (int g = pl.floats; g < pl.floats + guard; ++g)
      if (!std::isnan(smem[g])) return 1;
  }
  return 0;
}

extern "C" int transformer_layer_host_tile_samples(int B, int T, int D,
                                                   int F) {
  return tl_make_plan(B, T, D, F, 1).G;
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
      for (int tid = 0; tid < TLB_THREADS; ++tid)
        tlb_phase(ph, a, smem.data(), b, tid, TLB_THREADS);
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
  lib.transformer_layer_host_tile_samples.argtypes = [ctypes.c_int] * 4
  lib.transformer_layer_host_reverse.argtypes = [ctypes.c_int]
  for fn in (lib.transformer_layer_launch, lib.transformer_layer_bwd_launch,
             lib.transformer_layer_host_tile_samples):
    fn.restype = ctypes.c_int
  return lib


def _source():
  with open(nvcc.SOURCES["transformer_layer"]) as f:
    return f.read()


@pytest.fixture(scope="module")
def host(tmp_path_factory):
  return build_host(tmp_path_factory.mktemp("host_layer"), _source())


@pytest.fixture(scope="module")
def host_launch(host):
  return host.transformer_layer_launch


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


def _case(B, T, D, F):
  rng = np.random.default_rng(B * 1000 + T)
  x = torch.tensor(rng.normal(size=(B, T, D)), dtype=torch.float32)
  return x, _weights(rng, D, F)


# (9, 17, 64, 256): two tiles of G = 8 samples, the second with one; (9,
# 16, 64, 256) the same at the vision-only model's 16 tokens; (9, 33, 64,
# 256) three tiles of G = 4 at the 16-channel LocoTransformer's 33 tokens
# (the large attention instantiation), (2, 48, 128, 512) its largest shape
@pytest.mark.parametrize("B,T,D,F", [(3, 17, 64, 256), (2, 5, 16, 40),
                                     (1, 1, 8, 8), (2, 32, 128, 512),
                                     (2, 18, 33, 70), (9, 17, 64, 256),
                                     (9, 16, 64, 256), (9, 33, 64, 256),
                                     (2, 48, 128, 512), (3, 41, 40, 72)])
def test_layer_source_matches_plain_on_host(host_launch, B, T, D, F):
  x, w = _case(B, T, D, F)
  before = att.fused_transformer_layer.launches
  got = att._launch(x, w, launch=host_launch)
  assert att.fused_transformer_layer.launches == before + 1
  ref = att.layer_math(x, w)
  np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                             rtol=1e-4)


def test_host_tiles_are_ragged(host):
  """The ragged case above runs as tiles of 8 and 1 samples, and T = 32,
  D = 128 takes one sample a tile (the shared memory caps G)."""
  assert host.transformer_layer_host_tile_samples(9, 17, 64, 256) == 8
  assert host.transformer_layer_host_tile_samples(3, 32, 128, 512) == 1
  assert host.transformer_layer_host_tile_samples(9, 33, 64, 256) == 4
  assert host.transformer_layer_host_tile_samples(3, 48, 128, 512) == 1


@pytest.mark.parametrize("B,T,D,F", [(8, 17, 64, 256), (9, 17, 64, 256),
                                     (5, 33, 64, 256)])
def test_layer_source_matches_jax_on_host(host_launch, B, T, D, F):
  """The same numpy inputs through the JAX package's fused layer (its
  plain math off the TPU) and through the host build of the kernel."""
  x, w = _case(B, T, D, F)
  got = att._launch(x, w, launch=host_launch)
  ref = jatt.fused_transformer_layer(
      jnp.asarray(x.numpy()),
      jatt.LayerWeights(*[jnp.asarray(t.numpy()) for t in w]))
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                             rtol=1e-4)


@pytest.mark.parametrize("B,T,D,F", [(9, 17, 64, 256), (2, 18, 33, 70),
                                     (5, 33, 64, 256)])
def test_layer_source_warp_order(host, B, T, D, F):
  """The warps of every phase in the opposite order, on NaN-filled shared
  memory with its guard band checked: the same bits, in both modes (a
  warp reading what another writes in the same phase would differ)."""
  x, w = _case(B, T, D, F)
  runs = []
  for rev in (0, 1):
    host.transformer_layer_host_reverse(rev)
    try:
      out = att._launch(x, w, launch=host.transformer_layer_launch)
      saved, res = att._launch(x, w, launch=host.transformer_layer_launch,
                               save=True)
    finally:
      host.transformer_layer_host_reverse(0)
    assert torch.equal(out, saved)
    runs.append((out, res))
  assert torch.equal(runs[0][0], runs[1][0])
  assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# Faults in the forward that the comparison must catch.
_MUTATIONS = {
    "product reads the other ring slot": (
        "const float* W = smem + pl.oW + (p & 1) * pl.slot;",
        "const float* W = smem + pl.oW + ((p + 1) & 1) * pl.slot;"),
    "LayerNorm variance about zero": (
        "const float d = c0[j] + h < D ? v[i][j][h] - mu[i] : 0.0f;",
        "const float d = c0[j] + h < D ? v[i][j][h] : 0.0f;"),
    "small parts of the 3xTF32 split dropped": (
        "  p[0] = ab * bs;\n  p[1] = as * bb;\n",
        "  p[0] = 0.0f * ab * bs;\n  p[1] = 0.0f * as * bb;\n"),
}


@pytest.mark.parametrize("mutation", sorted(_MUTATIONS))
def test_layer_comparison_catches_mutations(tmp_path, mutation):
  src = _source()
  old, new = _MUTATIONS[mutation]
  assert src.count(old) == 1
  lib = build_host(tmp_path, src.replace(old, new))
  x, w = _case(9, 17, 64, 256)
  got = att._launch(x, w, launch=lib.transformer_layer_launch)
  assert not np.allclose(got.numpy(), att.layer_math(x, w).numpy(),
                         atol=2e-5, rtol=1e-4)
