"""The fused layer's backward kernel, and the forward's residual-saving
mode, compiled for the host and held against their plain PyTorch versions
on the CPU.

As in tests/test_torch_layer_host.py, the CUDA source is built with g++
and each barrier-separated phase runs for every thread in turn, through
the checks and pointer order of the CUDA launches (`ops.attention._launch`
with save=True, `ops.attention._launch_bwd`).  What the backward kernel
writes is held against `layer_backward_rows`, and the gradients made from
it against `layer_backward_math`, on the same residuals, the ones the
host kernel's forward wrote, at atol 3e-5 / rtol 1e-4 (tests/test_pallas.py's
gradient tolerance: float32 sums taken in another order than torch's).
Copies of the source with one fault in the backward must fail that
comparison.  Skipped where no g++ is installed.
"""
import numpy as np
import pytest
import torch

from test_torch_layer_host import _weights, build_host
from vision4leg_torch.ops import attention as att
from vision4leg_torch.ops import nvcc

GRAD = dict(atol=3e-5, rtol=1e-4)
FWD = dict(atol=2e-5, rtol=1e-4)


def _source():
  with open(nvcc.SOURCES["transformer_layer"]) as f:
    return f.read()


@pytest.fixture(scope="module")
def host(tmp_path_factory):
  return build_host(tmp_path_factory.mktemp("host_layer_bwd"), _source())


def _case(B, T, D, F):
  rng = np.random.default_rng(B * 100 + T + D)
  x = torch.tensor(rng.normal(size=(B, T, D)), dtype=torch.float32)
  g = torch.tensor(rng.normal(size=(B, T, D)), dtype=torch.float32)
  return x, _weights(rng, D, F), g


def _rows(lib, x, w, g):
  """(forward out, residuals, the backward's rows) through the host
  kernels."""
  out, res = att._launch(x, w, launch=lib.transformer_layer_launch,
                         save=True)
  rows = att._launch_bwd(res, g, w, launch=lib.transformer_layer_bwd_launch)
  return out, res, rows


@pytest.mark.parametrize("B,T,D,F", [(3, 17, 64, 256), (2, 5, 16, 40),
                                     (1, 1, 8, 8), (2, 32, 128, 512),
                                     (2, 18, 33, 70), (3, 16, 64, 256),
                                     (3, 33, 64, 256), (2, 48, 64, 256)])
def test_backward_source_matches_plain_on_host(host, B, T, D, F):
  x, w, g = _case(B, T, D, F)
  before = (att.fused_transformer_layer.launches,
            att.fused_transformer_layer_bwd.launches)
  out, res, got = _rows(host, x, w, g)
  assert (att.fused_transformer_layer.launches,
          att.fused_transformer_layer_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
  # the saving mode leaves the forward's output as it was
  plain = att._launch(x, w, launch=host.transformer_layer_launch)
  assert torch.equal(out, plain)
  ref_out, ref_res = att.layer_forward_saved(x, w)
  np.testing.assert_allclose(out.numpy(), ref_out.numpy(), **FWD)
  for name, a, b in zip(att.Residuals._fields, res, ref_res):
    np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **FWD)
  want = att.layer_backward_rows(res, g, w)
  for name, a, b in zip(att.BackwardRows._fields, got, want):
    assert a.shape == b.shape, name
    np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **GRAD)
  for name, a, b in zip(("x",) + att.LayerWeights._fields,
                        att.weight_grads(res, got),
                        att.layer_backward_math(res, g, w)):
    assert a.shape == b.shape, name
    np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **GRAD)
  # no atomics: a second call gives the same bits
  again = att._launch_bwd(res, g, w,
                          launch=host.transformer_layer_bwd_launch)
  assert all(torch.equal(a, b) for a, b in zip(got, again))


# Faults in the backward that the comparison must catch.
_MUTATIONS = {
    "softmax row sum dropped": (
        "m.dp[o] = m.p[o] * (m.dp[o] - m.s1[t]) / scale;",
        "m.dp[o] = m.p[o] * m.dp[o] / scale;"),
    "relu mask taken at h >= 0": (
        "const float d = hres[t * F + f] > 0.0f ? acc[r] : 0.0f;",
        "const float d = hres[t * F + f] >= 0.0f ? acc[r] : 0.0f;"),
    "LayerNorm's xhat term dropped": (
        "const float dz = m.rstd[t] * (m.g[o] * a.ln2s[j] - m.s1[t] -\n"
        "                                      m.a[o] * m.s2[t]);",
        "const float dz = m.rstd[t] * (m.g[o] * a.ln2s[j] - m.s1[t]);"),
}


@pytest.mark.parametrize("mutation", sorted(_MUTATIONS))
def test_backward_comparison_catches_mutations(tmp_path, mutation):
  src = _source()
  old, new = _MUTATIONS[mutation]
  assert src.count(old) == 1
  lib = build_host(tmp_path, src.replace(old, new))
  x, w, g = _case(2, 17, 64, 256)
  _, res, got = _rows(lib, x, w, g)
  want = att.layer_backward_rows(res, g, w)
  assert not all(np.allclose(a.numpy(), b.numpy(), **GRAD)
                 for a, b in zip(got, want))
