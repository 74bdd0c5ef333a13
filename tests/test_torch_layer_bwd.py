"""The fused layer's hand-derived backward (vision4leg_torch.ops.attention
`layer_forward_saved` + `layer_backward_math`, what the backward kernel
computes and what `fused_transformer_layer_ad` runs on the CPU) on the
CPU: against autograd of the plain layer `layer_math`, and against
`jax.grad` of the JAX package's layer (`_layer_math`, which its
`fused_transformer_layer_ad` differentiates off the TPU).

Inputs are drawn with numpy from a seed and handed to both sides.  In
float64 the two derivations agree to 1e-10: they are the same function's
gradient, and rounding at that precision stays far below it.  In float32
the tolerances are tests/test_pallas.py's for the JAX fused layer's
gradients, atol 3e-5 / rtol 1e-4: float32 sums taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention import _both, _np_weights
from vision4leg_tpu.ops import attention as jatt
from vision4leg_torch.ops import attention as att

GRAD = dict(atol=3e-5, rtol=1e-4)
GRAD64 = dict(atol=1e-10, rtol=1e-10)
FIELDS = ("x",) + att.LayerWeights._fields


def _case(B, T, D, F, dtype, seed=0):
  rng = np.random.default_rng(seed + B + D + F)
  x = (0.5 * rng.normal(size=(B, T, D))).astype(np.float32)
  g = rng.normal(size=(B, T, D)).astype(np.float32)
  w = _np_weights(rng, D, F)
  tt = lambda a: torch.tensor(a, dtype=dtype)
  return (tt(x), att.LayerWeights(**{k: tt(v) for k, v in w.items()}),
          tt(g), (x, w, g))


def _autograd(x, w, g):
  """(dx, *dw) of sum(layer_math(x, w) * g) by torch autograd."""
  inputs = [x.clone().requires_grad_(True)] + [
      t.clone().requires_grad_(True) for t in w]
  out = att.layer_math(inputs[0], att.LayerWeights(*inputs[1:]))
  return torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_saving_forward_is_the_plain_layer(dtype):
  x, w, _, _ = _case(3, 17, 64, 256, dtype)
  out, res = att.layer_forward_saved(x, w)
  assert torch.equal(out, att.layer_math(x, w))
  assert res.x is x
  B, T, D, F = 3, 17, 64, 256
  for name, t, s in zip(att.Residuals._fields[1:], res[1:],
                        att.residual_shapes(B, T, D, F)):
    assert tuple(t.shape) == s, name
  assert torch.equal(res.h > 0, (res.y.reshape(-1, D) @ w.w1 + w.b1
                                 ).reshape(B, T, F) > 0)


@pytest.mark.parametrize("B,T,D,F", [(4, 17, 64, 256), (2, 17, 16, 32),
                                     (3, 5, 24, 40), (1, 1, 8, 8)])
def test_backward_math_matches_autograd_float64(B, T, D, F):
  x, w, g, _ = _case(B, T, D, F, torch.float64)
  _, res = att.layer_forward_saved(x, w)
  got = att.layer_backward_math(res, g, w)
  for name, a, b in zip(FIELDS, got, _autograd(x, w, g)):
    assert a.shape == b.shape, name
    np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **GRAD64)


@pytest.mark.parametrize("B,T,D,F", [(4, 17, 64, 256), (2, 17, 16, 32)])
def test_backward_math_matches_autograd_float32(B, T, D, F):
  x, w, g, _ = _case(B, T, D, F, torch.float32)
  _, res = att.layer_forward_saved(x, w)
  got = att.layer_backward_math(res, g, w)
  for name, a, b in zip(FIELDS, got, _autograd(x, w, g)):
    np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **GRAD)


@pytest.mark.parametrize("B,T,D,F", [(4, 17, 64, 256), (2, 17, 16, 32),
                                     (3, 17, 32, 128)])
def test_fused_ad_matches_jax_grad(B, T, D, F):
  """fused_transformer_layer_ad on the CPU (saving forward + hand-derived
  backward) against jax.grad of the JAX package's layer math."""
  x, w, g, (xn, wn, gn) = _case(B, T, D, F, torch.float32, seed=7)
  jw, _ = _both(wn)

  def loss(x_, w_):
    return jnp.sum(jatt._layer_math(x_, w_, T, D) * gn)

  dx_ref, dw_ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(
      jnp.asarray(xn), jw)
  xt = x.clone().requires_grad_(True)
  wt = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
  before = att.fused_transformer_layer_bwd.launches
  out = att.fused_transformer_layer_ad(xt, wt)
  assert torch.equal(out, att.layer_math(x, w))
  torch.sum(out * g).backward()
  # the CPU path runs the plain versions: no kernel launch is counted
  assert att.fused_transformer_layer_bwd.launches == before
  np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), **GRAD)
  for name, a, b in zip(att.LayerWeights._fields, wt, dw_ref):
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=name,
                               **GRAD)


def test_fused_ad_saves_residuals_only_for_a_gradient(monkeypatch):
  """Under no_grad (collection, bootstraps, eval) the autograd function
  takes the inference forward, not the saving one."""
  x, w, _, _ = _case(2, 17, 16, 32, torch.float32)
  calls = []
  saved = att.fused_layer_forward_saved
  monkeypatch.setattr(att, "fused_layer_forward_saved",
                      lambda *a: calls.append(1) or saved(*a))
  wt = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
  with torch.no_grad():
    out = att.fused_transformer_layer_ad(x, wt)
  assert calls == [] and torch.equal(out, att.layer_math(x, w))
  att.fused_transformer_layer_ad(x, wt)
  assert calls == [1]


def test_backward_checks_reject_what_the_kernel_cannot_take():
  """`_launch_bwd`'s checks run before any launch: residuals that are not
  the saving forward's buffer, and a gradient of another shape or type."""
  x, w, g, _ = _case(2, 17, 16, 32, torch.float32)
  never = lambda *a: pytest.fail("launched")
  _, plain_res = att.layer_forward_saved(x, w)
  with pytest.raises(ValueError, match="residual k"):
    att._launch_bwd(plain_res, g, w, launch=never)
  _, res = att._launch(x, w, launch=lambda *a: 0, save=True)
  with pytest.raises(ValueError, match="g must be"):
    att._launch_bwd(res, g.double(), w, launch=never)
  with pytest.raises(ValueError, match="g must be"):
    att._launch_bwd(res, g[:1], w, launch=never)
  with pytest.raises(ValueError, match="residual h"):
    att._launch_bwd(res._replace(h=res.h.clone()), g, w, launch=never)
  with pytest.raises(ValueError, match="T <= 48"):
    att._launch_bwd(res._replace(x=torch.zeros(2, 49, 16)), g, w,
                    launch=never)


def test_gradient_comparison_holds_the_cpu_path_and_catches_faults():
  """`compare_grads_with_plain` (the end-to-end gradient gate of the card
  test and of chip_smoke.py) passes the CPU path of
  fused_transformer_layer_ad with nothing excused, and fails a layer
  whose backward is off by 0.1% or whose FFN bias is moved by 1e-3."""
  x, w, g, _ = _case(4, 17, 16, 32, torch.float32)
  ok, report = att.compare_grads_with_plain(x, w, g)
  assert ok, report
  assert all(r["excused"] == 0 and r["f32_spread"] > 0
             for r in report.values()), report

  class Scaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
      return y

    @staticmethod
    def backward(ctx, d):
      return d * 1.001

  ok, report = att.compare_grads_with_plain(
      x, w, g, run=lambda x_, w_: Scaled.apply(att.layer_math(x_, w_)))
  assert not ok and report["x"]["failed"] > 0

  def shifted(x_, w_):
    out, _ = att.layer_forward_saved(
        x_, w_._replace(b1=w_.b1 + 1e-3 * torch.randn(
            w_.b1.shape, generator=torch.Generator().manual_seed(0))))
    return out
  ok, _ = att.compare_grads_with_plain(x, w, g, run=shifted)
  assert not ok


@pytest.mark.parametrize("seed", [0, 1])
def test_key_bias_sum_is_the_exact_sum_of_dk_rows(seed):
  """The key bias's gradient, sum over dk's rows, is taken from the
  softmax's shift invariance (`layer_backward_rows`, as the backward
  kernel takes it): in float32 it equals the float64 sum of the rows of
  dk computed from the same float32 residuals, where summing dk's
  float32 rows leaves rounding noise larger than the sum itself."""
  x, w, g, _ = _case(64, 17, 64, 256, torch.float32, seed=seed)
  D = 64
  _, res = att.layer_forward_saved(x, w)
  rows = att.layer_backward_rows(res, g, w)
  d = lambda t: t.double()
  rows64 = att.layer_backward_rows(att.Residuals(*map(d, res)), d(g),
                                   att.LayerWeights(*map(d, w)))
  ref = rows64.dqkv[..., D:2 * D].sum(1)
  np.testing.assert_allclose(rows.sums[:, D:2 * D].double().numpy(),
                             ref.numpy(), atol=1e-12, rtol=0)
  naive = rows.dqkv[..., D:2 * D].sum(1).double()
  assert float((naive - ref).abs().max()) > 100 * 1e-12


def test_backward_refuses_a_shape_past_shared_memory():
  """T = 48 at D = 128, F = 512 is a forward the kernel takes, but one
  backward block would need 266.5 KB of shared memory: `_launch_bwd`
  raises before any launch; T = 33 at the main widths fits (94.8 KB)."""
  assert att.bwd_smem_bytes(33, 64, 256) == 94776
  assert att.bwd_smem_bytes(48, 128, 512) > att.SMEM_MAX
  x, w, g, _ = _case(1, 48, 128, 512, torch.float32)
  _, res = att._launch(x, w, launch=lambda *a: 0, save=True)
  with pytest.raises(ValueError, match="shared memory"):
    att._launch_bwd(res, g, w, launch=lambda *a: pytest.fail("launched"))
