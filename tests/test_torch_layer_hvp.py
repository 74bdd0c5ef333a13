"""Second derivatives through the transformer layer, on the CPU.

The fused layer's backward (`attention._FusedLayerAD`, the backward
kernel on the card, `layer_backward_math` here) runs on saved residuals
that carry no graph, so a Hessian-vector product through it would come
out wrong; it is once-differentiable and raises, as forward-mode
differentiation of the JAX package's custom_vjp layer raises.  The plain
layer `layer_math` has a true second derivative: its Hessian-vector
product of sum(y^2) matches JAX's jax.jvp(jax.grad(...)) of the JAX
package's plain layer (`_layer_math`, its float32 accumulation type
raised to float64 for this comparison) within 1e-9 in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention import _np_weights
from vision4leg_tpu.ops import attention as jatt
from vision4leg_torch.ops import attention as att

B, T, D, F = 3, 5, 16, 32
HVP64 = dict(atol=1e-9, rtol=1e-9)


class _Float64Jnp:
  """jnp with float32 read as float64: `_layer_math` asks its products to
  accumulate in jnp.float32."""

  def __getattr__(self, name):
    return jnp.float64 if name == "float32" else getattr(jnp, name)


def _case():
  rng = np.random.default_rng(7)
  x = 0.5 * rng.normal(size=(B, T, D))
  w = {k: v.astype(np.float64) for k, v in _np_weights(rng, D, F).items()}
  v = {k: rng.normal(size=a.shape) for k, a in w.items()}
  return x, w, v


def _torch_hvp(layer_fn, x, w, v):
  ws = [torch.tensor(w[k]).requires_grad_(True)
        for k in att.LayerWeights._fields]
  y = layer_fn(torch.tensor(x), att.LayerWeights(*ws))
  gs = torch.autograd.grad((y ** 2).sum(), ws, create_graph=True)
  dot = sum((g * torch.tensor(v[k])).sum()
            for g, k in zip(gs, att.LayerWeights._fields))
  return torch.autograd.grad(dot, ws, allow_unused=True)


def test_fused_layer_second_derivative_raises():
  x, w, v = _case()
  with pytest.raises(RuntimeError, match="once-differentiable"):
    _torch_hvp(att.fused_transformer_layer_ad, x, w, v)


def test_fused_layer_first_derivative_unchanged():
  """The first-order gradients through the fused layer still equal the
  plain layer's (create_graph off)."""
  x, w, _ = _case()
  out = []
  for fn in (att.fused_transformer_layer_ad, att.layer_math):
    ws = [torch.tensor(w[k]).requires_grad_(True)
          for k in att.LayerWeights._fields]
    y = fn(torch.tensor(x), att.LayerWeights(*ws))
    out.append(torch.autograd.grad((y ** 2).sum(), ws))
  for name, a, b in zip(att.LayerWeights._fields, *out):
    np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                               atol=1e-10, rtol=1e-10)


def test_plain_layer_hvp_matches_jax(monkeypatch):
  x, w, v = _case()
  got = _torch_hvp(att.layer_math, x, w, v)
  monkeypatch.setattr(jatt, "jnp", _Float64Jnp())
  with jax.enable_x64(True):
    jx = jnp.asarray(x)

    def loss(wd):
      y = jatt._layer_math(jx, jatt.LayerWeights(**wd), T, D)
      return jnp.sum(y ** 2)

    wd = {k: jnp.asarray(a) for k, a in w.items()}
    vd = {k: jnp.asarray(a) for k, a in v.items()}
    _, ref = jax.jvp(jax.grad(loss), (wd,), (vd,))
    ref = {k: np.asarray(a) for k, a in ref.items()}
  for name, g in zip(att.LayerWeights._fields, got):
    assert ref[name].dtype == np.float64
    np.testing.assert_allclose(g.numpy(), ref[name], err_msg=name, **HVP64)
