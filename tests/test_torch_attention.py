"""Parity of the port's fused transformer layer (vision4leg_torch.ops.
attention) with the JAX package's (vision4leg_tpu.ops.attention), on the
CPU, where both run their plain math: torch `layer_math`, JAX
`_layer_math` (which `fused_transformer_layer` takes off the TPU).

Inputs are drawn with numpy from a seed and handed to both sides.
Tolerances are those of tests/test_pallas.py for the JAX fused layer:
forward atol 2e-5 / rtol 1e-4, gradients atol 3e-5 / rtol 1e-4 (model
gradients rtol 2e-4), float32 sums taken in another order by the two
frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_tpu.ops import attention as jatt
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
from vision4leg_torch.models.base import TransformerEncoderLayer
from vision4leg_torch.ops import attention as att

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=3e-5, rtol=1e-4)

STATE = 40
OBS = STATE + 4 * 64 * 64
WIDTHS = dict(action_dim=6, state_input_shape=STATE,
              visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32,),
              transformer_params=((1, 64), (1, 64)),
              append_hidden_shapes=(32,), token_dim=64)


def _np_weights(rng, D, F):
  """LayerWeights as numpy arrays: lecun-scale matrices, LayerNorm scales
  and all biases off their init values."""
  out = {}
  for name, x in zip(jatt.LayerWeights._fields, range(16)):
    shape = dict(wq=(D, D), wk=(D, D), wv=(D, D), wo=(D, D), w1=(D, F),
                 w2=(F, D), b1=(F,)).get(name, (D,))
    if len(shape) == 2:
      v = rng.normal(0, 1 / np.sqrt(shape[0]), shape)
    elif "scale" in name:
      v = 1 + 0.1 * rng.normal(size=shape)
    else:
      v = 0.1 * rng.normal(size=shape)
    out[name] = v.astype(np.float32)
  return out


def _both(w):
  return (jatt.LayerWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
          att.LayerWeights(**{k: torch.tensor(v) for k, v in w.items()}))


@pytest.mark.parametrize("B,T,D,F", [(8, 17, 64, 256), (5, 17, 64, 256),
                                     (3, 9, 32, 48)])
def test_layer_math_matches_jax(B, T, D, F):
  rng = np.random.default_rng(B + T)
  x = (0.5 * rng.normal(size=(B, T, D))).astype(np.float32)
  jw, tw = _both(_np_weights(rng, D, F))
  ref = np.asarray(jatt._layer_math(jnp.asarray(x), jw, T, D))
  ref_fused = np.asarray(jax.jit(jatt.fused_transformer_layer)(
      jnp.asarray(x), jw))
  got = att.layer_math(torch.tensor(x), tw).numpy()
  got_fused = att.fused_transformer_layer(torch.tensor(x), tw).numpy()
  np.testing.assert_allclose(got, ref, **FWD)
  np.testing.assert_allclose(got_fused, ref_fused, **FWD)
  # the CPU path of the wrapper is the plain version itself
  np.testing.assert_array_equal(got_fused, got)


@pytest.mark.parametrize("B", [8, 3])
def test_fused_layer_gradients_match_jax(B):
  """The cases of tests/test_pallas.py:81-111: (dx, dw) of a weighted sum
  of the layer's output, through fused_transformer_layer_ad on both
  sides."""
  D, T, F = 64, 17, 256
  rng = np.random.default_rng(10 + B)
  x = (0.5 * rng.normal(size=(B, T, D))).astype(np.float32)
  g = rng.normal(size=(B, T, D)).astype(np.float32)
  jw, tw = _both(_np_weights(rng, D, F))

  def loss(x_, w_):
    return jnp.sum(jatt.fused_transformer_layer_ad(x_, w_) * g)

  dx_ref, dw_ref = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                            jw)
  xt = torch.tensor(x, requires_grad=True)
  wt = att.LayerWeights(*[t.clone().requires_grad_(True) for t in tw])
  out = att.fused_transformer_layer_ad(xt, wt)
  torch.sum(out * torch.tensor(g)).backward()
  np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), **GRAD)
  for name, a, b in zip(att.LayerWeights._fields, wt, dw_ref):
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=name,
                               **GRAD)
  # and against autograd of the plain version
  xp = torch.tensor(x, requires_grad=True)
  wp = att.LayerWeights(*[t.clone().requires_grad_(True) for t in tw])
  torch.sum(att.layer_math(xp, wp) * torch.tensor(g)).backward()
  np.testing.assert_allclose(xt.grad.numpy(), xp.grad.numpy(), **GRAD)
  for name, a, b in zip(att.LayerWeights._fields, wt, wp):
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), err_msg=name,
                               **GRAD)


@pytest.fixture(scope="module")
def nets():
  flax_net = FlaxAC(**WIDTHS)
  params = flax_net.init(jax.random.PRNGKey(2), jnp.zeros((1, OBS)))
  net = LocoTransformerActorCritic(**WIDTHS)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                      strict=True)
  rng = np.random.default_rng(3)
  obs = (0.3 * rng.normal(size=(4, OBS))).astype(np.float32)
  return flax_net, params, net, obs


def _leaves(tree):
  return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("method", ["pi", "v", "pi_v"])
def test_model_fused_matches_unfused_and_flax(nets, method):
  flax_net, params, net, obs = nets
  ref = flax_net.apply(params, jnp.asarray(obs), fused=True,
                       method=getattr(flax_net, method))
  with torch.no_grad():
    fused = getattr(net, method)(torch.tensor(obs), fused=True)
    plain = getattr(net, method)(torch.tensor(obs))
  for r, a, b in zip(jax.tree.leaves(ref), _leaves(fused), _leaves(plain)):
    np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD)
    np.testing.assert_allclose(a.numpy(), np.asarray(r), **FWD)


def test_model_fused_update_gradients_match_flax(nets):
  """Gradients through pi(fused=True), the closure the PPO update runs
  with the fused update on (tests/test_pallas.py:114-137)."""
  flax_net, params, net, obs = nets

  def loss(p):
    mean, _, logstd = flax_net.apply(p, jnp.asarray(obs), fused=True,
                                     method=flax_net.pi)
    return jnp.sum(mean ** 2) + jnp.sum(logstd)

  ref = params_from_flax(jax.tree.map(
      np.asarray, jax.jit(jax.grad(loss))(params)))
  grads = {}
  for fused in (True, False):
    net.zero_grad()
    mean, _, logstd = net.pi(torch.tensor(obs), fused=fused)
    (torch.sum(mean ** 2) + torch.sum(logstd)).backward()
    grads[fused] = {n: p.grad.clone() for n, p in net.named_parameters()
                    if p.grad is not None}
  assert set(grads[True]) == set(grads[False])
  assert any(n.startswith("pf_layers.1.") for n in grads[True])
  for n, g in grads[True].items():
    np.testing.assert_allclose(g.numpy(), grads[False][n].numpy(),
                               atol=3e-5, rtol=2e-4, err_msg=n)
    np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=3e-5,
                               rtol=2e-4, err_msg=n)


def test_weights_from_layer_matches_weights_from_flax(nets):
  _, params, net, _ = nets
  for side in ("pf", "vf"):
    for i, layer in enumerate(getattr(net, f"{side}_layers")):
      ref = jatt.weights_from_flax(params["params"][f"{side}_layers_{i}"],
                                   64)
      got = att.weights_from_layer(layer)
      for name, a, b in zip(att.LayerWeights._fields, got, ref):
        assert a.is_contiguous(), name
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b),
                                      err_msg=name)


def test_fused_refuses_what_the_kernel_does_not_take():
  x = torch.zeros(2, 5, 16)
  with pytest.raises(NotImplementedError, match="one head"):
    TransformerEncoderLayer(16, 2, 32)(x, fused=True)
  with pytest.raises(NotImplementedError, match="float32"):
    TransformerEncoderLayer(16, 1, 32).double()(x.double(), fused=True)
  w = att.weights_from_layer(TransformerEncoderLayer(16, 1, 32))
  w = att.LayerWeights(*[t.detach() for t in w])
  assert att.check_inputs(x, w) == (2, 5, 16, 32)
  with pytest.raises(ValueError, match="T <= 48"):
    att.check_inputs(torch.zeros(2, 49, 16), w)
  with pytest.raises(ValueError, match="B >= 1"):
    att.check_inputs(torch.zeros(0, 5, 16), w)
  with pytest.raises(ValueError, match="not contiguous"):
    att.check_inputs(torch.zeros(5, 2, 16).transpose(0, 1), w)
  with pytest.raises(TypeError, match="float32"):
    att.check_inputs(x.double(), w)
  with pytest.raises(ValueError, match="shape"):
    att.check_inputs(x, w._replace(wq=w.wq[:8].contiguous()))
  with pytest.raises(ValueError, match="unsupported device"):
    att.fused_transformer_layer(x.to("meta"), w)


def test_max_pool_matches_flax():
  """The max_pool option of the actor-critic (actor_critic.py:129-137 of
  the JAX package), through the fused layers."""
  widths = dict(WIDTHS, max_pool=True)
  flax_net = FlaxAC(**widths)
  params = flax_net.init(jax.random.PRNGKey(7), jnp.zeros((1, OBS)))
  net = LocoTransformerActorCritic(**widths)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
  obs = (0.3 * np.random.default_rng(8).normal(size=(3, OBS))).astype(
      np.float32)
  ref = flax_net.apply(params, jnp.asarray(obs), fused=True,
                       method=flax_net.pi_v)
  with torch.no_grad():
    got = net.pi_v(torch.tensor(obs), fused=True)
    mean_pooled = LocoTransformerActorCritic(**WIDTHS)
    mean_pooled.load_state_dict(net.state_dict())
    other = mean_pooled.pi_v(torch.tensor(obs), fused=True)
  for r, g in zip(jax.tree.leaves(ref), _leaves(got)):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD)
  assert not torch.allclose(got[1], other[1])
