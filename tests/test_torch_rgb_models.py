"""Parity of the port's rgb and rgbd tokenizers and actor-critics with the
flax modules of the JAX package, on the CPU, on weights carried across by
params_from_flax.

12 channels are four rgb frames, 16 are rgbd (rgb first, depth the last
four).  No env produces them (the JAX env ignores `rgbd` and the port's
refuses it), so they are held at model level only, as the JAX package's
own tests hold them.  The 16-channel LocoTransformer has 1 + 16 + 16 = 33
tokens and the vision-only one 32: with `fused=True` the port runs the
fused layer's plain route at those T on the CPU (the card's kernel takes
T <= 48, tests/test_torch_attention_cuda.py).  Small widths, observations
and flax weights made from seeds; both frameworks compute the same float32
function, so outputs are held at atol 1e-5 / rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.models import actor_critic as jac
from vision4leg_tpu.models import base as jbase
from vision4leg_torch.convert import (encoder_channels, encoder_from_flax,
                                      params_from_flax)
from vision4leg_torch.models import actor_critic as tac
from vision4leg_torch.models import base as tbase

TOL = dict(atol=1e-5, rtol=1e-5)
B = 4
PROPRIO = 7
WIDTHS = dict(action_dim=3, state_input_shape=PROPRIO,
              encoder_hidden_shapes=(24, 24),
              transformer_params=((1, 40), (1, 40)),
              append_hidden_shapes=(16, 16), token_dim=32)


def _obs(channels, seed=0):
  rng = np.random.default_rng(seed)
  obs = rng.normal(size=(B, PROPRIO + channels * 64 * 64)).astype(np.float32)
  obs[:, PROPRIO:] = rng.uniform(0.0, 1.0, obs[:, PROPRIO:].shape)
  return obs


def _leaves_close(got, ref):
  ref_l = jax.tree.leaves(ref)
  got_l = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
  assert len(ref_l) == len(got_l)
  for r, g in zip(ref_l, got_l):
    assert tuple(g.shape) == tuple(np.shape(r))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("channels", [4, 12, 16])
@pytest.mark.parametrize("two_by_two", [False, True])
def test_loco_encoder_matches_flax(channels, two_by_two):
  """LocoTransformerEncoder: tokens state, [rgb], [depth]; two_by_two
  gives 4 tokens a modality."""
  obs = _obs(channels, seed=channels)
  img = jnp.asarray(obs[:, PROPRIO:].reshape(B, channels, 64, 64))
  state = jnp.asarray(obs[:, :PROPRIO])
  flax_enc = jbase.LocoTransformerEncoder(
      in_channels=channels, hidden_shapes=(24, 24), token_dim=32,
      two_by_two=two_by_two)
  params = jax.tree.map(np.asarray, flax_enc.init(jax.random.PRNGKey(2),
                                                  img, state))["params"]
  assert encoder_channels(params) == channels
  ref = np.asarray(flax_enc.apply({"params": params}, img, state))
  enc = tbase.LocoTransformerEncoder(channels, PROPRIO, (24, 24), 32,
                                     two_by_two=two_by_two)
  enc.load_state_dict(encoder_from_flax(params), strict=True)
  with torch.no_grad():
    got = enc(torch.tensor(np.asarray(img)), torch.tensor(np.asarray(state)))
  per = 4 if two_by_two else 16
  n_modal = 2 if channels == 16 else 1
  assert got.shape == ref.shape == (B, 1 + n_modal * per, 32)
  np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("channels", [12, 16])
@pytest.mark.parametrize("two_by_two", [False, True])
def test_vision_encoder_matches_flax(channels, two_by_two):
  """VisionTokenEncoder: tokens depth, rgb on 16 channels."""
  img = _obs(channels, seed=10 + channels)[:, PROPRIO:].reshape(
      B, channels, 64, 64)
  flax_enc = jbase.VisionTokenEncoder(in_channels=channels, token_dim=32,
                                      two_by_two=two_by_two)
  params = jax.tree.map(np.asarray, flax_enc.init(
      jax.random.PRNGKey(3), jnp.asarray(img)))["params"]
  ref = np.asarray(flax_enc.apply({"params": params}, jnp.asarray(img)))
  enc = tbase.VisionTokenEncoder(channels, 32, two_by_two=two_by_two)
  enc.load_state_dict(encoder_from_flax(params), strict=True)
  with torch.no_grad():
    got = enc(torch.tensor(img))
  assert got.is_contiguous()
  assert got.shape == ref.shape
  np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _pair(flax_cls, torch_cls, channels, seed):
  widths = dict(WIDTHS, visual_input_shape=(channels, 64, 64))
  if flax_cls is jac.VisionOnlyTransformerActorCritic:
    widths.pop("encoder_hidden_shapes")
  flax_net = flax_cls(**widths)
  obs = _obs(channels, seed)
  params = flax_net.init(jax.random.PRNGKey(seed), jnp.asarray(obs[:1]))
  # the logstd off its init value, so that its conversion shows
  params = jax.tree_util.tree_map_with_path(
      lambda p, x: x + 0.1 if "logstd" in jax.tree_util.keystr(p) else x,
      params)
  net = torch_cls(**dict(WIDTHS, visual_input_shape=(channels, 64, 64)))
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                      strict=True)
  return flax_net, params, net, obs


@pytest.mark.parametrize("kind,channels,tokens", [
    ("loco", 12, 17), ("loco", 16, 33),
    ("vision", 12, 16), ("vision", 16, 32)])
def test_rgb_actor_critics_match_flax(kind, channels, tokens):
  """pi, v and pi_v of the rgb and rgbd actor-critics against flax, the
  port's layers unfused and through the fused layer's plain route (the
  T of the tokens it sees is checked)."""
  flax_cls, torch_cls = {
      "loco": (jac.LocoTransformerActorCritic,
               tac.LocoTransformerActorCritic),
      "vision": (jac.VisionOnlyTransformerActorCritic,
                 tac.VisionOnlyTransformerActorCritic)}[kind]
  flax_net, params, net, obs = _pair(flax_cls, torch_cls, channels,
                                     seed=channels)
  x = torch.tensor(obs)
  with torch.no_grad():
    assert net._tokens(x).shape == (B, tokens, 32)
  for method in ("pi", "v", "pi_v"):
    ref = flax_net.apply(params, jnp.asarray(obs),
                         method=getattr(flax_net, method))
    for fused in (False, True):
      with torch.no_grad():
        got = getattr(net, method)(x, fused=fused)
      _leaves_close(got, ref)


def test_fused_route_gradients_at_33_tokens():
  """Under autograd the 16-channel LocoTransformer's fused route (the
  plain forward with residuals and the hand-derived backward on the CPU)
  gives autograd's gradients of the unfused model."""
  _, _, net, obs = _pair(jac.LocoTransformerActorCritic,
                         tac.LocoTransformerActorCritic, 16, seed=5)
  x = torch.tensor(obs)
  grads = []
  for fused in (False, True):
    net.zero_grad()
    (mean, _, _), value = net.pi_v(x, fused=fused)
    (mean.square().sum() + value.sum()).backward()
    grads.append({n: p.grad.clone() for n, p in net.named_parameters()
                  if p.grad is not None})
  assert grads[0].keys() == grads[1].keys()
  assert any(n.startswith("pf_layers.1.") for n in grads[0])
  for n in grads[0]:
    np.testing.assert_allclose(grads[1][n].numpy(), grads[0][n].numpy(),
                               atol=1e-5, rtol=1e-4, err_msg=n)


def test_unknown_tokenizer_layouts_raise():
  with pytest.raises(ValueError, match="rgbd"):
    tbase.LocoTransformerEncoder(8, PROPRIO, (24,), 32)
  img = jnp.zeros((1, 4, 64, 64))
  params = jax.tree.map(np.asarray, jbase.VisionTokenEncoder(
      in_channels=4, token_dim=8).init(jax.random.PRNGKey(0), img))["params"]
  params["NatureEncoder_2"] = params["NatureEncoder_0"]
  with pytest.raises(ValueError, match="unknown tokenizer layout"):
    encoder_from_flax(params)
