"""Parity of the port's vision-only LocoTransformer (VisionTokenEncoder,
VisionOnlyTransformerActorCritic) with the flax modules of the JAX
package, on the CPU, on weights carried across by params_from_flax.

The observations and the flax weights are made from seeds once; both
frameworks compute the same function in float32, so outputs are held at
atol 1e-5.  The transformer layers run unfused (the flax path) on the
JAX side; on the port's side both the plain layer and `fused=True`
(which on the CPU is the fused layer's plain version) are held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.algo.on_policy_base import param_labels as jparam_labels
from vision4leg_tpu.models.actor_critic import \
    VisionOnlyTransformerActorCritic as FlaxVisionOnly
from vision4leg_tpu.models.base import VisionTokenEncoder as FlaxTokens
from vision4leg_torch.algo.on_policy_base import MaskedAdam, param_labels
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.convert import encoder_from_flax, params_from_flax
from vision4leg_torch.models.actor_critic import \
    VisionOnlyTransformerActorCritic
from vision4leg_torch.models.base import VisionTokenEncoder

TOL = dict(atol=1e-5, rtol=0)
B = 5
PROPRIO = 3            # ignored by the model; the MPC env's is 0
OBS = PROPRIO + 4 * 64 * 64
WIDTHS = dict(action_dim=2, state_input_shape=PROPRIO,
              visual_input_shape=(4, 64, 64),
              transformer_params=((1, 48), (1, 48)),
              append_hidden_shapes=(24, 24), token_dim=32)


def _obs():
  rng = np.random.default_rng(0)
  return rng.uniform(0.0, 1.0, (B, OBS)).astype(np.float32)


@pytest.mark.parametrize("two_by_two", [False, True])
def test_token_encoder_matches_flax(two_by_two):
  flax_enc = FlaxTokens(in_channels=4, token_dim=32, two_by_two=two_by_two)
  img = _obs()[:, PROPRIO:].reshape(B, 4, 64, 64)
  params = flax_enc.init(jax.random.PRNGKey(1), jnp.asarray(img))
  ref = np.asarray(flax_enc.apply(params, jnp.asarray(img)))
  enc = VisionTokenEncoder(4, token_dim=32, two_by_two=two_by_two)
  enc.load_state_dict(encoder_from_flax(
      jax.tree.map(np.asarray, params)["params"]))
  with torch.no_grad():
    got = enc(torch.tensor(img))
  # the fused layer's kernel takes contiguous tokens only
  assert got.is_contiguous()
  got = got.numpy()
  tokens = 4 if two_by_two else 16
  assert got.shape == ref.shape == (B, tokens, 32)
  assert enc.per_modal_tokens == tokens
  np.testing.assert_allclose(got, ref, **TOL)


@pytest.fixture(scope="module", params=[False, True],
                ids=["mean_pool", "max_pool"])
def pair(request):
  """The flax model and the port's on the same weights; their outputs on
  the same observations."""
  flax_net = FlaxVisionOnly(max_pool=request.param, **WIDTHS)
  obs = _obs()
  params = flax_net.init(jax.random.PRNGKey(2), jnp.asarray(obs))
  x = jnp.asarray(obs)
  ref = {m: jax.tree.map(np.asarray, flax_net.apply(
      params, x, method=getattr(flax_net, m))) for m in ("pi", "v", "pi_v")}
  net = VisionOnlyTransformerActorCritic(max_pool=request.param, **WIDTHS)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
  return net, torch.tensor(obs), ref, params


@pytest.mark.parametrize("fused", [False, True])
def test_pi_v_and_pi_v_match_flax(pair, fused):
  net, obs, ref, _ = pair
  with torch.no_grad():
    got = {"pi": net.pi(obs, fused=fused), "v": net.v(obs, fused=fused),
           "pi_v": net.pi_v(obs, fused=fused)}
  for mean, std, logstd in (got["pi"], got["pi_v"][0]):
    np.testing.assert_allclose(mean.numpy(), ref["pi"][0], **TOL)
    np.testing.assert_allclose(std.numpy(), ref["pi"][1], **TOL)
    np.testing.assert_allclose(logstd.numpy(), ref["pi"][2], **TOL)
  for v in (got["v"], got["pi_v"][1]):
    assert v.shape == (B, 1)
    np.testing.assert_allclose(v.numpy(), ref["v"], **TOL)
  np.testing.assert_allclose(ref["pi_v"][1], ref["v"], **TOL)


def test_proprio_head_is_ignored(pair):
  """Only the image tail reaches the output: the proprio head may hold
  anything."""
  net, obs, _, _ = pair
  moved = obs.clone()
  moved[:, :PROPRIO] += 100.0
  with torch.no_grad():
    (m0, _, _), v0 = net.pi_v(obs)
    (m1, _, _), v1 = net.pi_v(moved)
  assert torch.equal(m0, m1) and torch.equal(v0, v1)


def test_param_labels_split_as_the_jax_learner(pair):
  """The pf and vf optimizers take the parameters that the JAX learner's
  masks give them: the encoder both; the pf stack, pf MLP and the head's
  logstd the policy; the vf stack and MLP the value."""
  net, _, _, params = pair
  jl = jparam_labels(params)
  to_torch = {"encoder": "encoder", "head": "logstd", "pf_mlp": "pf_mlp",
              "vf_mlp": "vf_mlp"}
  want = {to_torch.get(k, k.rsplit("_", 1)[0]): v for k, v in jl.items()}
  assert param_labels(net) == want == {
      "encoder": "both", "pf_layers": "pf", "vf_layers": "vf",
      "pf_mlp": "pf", "vf_mlp": "vf", "logstd": "pf"}
  cfg = PPOConfig()
  pf, vf = MaskedAdam(cfg, net, "pf", 1.0), MaskedAdam(cfg, net, "vf", 1.0)
  assert set(pf.names) & set(vf.names) == {
      n for n, _ in net.named_parameters() if n.startswith("encoder.")}
  assert set(pf.names) | set(vf.names) == {
      n for n, _ in net.named_parameters()}


def test_rgbd_is_refused_loudly():
  """The tokenizer takes depth (4), rgb (12) and rgbd (16) channels and
  refuses any other count; the rgb models are held in
  tests/test_torch_rgb_models.py."""
  with pytest.raises(ValueError, match="rgbd"):
    VisionOnlyTransformerActorCritic(
        **{**WIDTHS, "visual_input_shape": (8, 64, 64)})
  net = VisionOnlyTransformerActorCritic(
      **{**WIDTHS, "visual_input_shape": (16, 64, 64)})
  assert net.encoder.per_modal_tokens == 16
