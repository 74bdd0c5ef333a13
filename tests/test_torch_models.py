"""Parity of the torch LocoTransformer actor-critic with the flax module,
weights converted by vision4leg_torch.convert.params_from_flax.

Small widths (encoder 32-32, token 32, one 2-head and one 1-head layer,
heads 32-32) on the thin-goal observation layout (84 proprio + 4x64x64
depth).  Tolerance 2e-5: float32 convolutions and attention on the CPU
summed in different orders, on outputs of O(0.01..1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic

STATE = 84
OBS = STATE + 4 * 64 * 64
WIDTHS = dict(action_dim=6, state_input_shape=STATE,
              visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32, 32),
              transformer_params=((2, 64), (1, 64)),
              append_hidden_shapes=(32, 32), token_dim=32)


@pytest.fixture(scope="module")
def nets():
  flax_net = FlaxAC(**WIDTHS)
  params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
  # move the logstd off its init value so the conversion of it shows
  params = jax.tree_util.tree_map_with_path(
      lambda p, x: x + 0.1 if "logstd" in jax.tree_util.keystr(p) else x,
      params)
  net = LocoTransformerActorCritic(**WIDTHS)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                      strict=True)
  rng = np.random.default_rng(0)
  obs = rng.normal(size=(3, OBS)).astype(np.float32)
  obs[:, STATE:] = rng.uniform(-1.5, 2.0, size=(3, OBS - STATE))
  return flax_net, params, net, obs


@pytest.mark.parametrize("method", ["pi", "v", "pi_v"])
def test_forward_matches_flax(nets, method):
  flax_net, params, net, obs = nets
  ref = flax_net.apply(params, jnp.asarray(obs),
                       method=getattr(flax_net, method))
  with torch.no_grad():
    got = getattr(net, method)(torch.tensor(obs))
  ref_l = jax.tree.leaves(ref)
  got_l = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
  assert len(ref_l) == len(got_l)
  for r, g in zip(ref_l, got_l):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                               rtol=1e-4)


def test_layer_norm_eps_is_flax_default(nets):
  _, _, net, _ = nets
  eps = {m.eps for m in net.modules() if isinstance(m, torch.nn.LayerNorm)}
  assert eps == {1e-6}


def test_seeded_init_follows_the_reference():
  """Weights drawn from a generator: reproducible, the reference's bounds
  (fan-out uniform with bias 0.1, U(+-3e-3) output layers, log(0.125)
  logstd)."""
  a = LocoTransformerActorCritic(**WIDTHS, generator=torch.Generator()
                                 .manual_seed(4))
  b = LocoTransformerActorCritic(**WIDTHS, generator=torch.Generator()
                                 .manual_seed(4))
  for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
    assert torch.equal(x, y), n
  w = a.encoder.state_mlp.layers[0].weight
  assert float(w.detach().abs().max()) <= 1 / 32 ** 0.5
  assert torch.all(a.encoder.state_mlp.layers[0].bias == 0.1)
  assert float(a.pf_mlp.layers[-1].weight.detach().abs().max()) <= 3e-3
  np.testing.assert_allclose(a.logstd.detach().numpy(), np.log(0.125),
                             rtol=1e-6)
