"""The port's network heads (vision4leg_torch.models.nets) against the
JAX package's flax heads (vision4leg_tpu.models.nets) on the CPU: each
head's flax parameters, drawn from a seed, mapped by
`convert.nets_params_from_flax`, and both forwards on the same seeded
observations.  Float32 on both sides; outputs within 1e-5 absolute and
relative (a handful of float32 convolutions, products and LayerNorms
summed in the frameworks' own orders: ~1e-7 apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.models import nets as jnets
from vision4leg_torch.convert import nets_params_from_flax
from vision4leg_torch.models import nets

TOL = dict(atol=1e-5, rtol=1e-5)
STATE = 12
IMG = (4, 64, 64)
LAYERS = ((1, 32), (1, 32))

CASES = {
    "Net": (jnets.Net(3, (16, 16), (8,)),
            lambda: nets.Net(3, STATE, (16, 16), (8,)), STATE),
    "LocoTransformer": (
        jnets.LocoTransformer(3, STATE, IMG, (16,), LAYERS, (16,), 16),
        lambda: nets.LocoTransformer(3, STATE, IMG, (16,), LAYERS, (16,), 16),
        STATE + 4 * 64 * 64),
    "LocoTransformer token_norm max_pool two_by_two": (
        jnets.LocoTransformer(3, STATE, IMG, (16,), LAYERS, (16,), 16,
                              max_pool=True, token_norm=True,
                              two_by_two=True),
        lambda: nets.LocoTransformer(3, STATE, IMG, (16,), LAYERS, (16,), 16,
                                     max_pool=True, token_norm=True,
                                     two_by_two=True),
        STATE + 4 * 64 * 64),
    "LocoTransformer rgbd": (
        jnets.LocoTransformer(3, STATE, (16, 64, 64), (16,), LAYERS[:1],
                              (16,), 16),
        lambda: nets.LocoTransformer(3, STATE, (16, 64, 64), (16,),
                                     LAYERS[:1], (16,), 16),
        STATE + 16 * 64 * 64),
    "Transformer": (
        jnets.Transformer(3, STATE, IMG, (16,), LAYERS, (16,), 16),
        lambda: nets.Transformer(3, STATE, IMG, (16,), LAYERS, (16,), 16),
        STATE + 4 * 64 * 64),
    "NatureFuseNet": (
        jnets.NatureFuseNet(3, STATE, IMG, (16,), 24, (16,)),
        lambda: nets.NatureFuseNet(3, STATE, IMG, (16,), 24, (16,)),
        STATE + 4 * 64 * 64),
}


@pytest.mark.parametrize("name", list(CASES))
def test_head_matches_flax(name):
  flax_net, make, dim = CASES[name]
  params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, dim)))
  obs = np.random.default_rng(1).normal(size=(3, dim)).astype(np.float32)
  ref = np.asarray(flax_net.apply(params, jnp.asarray(obs)))
  net = make()
  net.load_state_dict(nets_params_from_flax(
      jax.tree.map(np.asarray, params)), strict=True)
  with torch.no_grad():
    got = net(torch.from_numpy(obs)).numpy()
  np.testing.assert_allclose(got, ref, **TOL)


def test_init_weights_draws_from_the_generator():
  """The reference's initializers from an explicit generator: two heads
  from one seed are equal, from another differ."""
  def make(seed):
    net = nets.LocoTransformer(3, STATE, IMG, (16,), LAYERS, (16,), 16)
    net.init_weights(torch.Generator().manual_seed(seed))
    return net.state_dict()
  a, b, c = make(0), make(0), make(1)
  assert all(torch.equal(a[k], b[k]) for k in a)
  assert any(not torch.equal(a[k], c[k]) for k in a)


def test_unknown_layout_raises():
  with pytest.raises(ValueError, match="unknown layout"):
    nets_params_from_flax({"params": {"Foo_0": {}}})
