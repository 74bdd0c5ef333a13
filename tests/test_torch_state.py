"""The port's proprio-only model (StateActorCritic) against the flax
module, weights converted by vision4leg_torch.convert.params_from_flax,
and the `ppo_state` starter on config/rl/static/state-only-baseline.json.

Tolerances: the forwards at the starter's full width (base 256-256,
heads 256-256) on 4 rows, atol 2e-5 / rtol 1e-4 as tests/test_torch_models
.py; the gradients of one loss over `pi_v` the same (float32 sums of 256
products in different orders).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.algo.on_policy_base import \
    param_labels as jax_param_labels
from vision4leg_tpu.models import actor_critic as jac
from vision4leg_torch.algo.agent import PPOAgent
from vision4leg_torch.algo.on_policy_base import param_labels
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.models import actor_critic as tac
from vision4leg_torch.starter import ppo_state
from vision4leg_torch.utils.logger import Logger

CONFIG = os.path.join(os.path.dirname(__file__), "..", "config", "rl",
                      "static", "state-only-baseline.json")
WIDTHS = dict(action_dim=6, hidden_shapes=(256, 256),
              append_hidden_shapes=(256, 256))
OBS = 84
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  """Small eager ops: with the suite's workers sharing the cores, torch's
  intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets():
  flax_net = jac.StateActorCritic(**WIDTHS)
  obs = np.random.default_rng(0).normal(size=(4, OBS)).astype(np.float32)
  params = flax_net.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]))
  # move the logstd off its init value so the conversion of it shows
  params = jax.tree_util.tree_map_with_path(
      lambda p, x: x + 0.1 if "logstd" in jax.tree_util.keystr(p) else x,
      params)
  net = tac.StateActorCritic(state_input_shape=OBS, **WIDTHS)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                      strict=True)
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
  assert len(ref_l) == len(got_l) == {"pi": 3, "v": 1, "pi_v": 4}[method]
  for r, g in zip(ref_l, got_l):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_gradients_match_flax(nets):
  """d/dparams of one loss over `pi_v` (mean, logstd and value weighted
  by fixed random factors): every parameter's gradient, the shared
  base's from both heads."""
  flax_net, params, net, obs = nets
  rng = np.random.default_rng(1)
  w_mean = rng.normal(size=(4, 6)).astype(np.float32)
  w_v = rng.normal(size=(4, 1)).astype(np.float32)

  def loss(mean, logstd, value, xp, cast):
    return (xp.sum(mean * cast(w_mean)) + 0.3 * xp.sum(logstd)
            + xp.sum(value * cast(w_v)))

  def jloss(p):
    (mean, _, logstd), value = flax_net.apply(p, jnp.asarray(obs),
                                              method=flax_net.pi_v)
    return loss(mean, logstd, value, jnp, jnp.asarray)

  ref = params_from_flax(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
  net.zero_grad()
  (mean, _, logstd), value = net.pi_v(torch.tensor(obs))
  loss(mean, logstd, value, torch, torch.tensor).backward()
  got = dict(net.named_parameters())
  assert set(got) == set(ref)
  for name, g in ref.items():
    assert got[name].grad is not None, name
    np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                               err_msg=name, **TOL)
  assert float(got["base.layers.0.weight"].grad.abs().max()) > 0


def test_param_labels_and_fused_refusal(nets):
  """The JAX learner's split: the shared base to both optimizers, the
  logstd head and pf_mlp to the policy's, vf_mlp to the value's; the
  model has no layer to fuse."""
  _, params, net, obs = nets
  assert param_labels(net) == jax_param_labels(params)
  assert param_labels(net)["base"] == "both"
  with pytest.raises(NotImplementedError, match="no transformer layer"):
    net.pi_v(torch.tensor(obs), fused=True)


def test_ppo_state_starter_trains_one_epoch(tmp_path):
  """The starter's module from the unchanged state-only-baseline config
  (its heightfield terrain, no camera), one tiny PPO epoch on the CPU:
  4 envs, 8 frames, the settle cut to 20 substeps."""
  with open(CONFIG) as f:
    params = json.load(f)
  env, meta = get_env(params["env_name"], params["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=20)
  module = ppo_state.build_module(env, params)
  assert isinstance(module, tac.StateActorCritic)
  assert module.base.layers[0].in_features == env.obs_dim == OBS
  assert [layer.out_features for layer in module.base.layers] == [256, 256]
  logger = Logger("state", params["env_name"], 0, params, str(tmp_path))
  with pytest.warns(UserWarning, match="horizon"):   # T = 2 steps
    agent = PPOAgent(
        env=env, ac_module=module, num_envs=4, seed=0, logger=logger,
        cfg=PPOConfig(plr=1e-4, vlr=1e-4, opt_epochs=1, batch_size=8,
                      epoch_frames=8, num_epochs=1),
        save_dir=os.path.join(logger.work_dir, "model"),
        obs_norm=meta["obs_norm"], eval_interval=1, num_eval_envs=2,
        eval_horizon=2, device="cpu")
  init = {k: v.clone() for k, v in agent.module.state_dict().items()}
  agent.train()
  moved = sum(not torch.equal(v, init[k])
              for k, v in agent.module.state_dict().items())
  assert moved == len(init)
  assert agent.total_frames == 8
