"""Parity of the port's Nature-CNN actor-critics (NatureFuseActorCritic,
VisualNetActorCritic) with the flax modules, weights converted by
vision4leg_torch.convert.params_from_flax; their optimizer split, one PPO
minibatch against the JAX learner; and the env states of the MMDR
options through a partial reset and a checkpoint.

Tolerances: the forwards at the starters' full width (encoder 256-256,
visual 256, heads 256-256) on 3 rows, atol 2e-5 / rtol 1e-4 as
tests/test_torch_models.py (float32 convolutions summed in different
orders).  The PPO minibatch in float64 on both sides (JAX under
`jax.enable_x64`), atol 1e-5 / rtol 1e-4 as tests/test_torch_ppo.py.
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
from vision4leg_tpu.algo.ppo import PPOConfig as JPPOConfig
from vision4leg_tpu.algo.ppo import PPOLearner as JPPOLearner
from vision4leg_tpu.collector.rollout import Transition as JTransition
from vision4leg_tpu.models import actor_critic as jac
from vision4leg_torch.algo.agent import PPOAgent, _flatten
from vision4leg_torch.algo.on_policy_base import param_labels
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner
from vision4leg_torch.collector import rollout as troll
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.models import actor_critic as tac
from vision4leg_torch.starter import common, ppo_nature_cnn
from vision4leg_torch.utils.logger import Logger

ROOT = os.path.join(os.path.dirname(__file__), "..", "config")
MOVING = os.path.join(ROOT, "rl", "moving", "frame_extract4_random_delay",
                      "thin-wide.json")
FULL = {
    "fuse": (jac.NatureFuseActorCritic, tac.NatureFuseActorCritic,
             dict(action_dim=6, state_input_shape=84,
                  visual_input_shape=(4, 64, 64),
                  encoder_hidden_shapes=(256, 256), visual_dim=256,
                  append_hidden_shapes=(256, 256))),
    "visual": (jac.VisualNetActorCritic, tac.VisualNetActorCritic,
               dict(action_dim=2, state_input_shape=0,
                    visual_input_shape=(4, 64, 64),
                    append_hidden_shapes=(256, 256))),
}
FWD = dict(atol=2e-5, rtol=1e-4)
UPD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  """Small eager ops: with the suite's workers sharing the cores, torch's
  intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _obs(widths, n, seed=0):
  rng = np.random.default_rng(seed)
  s = widths["state_input_shape"]
  obs = rng.normal(size=(n, s + 4 * 64 * 64)).astype(np.float32)
  obs[:, s:] = rng.uniform(-1.5, 2.0, size=(n, 4 * 64 * 64))
  return obs


@pytest.fixture(scope="module", params=sorted(FULL))
def nets(request):
  jcls, tcls, widths = FULL[request.param]
  flax_net = jcls(**widths)
  obs = _obs(widths, 3)
  params = flax_net.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]))
  # move the logstd off its init value so the conversion of it shows
  params = jax.tree_util.tree_map_with_path(
      lambda p, x: x + 0.1 if "logstd" in jax.tree_util.keystr(p) else x,
      params)
  net = tcls(**widths)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                      strict=True)
  return flax_net, params, net, obs


@pytest.mark.parametrize("method", ["pi", "v"])
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
    np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD)


def test_param_labels_match_jax(nets):
  """The pf / vf / both split of the JAX learner: the shared trunk to
  both optimizers, the logstd head and pf_mlp to the policy's, vf_mlp to
  the value's."""
  _, params, net, _ = nets
  assert param_labels(net) == jax_param_labels(params)
  assert set(param_labels(net).values()) == {"both", "pf", "vf"}


def test_seeded_init_follows_the_reference():
  widths = FULL["fuse"][2]
  a = tac.NatureFuseActorCritic(**widths,
                                generator=torch.Generator().manual_seed(3))
  b = tac.NatureFuseActorCritic(**widths,
                                generator=torch.Generator().manual_seed(3))
  for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
    assert torch.equal(x, y), n
  assert torch.all(a.encoder.projection.dense.bias == 0.1)
  assert float(a.pf_mlp.layers[-1].weight.detach().abs().max()) <= 3e-3
  np.testing.assert_allclose(a.head.logstd.detach().numpy(), np.log(0.125),
                             rtol=1e-6)


# ---------------------------------------------------------------------------
# one PPO minibatch against the JAX learner, float64
# ---------------------------------------------------------------------------

NARROW = dict(action_dim=6, state_input_shape=40,
              visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32,),
              visual_dim=32, append_hidden_shapes=(32,))
T, E = 2, 4
CFG = dict(plr=3e-4, vlr=4e-4, clip_para=0.2, entropy_coeff=0.01,
           discount=0.99, tau=0.95, batch_size=T * E, epoch_frames=T * E,
           opt_epochs=1, num_epochs=4, shuffle=True)


def test_one_ppo_minibatch_matches_jax():
  with jax.enable_x64(True):
    flax_net = jac.NatureFuseActorCritic(**NARROW)
    obs = (0.3 * _obs(NARROW, T * E, seed=5)).astype(np.float64)
    params = flax_net.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]))
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    rng = np.random.default_rng(6)
    mean, std, _ = flax_net.apply(params, jnp.asarray(obs),
                                  method=flax_net.pi)
    mean, std = np.asarray(mean), np.asarray(std)
    acts = mean + std * rng.normal(size=mean.shape)
    logp = np.sum(-0.5 * ((acts - mean) / std) ** 2 - np.log(std)
                  - 0.5 * np.log(2 * np.pi), -1, keepdims=True)
    logp = logp + rng.uniform(-0.3, 0.3, logp.shape)
    split = lambda x: x.reshape((T, E) + x.shape[1:])
    terminals = np.zeros((T, E, 1), bool)
    terminals[0, 1] = True
    traj = dict(obs=split(obs), acts=split(acts), log_probs=split(logp),
                values=rng.normal(size=(T, E, 1)),
                rewards=rng.normal(size=(T, E, 1)), terminals=terminals,
                time_limits=np.zeros((T, E, 1), bool), means=split(mean),
                stds=split(std))
    last_value = rng.normal(size=E)
    learner = JPPOLearner(
        JPPOConfig(**CFG),
        lambda p, x: flax_net.apply(p, x, method=flax_net.pi),
        lambda p, x: flax_net.apply(p, x, method=flax_net.v), params)
    key = jax.random.PRNGKey(100)
    perm = np.asarray(jax.random.permutation(jax.random.split(key, 1)[0], T))
    ts, metrics = jax.jit(learner.update_per_epoch)(
        learner.init_state(params),
        JTransition(**{k: jnp.asarray(v) for k, v in traj.items()}),
        jnp.asarray(last_value), key)
    ref = params_from_flax(jax.tree.map(np.asarray, ts.params))
    ref_m = {k: float(v) for k, v in metrics.items()}
    init = params_from_flax(jax.tree.map(np.asarray, params))

  net = tac.NatureFuseActorCritic(**NARROW).double()
  net.load_state_dict(init)
  tl = PPOLearner(PPOConfig(**CFG), lambda m, x: m.pi(x),
                  lambda m, x: m.v(x), net)
  t = lambda v: torch.tensor(v)
  _, got_m = tl.update_per_epoch(
      tl.init_state(net), Transition(**{k: t(v) for k, v in traj.items()}),
      t(last_value), perms=[perm.copy()])
  got = net.state_dict()
  moved = sum(not torch.equal(init[n], got[n]) for n in init)
  assert moved == len(init)
  for name, v in ref.items():
    np.testing.assert_allclose(got[name].numpy(), v.numpy(), err_msg=name,
                               **UPD)
  assert set(got_m) == set(ref_m)
  for k, v in ref_m.items():
    np.testing.assert_allclose(float(got_m[k]), v, err_msg=k, **UPD)


# ---------------------------------------------------------------------------
# the MMDR env states through a partial reset and a checkpoint
# ---------------------------------------------------------------------------

def _moving_env(**extra):
  with open(MOVING) as f:
    params = json.load(f)
  env, meta = get_env(params["env_name"], params["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=20, **extra)
  return env, meta, params


def test_partial_reset_carries_the_mmdr_fields():
  """The collector's scatter of a partial reset replaces the finished
  envs' frame indices, delays, moving directions and boxes, and keeps the
  others'."""
  env, _, _ = _moving_env(interpolation=True)
  gen = torch.Generator().manual_seed(3)
  states, _ = env.reset(4, gen)
  act = (env.action_low + env.action_high) / 2
  states, _, _, _, _ = env.step_batch(states, act.expand(4, 6), gen)
  fresh, _ = env.reset(2, gen)
  idx = torch.tensor([1, 3])
  out = troll._scatter(states, fresh, idx)
  keep = torch.tensor([0, 2])
  for get in (lambda s: s.frame_idx, lambda s: s.interp_delay,
              lambda s: s.terrain.box_dirs, lambda s: s.terrain.boxes):
    assert torch.equal(get(out)[idx], get(fresh))
    assert torch.equal(get(out)[keep], get(states)[keep])
  assert out.interp_delay.shape == (4,) and out.frame_idx.shape == (4, 4)
  assert not torch.equal(out.frame_idx[idx], states.frame_idx[idx])


def test_checkpoint_round_trip_carries_the_mmdr_fields(tmp_path):
  """One Nature-CNN epoch on the moving thin-wide config (3 envs, the
  starter's module at narrow widths) and its checkpoint restored into a
  second agent: every collector tensor equal, the new fields included."""
  env, meta, params = _moving_env()
  cfg = dataclasses.replace(common.ppo_config(params, num_epochs=1),
                            epoch_frames=6, batch_size=6)
  narrow = dict(encoder={"hidden_shapes": [16], "visual_dim": 16},
                net={"append_hidden_shapes": [16]})
  params = dict(params, **narrow)

  def agent(seed):
    return PPOAgent(
        env=env, ac_module=ppo_nature_cnn.build_module(env, params),
        cfg=cfg, num_envs=3, seed=seed,
        logger=Logger("nature", params["env_name"], 0, params,
                      str(tmp_path)),
        save_dir=str(tmp_path / "model"), eval_interval=1, save_interval=1,
        num_eval_envs=2, obs_norm=meta["obs_norm"], eval_horizon=2,
        device="cpu")

  with pytest.warns(UserWarning, match="horizon"):
    a = agent(0)
  a.train()
  with pytest.warns(UserWarning, match="horizon"):
    b = agent(1)
  assert b.restore_checkpoint() == 1
  fa = _flatten(a.collector_state, "cs", {})
  fb = _flatten(b.collector_state, "cs", {})
  assert set(fa) == set(fb)
  for k in fa:
    assert torch.equal(fa[k], fb[k]), k
  for k in ("cs.env_states.frame_idx", "cs.env_states.interp_delay",
            "cs.env_states.terrain.box_dirs"):
    assert k in fa
  for (n, x), (_, y) in zip(a.module.state_dict().items(),
                            b.module.state_dict().items()):
    assert torch.equal(x, y), n
  with pytest.raises(NotImplementedError, match="no transformer layer"):
    PPOAgent(env=env, ac_module=ppo_nature_cnn.build_module(env, params),
             cfg=cfg, num_envs=3, seed=0, logger=None,
             save_dir=str(tmp_path / "other"), fused_attention=True,
             device="cpu")
