"""Parity of the torch rollout collector with the JAX collector on the
thin-goal env at 2 envs, over 3 steps.

Both sides run the same LocoTransformer weights (flax params converted by
params_from_flax) and the same pre-drawn action noise: the JAX side takes
it through the collector's act_fn hook (one horizon-1 rollout per step,
the noise riding in the params), the torch side through its act_fn.  The
env randomness is replayed as in test_torch_env.py.

Tolerances: log-probs depend only on the noise and the logstd, 1e-5.
The raw proprio observations the normalizer takes in, and so its mean
and variance, carry the env's velocity-derived observations, 6e-3
(test_torch_env.py); the depth tail passes raw, 1e-3.  The normalized
observations fed to the policy are held against the JAX normalizer's
`filt` applied to the torch side's raw observations and normalizer
state, 1e-5 (the running std of 2 envs would magnify the physics gap of
the raw observations, so the two sides' normalized values are not
compared with each other).  Actions (tanh-squashed into the bounds) and
rewards follow the policy mean and the physics, 2e-3.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import (CONFIG, ReplayEnv, _np_tree, _reset_blind,
                            _step_blind)
from vision4leg_tpu.collector import rollout as jroll
from vision4leg_tpu.data import normalizer as jnorm
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_torch import convert
from vision4leg_torch.collector import rollout as troll
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs.get_env import env_config_from_build_params
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic

E = 2
STEPS = 3
STATE = 84
WIDTHS = dict(action_dim=6, state_input_shape=STATE,
              visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32, 32),
              transformer_params=((1, 64), (1, 64)),
              append_hidden_shapes=(32, 32), token_dim=32)


@pytest.fixture(scope="module")
def collected():
  with open(CONFIG) as f:
    params = json.load(f)
  jenv, meta = jax_get_env(params["env_name"], params["env"])
  cfg = env_config_from_build_params(params["env"]["env_build"])
  renv = ReplayEnv(cfg, device="cpu")
  renv._template = convert.robot_state(_np_tree(jenv.settled_template()))

  flax_net = FlaxAC(**WIDTHS)
  fparams = flax_net.init(jax.random.PRNGKey(2),
                          jnp.zeros((1, jenv.obs_dim)))
  net = LocoTransformerActorCritic(**WIDTHS)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, fparams)))
  noise = np.random.default_rng(1).normal(size=(STEPS, E, 6)).astype(
      np.float32)
  lo, hi = jenv.action_low, jenv.action_high

  # --- JAX: act_fn reads this step's noise from params[1] ---
  def apply_v(p, x):
    return flax_net.apply(p[0], x, method=flax_net.v)

  def act_fn(p, obs, key):
    mean, std, _ = flax_net.apply(p[0], obs, method=flax_net.pi)
    act = mean + std * p[1]
    logp = jnp.sum(-0.5 * p[1] ** 2 - jnp.log(std)
                   - 0.5 * jnp.log(2 * jnp.pi), axis=-1, keepdims=True)
    env_act = lo + (jnp.tanh(act) + 1.0) * 0.5 * (hi - lo)
    return act, logp, env_act, mean, std

  common = dict(horizon=1, max_episode_frames=999, discount=0.99,
                proprio_dim=STATE, obs_norm=True, action_low=lo,
                action_high=hi)
  jrollout = jax.jit(jroll.make_rollout_fn(
      jenv, None, apply_v, act_fn=act_fn, **common))
  jcs = jroll.init_collector(jenv, E, jax.random.PRNGKey(5))

  # --- torch: replay the JAX collector's resets and camera draws ---
  js = _np_tree(jcs.env_states)
  k_reset = jax.random.split(jax.random.PRNGKey(5))[0]
  init = np.asarray(tterr.INIT_POSITION[cfg.terrain_type], np.float32)
  renv.reset_draws = tenv_mod.ResetDraws(
      terrain=convert.terrain(js.terrain), dyn=convert.dynamics(js.dyn),
      init_jitter=torch.tensor(js.robot.phys.pos[:, :2] - init[:2]),
      blind=tenv_mod.BlindSpots(*_reset_blind(
          jax.random.split(k_reset, E))))
  tcs = troll.init_collector(renv, E, torch.Generator().manual_seed(0))
  tnoise = iter(torch.tensor(noise))
  tlo = torch.tensor(np.asarray(lo))
  thi = torch.tensor(np.asarray(hi))

  def tact_fn(obs, gen):
    mean, std, _ = net.pi(obs)
    n = next(tnoise)
    act = mean + std * n
    logp = torch.sum(-0.5 * n ** 2 - torch.log(std)
                     - 0.5 * np.log(2 * np.pi), dim=-1, keepdim=True)
    return act, logp, tlo + (torch.tanh(act) + 1.0) * 0.5 * (thi - tlo), \
        mean, std

  trollout = troll.make_rollout_fn(renv, None, net.v, act_fn=tact_fn,
                                   **common)
  out = []
  for t in range(STEPS):
    renv.blinds = [_step_blind(jcs.env_states.key)]
    raw = (np.asarray(jcs.raw_obs), tcs.raw_obs)
    jcs, jtr, _ = jrollout((fparams, jnp.asarray(noise[t])), jcs)
    tcs, ttr, _ = trollout(tcs)
    out.append((jax.tree.map(np.asarray, (jtr, jcs.normalizer, raw[0])),
                (ttr, tcs.normalizer, raw[1])))
  return out


@pytest.mark.parametrize("step", range(STEPS))
def test_collector_step_matches_jax(collected, step):
  (jtr, jn, jraw), (ttr, tn, traw) = collected[step]
  assert not jtr.terminals.any() and not ttr.terminals.any()
  np.testing.assert_allclose(ttr.log_probs.numpy(), jtr.log_probs, atol=1e-5)
  np.testing.assert_allclose(traw[:, :STATE].numpy(), jraw[:, :STATE],
                             atol=6e-3)
  np.testing.assert_allclose(ttr.obs[..., STATE:].numpy(),
                             jtr.obs[..., STATE:], atol=1e-3)
  filt = jnorm.filt_with_img_tail(
      jnorm.NormalizerState(mean=tn.mean.numpy(), var=tn.var.numpy(),
                            count=tn.count.numpy()), traw.numpy(), STATE)
  np.testing.assert_allclose(ttr.obs[0].numpy(), np.asarray(filt),
                             atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(ttr.acts.numpy(), jtr.acts, atol=2e-3)
  np.testing.assert_allclose(ttr.values.numpy(), jtr.values, atol=2e-3)
  np.testing.assert_allclose(ttr.rewards.numpy(), jtr.rewards, atol=2e-3)
  np.testing.assert_allclose(tn.mean.numpy(), jn.mean, atol=6e-3)
  np.testing.assert_allclose(tn.var.numpy(), jn.var, atol=6e-3, rtol=1e-3)
  np.testing.assert_allclose(float(tn.count), float(jn.count), rtol=1e-6)


def test_collector_samples_with_its_own_generator():
  """Without the hook, the collector samples Gaussian actions from its
  generator, maps them into the action bounds, and bootstraps and resets
  envs that reach max_episode_frames."""
  with open(CONFIG) as f:
    params = json.load(f)
  cfg = env_config_from_build_params(params["env"]["env_build"])
  env = tenv_mod.A1GymEnv(cfg, device="cpu")
  net = LocoTransformerActorCritic(**WIDTHS,
                                   generator=torch.Generator().manual_seed(0))
  gen = torch.Generator().manual_seed(3)
  cs = troll.init_collector(env, E, gen)
  rollout = troll.make_rollout_fn(
      env, net.pi_v, net.v, horizon=2, max_episode_frames=2, discount=0.99,
      proprio_dim=STATE, action_low=env.action_low,
      action_high=env.action_high)
  cs, traj, last_v = rollout(cs)
  assert traj.obs.shape == (2, E, env.obs_dim)
  assert torch.isfinite(traj.rewards).all() and torch.isfinite(last_v).all()
  assert traj.terminals[1].all() and not traj.time_limits.any()
  assert (cs.ep_steps == 0).all() and float(cs.finished_count) == E
  assert torch.all(last_v == 0)
  std = torch.exp(net.logstd.detach())
  lp = traj.log_probs[..., 0]
  assert torch.all(lp <= torch.sum(-torch.log(std)
                                   - 0.5 * np.log(2 * np.pi)))
