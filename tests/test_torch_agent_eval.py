"""The port's PPOAgent.evaluate against the JAX agent's eval rollout
(vision4leg_tpu/algo/agent.py:248-271) on the thin-goal env, on the CPU.

Both agents hold the same LocoTransformer weights (flax params converted
by params_from_flax) and the same frozen observation normalizer.  The
eval envs start from the same states: the JAX eval reset's states are
converted and handed to the torch agent's env, and the depth camera's
blind spots are recomputed from the JAX state keys (as in
tests/test_torch_env.py).  One of the two eval envs starts lifted and
rolled past the fall threshold, so it is done after its first step and
the done-masking of the returns and step counts is exercised next to an
env that runs on.

The JAX eval steps its per-env `step` (Cholesky solver, env-first
engine), the port steps `step_batch` (the env-last window).  Tolerances:
those test_torch_env.py holds its 4 steps to, rewards 2e-3, applied to
the eval returns; the step counts (the done-masking) exactly.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import CONFIG, _blind_from_key
from vision4leg_tpu.algo.agent import PPOAgent as JaxAgent
from vision4leg_tpu.algo.ppo import PPOConfig as JaxPPOConfig
from vision4leg_tpu.data import normalizer as jnorm
from vision4leg_tpu.envs.env import A1GymEnv as JaxEnv
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_torch import convert
from vision4leg_torch.algo.agent import PPOAgent
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.data.normalizer import NormalizerState
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs.get_env import get_env as torch_get_env
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic

E = 2
HORIZON = 3
STATE = 84
WIDTHS = dict(action_dim=6, state_input_shape=STATE,
              visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32, 32),
              transformer_params=((1, 64), (1, 64)),
              append_hidden_shapes=(32, 32), token_dim=32)
TILT = 0.95          # rad of roll: R[2,2] = cos(0.95) = 0.58 < 0.6 falls


class TiltEnv(JaxEnv):
  """The JAX thin-goal env whose reset lifts an env by 0.3 m and rolls it
  by TILT when a bit drawn from its key is set (the others start as
  usual): a deterministic function of the key, so the torch side gets
  the same states."""

  def reset(self, key):
    state, _ = super().reset(key)
    flag = jax.random.bernoulli(jax.random.fold_in(key, 7))
    phys = state.robot.phys
    half = 0.5 * TILT
    tilt = jnp.array([jnp.cos(half), jnp.sin(half), 0.0, 0.0])
    w1, x1, y1, z1 = tilt
    w2, x2, y2, z2 = phys.quat
    rolled = jnp.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])
    phys = phys.replace(
        quat=jnp.where(flag, rolled, phys.quat),
        pos=phys.pos.at[2].add(jnp.where(flag, 0.3, 0.0)))
    state = state.replace(robot=state.robot.replace(phys=phys))
    return state, self._observation(state)


def _env_state(js):
  """A torch EnvState from the JAX EnvState (numpy leaves, env axis)."""
  return convert.env_state(js)


class ReplayResetEnv(tenv_mod.A1GymEnv):
  """The torch env whose reset returns given states and observations and
  whose camera draws replay the JAX state keys."""
  start = None
  keys = None

  def reset(self, n_env, gen):
    states, obs = self.start
    return states, obs

  # the collector resets from draws, which the replay does not take
  def draw_for_reset(self, n_env, gen):
    return None

  def reset_from(self, n_env, draws):
    return self.reset(n_env, None)

  def draw_blind_spots(self, n_env, gen):
    # the JAX step splits the state key in 3 and keeps [0]; the capture
    # splits that and draws the blind spots from [1]
    nxt = [jax.random.split(jax.random.split(k, 3)[0]) for k in self.keys]
    self.keys = [k[0] for k in nxt]
    out = [_blind_from_key(k[1]) for k in nxt]
    return tenv_mod.BlindSpots(torch.tensor(np.stack([o[0] for o in out])),
                               torch.tensor(np.stack([o[1] for o in out])))


class NanAfterDoneTiltEnv(TiltEnv):
  """TiltEnv whose reward turns NaN where an env already past the fall
  threshold is stepped on after its first step: the diverged physics of
  a fallen robot stepped on after its done, made certain."""

  def step(self, state, action):
    out = super().step(state, action)
    _, x, y, _ = state.robot.phys.quat
    fallen = (state.step_counter >= 1) & (1 - 2 * (x * x + y * y) < 0.6)
    return (out[0], out[1], jnp.where(fallen, jnp.nan, out[2])) + out[3:]


class NanAfterDoneReplayEnv(ReplayResetEnv):
  """The torch side of NanAfterDoneTiltEnv."""

  def step_from(self, states, actions, draws):
    out = super().step_from(states, actions, draws)
    q = states.robot.phys.quat
    fallen = (states.step_counter >= 1) & (
        1 - 2 * (q[:, 1] ** 2 + q[:, 2] ** 2) < 0.6)
    return (out[0], out[1], torch.where(fallen, torch.nan, out[2])) \
        + tuple(out[3:])


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
  return _evals(tmp_path_factory, TiltEnv, ReplayResetEnv)


@pytest.fixture(scope="module")
def nan_evals(tmp_path_factory):
  return _evals(tmp_path_factory, NanAfterDoneTiltEnv, NanAfterDoneReplayEnv)


def _evals(tmp_path_factory, jax_env_cls, torch_env_cls):
  with open(CONFIG) as f:
    params = json.load(f)
  jenv, _ = jax_get_env(params["env_name"], params["env"])
  tilt_env = jax_env_cls(jenv.cfg)
  tilt_env._template = jenv.settled_template()
  flax_net = FlaxAC(**WIDTHS)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")      # the short-horizon warning
    jagent = JaxAgent(
        env=jenv, ac_module=flax_net,
        cfg=JaxPPOConfig(epoch_frames=2 * E, max_episode_frames=999),
        num_envs=E, seed=0, logger=None,
        save_dir=str(tmp_path_factory.mktemp("jax_agent")),
        num_eval_envs=E, eval_env=tilt_env, eval_horizon=HORIZON)
  rng = np.random.default_rng(2)
  nrm = jnorm.NormalizerState(
      mean=jnp.asarray(rng.normal(0, 0.1, STATE).astype(np.float32)),
      var=jnp.asarray(rng.uniform(0.5, 2.0, STATE).astype(np.float32)),
      count=jnp.asarray(100.0))
  k_ev = jax.random.PRNGKey(11)
  jret, jsteps = jagent._eval(jagent.train_state.params, nrm, k_ev)

  # the torch agent on the same start states, weights and normalizer
  ks = jax.random.split(k_ev, E)
  jstart, jobs = jax.jit(jax.vmap(tilt_env.reset))(ks)
  tenv, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  renv = torch_env_cls(tenv.cfg, device="cpu")
  renv.start = (_env_state(jax.tree.map(np.asarray, jstart)),
                torch.tensor(np.asarray(jobs)))
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    tagent = PPOAgent(
        env=renv, ac_module=LocoTransformerActorCritic(**WIDTHS),
        cfg=PPOConfig(epoch_frames=2 * E), num_envs=E, seed=0, logger=None,
        save_dir=str(tmp_path_factory.mktemp("torch_agent")),
        num_eval_envs=E, eval_horizon=HORIZON, device="cpu")
  tagent.module.load_state_dict(params_from_flax(
      jax.tree.map(np.asarray, jagent.train_state.params)))
  tagent.collector_state = tagent.collector_state.replace(
      normalizer=NormalizerState(*(torch.tensor(np.asarray(x)) for x in (
          nrm.mean, nrm.var, nrm.count))))
  renv.keys = list(jstart.key)
  tret, tsteps = tagent.evaluate()
  flags = np.asarray(jstart.robot.phys.pos[:, 2] > 0.4)
  return (np.asarray(jret), np.asarray(jsteps)), (tret.numpy(),
                                                 tsteps.numpy()), flags


def test_eval_returns_match_jax(evals):
  (jret, _), (tret, _), flags = evals
  # one env is rolled past the fall threshold, the other starts standing
  assert flags.tolist() in ([True, False], [False, True])
  np.testing.assert_allclose(tret, jret, atol=2e-3)


def test_eval_done_masking_matches_jax(evals):
  (_, jsteps), (_, tsteps), flags = evals
  np.testing.assert_array_equal(tsteps, jsteps)
  # the rolled env is done after its first step, the other runs on
  np.testing.assert_array_equal(tsteps, np.where(flags, 1.0, HORIZON))


def test_eval_masks_the_rewards_after_the_done(evals, nan_evals):
  """Where the rolled env's rewards turn NaN after its done, the JAX
  agent's eval multiplies them by 0 and its return is NaN; the port's
  leaves them out: its returns are those of the JAX eval without the
  NaN, at the tolerance above."""
  (jret, _), _, flags = evals
  (jret_nan, _), (tret_nan, tsteps_nan), flags_nan = nan_evals
  assert flags_nan.tolist() == flags.tolist()
  assert np.isnan(jret_nan[flags]).all()
  assert np.isfinite(jret_nan[~flags]).all()
  np.testing.assert_allclose(tret_nan, jret, atol=2e-3)
  np.testing.assert_array_equal(tsteps_nan, np.where(flags, 1.0, HORIZON))
