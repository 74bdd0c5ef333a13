"""The port's PPOAgent.evaluate on A1MoveGroundMPC against the JAX
agent's eval rollout (vision4leg_tpu/algo/agent.py eval_rollout), on the
CPU.

Both agents hold the same LocoTransformer weights (params_from_flax) and
the same frozen normalizer, and their eval envs start from the same
states: the JAX reset's draws and settled states are replayed into the
torch env, and the depth camera's blind spots are recomputed from the
JAX state keys (as tests/test_torch_mpc_env.py does).  2 envs x 3 steps
of the thin-goal MPC config cut to policy_freq 5 and a 150-substep
settle.  The JAX eval steps its per-env `step`, the port `step_batch`;
the returns are held at the band tests/test_torch_mpc_env.py holds one
step's reward to (1e-2) for each step summed, the step counts exactly.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mpc_env import _blinds, _jax_env, _reset_replay
from vision4leg_tpu.algo.agent import PPOAgent as JaxAgent
from vision4leg_tpu.algo.ppo import PPOConfig as JPPOConfig
from vision4leg_tpu.data import normalizer as jnorm
from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_torch.algo.agent import PPOAgent
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.data.normalizer import NormalizerState
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic

E = 2
HORIZON = 3
PROPRIO = 6
SETTLE = 150
WIDTHS = dict(action_dim=2, visual_input_shape=(4, 64, 64),
              encoder_hidden_shapes=(16,),
              transformer_params=((1, 32), (1, 32)),
              append_hidden_shapes=(16,), token_dim=16)


def _step_blinds(keys, n):
  """The blind spots of n steps of envs with state keys `keys`: a JAX MPC
  step keeps split(key)[0], and its capture splits that and draws from
  [1] (its step and step_batch alike)."""
  out = []
  for _ in range(n):
    nxt = [jax.random.split(jax.random.split(k)[0]) for k in keys]
    keys = [k[0] for k in nxt]
    out.append(_blinds([k[1] for k in nxt]))
  return out


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
  jenv, params = _jax_env(SETTLE)
  # the JAX agent evaluates on jenv; it collects from a copy on plane with
  # no settle, whose eager reset at construction costs less
  cheap = type(jenv)(dataclasses.replace(jenv.cfg, terrain_type="plane",
                                         settle_steps=1))
  flax_net = FlaxAC(state_input_shape=PROPRIO, **WIDTHS)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")      # the short-horizon warning
    jagent = JaxAgent(
        env=cheap, eval_env=jenv, ac_module=flax_net,
        cfg=JPPOConfig(epoch_frames=2, max_episode_frames=999),
        num_envs=1, seed=0, logger=None,
        save_dir=str(tmp_path_factory.mktemp("jax_agent")),
        num_eval_envs=E, eval_horizon=HORIZON)
  rng = np.random.default_rng(2)
  nrm = jnorm.NormalizerState(
      mean=jnp.asarray(rng.normal(0, 0.1, PROPRIO).astype(np.float32)),
      var=jnp.asarray(rng.uniform(0.5, 2.0, PROPRIO).astype(np.float32)),
      count=jnp.asarray(100.0))
  k_ev = jax.random.PRNGKey(11)
  jret, jsteps = jagent._eval(jagent.train_state.params, nrm, k_ev)

  renv, jstart, _ = _reset_replay(jenv, jax.random.split(k_ev, E), params)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    tagent = PPOAgent(
        env=renv, ac_module=LocoTransformerActorCritic(
            state_input_shape=PROPRIO, **WIDTHS),
        cfg=PPOConfig(epoch_frames=2 * E), num_envs=E, seed=0, logger=None,
        save_dir=str(tmp_path_factory.mktemp("torch_agent")),
        num_eval_envs=E, eval_horizon=HORIZON, device="cpu")
  tagent.module.load_state_dict(params_from_flax(
      jax.tree.map(np.asarray, jagent.train_state.params)))
  tagent.collector_state = tagent.collector_state.replace(
      normalizer=NormalizerState(*(torch.tensor(np.asarray(x)) for x in (
          nrm.mean, nrm.var, nrm.count))))
  renv.blinds = _step_blinds(list(jstart.key), HORIZON)
  tret, tsteps = tagent.evaluate()
  return (np.asarray(jret), np.asarray(jsteps)), (tret.numpy(),
                                                 tsteps.numpy())


def test_eval_matches_jax(evals):
  (jret, jsteps), (tret, tsteps) = evals
  np.testing.assert_array_equal(tsteps, jsteps)
  np.testing.assert_array_equal(tsteps, HORIZON)   # no env fell
  np.testing.assert_allclose(tret, jret, atol=1e-2 * HORIZON)
