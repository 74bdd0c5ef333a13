"""Parity of the port's A1MoveGroundMPC env (thin-goal MPC config, its
step_batch over the hybrid physics window) with the JAX env on the CPU,
and the env through the port's rollout collector.

The torch env replays the JAX env's randomness: terrain and the depth
camera's blind spots are recomputed from the JAX keys.  The settled
start states are taken from the JAX reset: every env's 400-substep settle
through stick-slip contact is chaotic between two correct implementations
(ROADMAP queue 3), so the settle is held against JAX over its first 20
substeps only.  The config is cut to policy_freq 5 and settle_steps 150
(the robot lands at ~100 substeps) to keep the CPU time small.

Tolerances: one step_batch at the JAX package's own bands for its
step_batch against its vmapped step (tests/test_mpc.py:493-522): base
position 2e-3, joint angles 5e-3, proprio observations 5e-3, reward 1e-2,
done equal, controller clock 1e-6; the depth frames 1e-3 as in
tests/test_torch_env.py.  The settle's first 20 substeps (free fall
under PD) at the window tolerances of tests/test_torch_physics.py:
position 1e-5, joint angles 3e-5 (env-first JAX engine against the
env-last window), velocities 6e-3.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import _blind_from_key
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_torch import convert
from vision4leg_torch.collector import rollout as troll
from vision4leg_torch.envs import mpc_env as tmpc_env
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs.get_env import get_env as torch_get_env
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config/mpc/locotransformer/thin-goal.json")
E = 3
PROPRIO = 6
SETTLE = 150
ACTS = np.array([[0.3, 0.1], [0.2, -0.3], [-0.2, 0.5]], np.float32)


def _params(policy_freq=5):
  with open(CONFIG) as f:
    params = json.load(f)
  params["env"]["env_build"]["policy_freq"] = policy_freq
  return params


def _blinds(keys):
  out = [_blind_from_key(k) for k in keys]
  return tenv_mod.BlindSpots(torch.tensor(np.stack([o[0] for o in out])),
                             torch.tensor(np.stack([o[1] for o in out])))


class ReplayMpcEnv(tmpc_env.A1MPCGymEnv):
  """The torch MPC env with its draws and its settle replaced by the JAX
  env's."""
  reset_draws = None
  settled = None
  blinds = ()

  def draw_reset(self, n_env, gen):
    return self.reset_draws

  def settle(self, pos, terrain, dyn):
    self.settle_windows += 1
    return self.settled

  def draw_blind_spots(self, n_env, gen):
    return self.blinds.pop(0)


def _jax_env(settle_steps):
  params = _params()
  jenv, _ = jax_get_env(params["env_name"], params["env"])
  jenv.cfg = dataclasses.replace(jenv.cfg, settle_steps=settle_steps)
  return jenv, params


def _reset_replay(jenv, keys, params):
  """The torch env set up to replay the JAX reset of `keys`."""
  tenv, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  renv = ReplayMpcEnv(tenv.cfg, device="cpu")
  renv.cfg = jenv.cfg
  jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
  js = jax.tree.map(np.asarray, jstate)
  r = jenv.cfg.random_init_range
  jitter = np.stack([np.asarray(jax.random.uniform(
      jax.random.split(k, 5)[1], (2,), minval=-r, maxval=r)) for k in keys])
  renv.reset_draws = tmpc_env.MpcResetDraws(
      terrain=convert.terrain(js.terrain), init_jitter=torch.tensor(jitter),
      blind=_blinds([jax.random.split(jax.random.split(k, 5)[4])[1]
                     for k in keys]))
  renv.settled = convert.robot_state(js.robot)
  return renv, jstate, np.asarray(jobs)


@pytest.fixture(scope="module")
def stepped():
  """Reset (JAX settled states injected) and one step_batch of both envs
  on the same actions."""
  jenv, params = _jax_env(SETTLE)
  keys = jax.random.split(jax.random.PRNGKey(3), E)
  renv, jstate, jobs = _reset_replay(jenv, keys, params)
  gen = torch.Generator().manual_seed(0)
  tstate, tobs = renv.reset(E, gen)
  renv.blinds = [_blinds([jax.random.split(jax.random.split(k)[0])[1]
                          for k in jstate.key])]
  j2, jo, jr, jd, _ = jax.jit(jenv.step_batch)(jstate, jnp.asarray(ACTS))
  t2, to, tr, td, _ = renv.step_batch(tstate, torch.tensor(ACTS), gen)
  return ((jobs, tobs.numpy()), jax.tree.map(np.asarray, (j2, jo, jr, jd)),
          (t2, to.numpy(), tr.numpy(), td.numpy()))


def test_reset_obs_matches_jax(stepped):
  (jobs, tobs), _, _ = stepped
  assert tobs.shape == jobs.shape == (E, PROPRIO + 4 * 64 * 64)
  np.testing.assert_allclose(tobs[:, :PROPRIO], jobs[:, :PROPRIO], atol=1e-5)
  np.testing.assert_allclose(tobs[:, PROPRIO:], jobs[:, PROPRIO:], atol=1e-3)


def test_step_batch_matches_jax(stepped):
  _, (js, jo, jr, jd), (ts, to, tr, td) = stepped
  np.testing.assert_allclose(ts.robot.phys.pos.numpy(), js.robot.phys.pos,
                             atol=2e-3)
  np.testing.assert_allclose(ts.robot.phys.joint_q.numpy(),
                             js.robot.phys.joint_q, atol=5e-3)
  np.testing.assert_allclose(to[:, :PROPRIO], jo[:, :PROPRIO], atol=5e-3)
  np.testing.assert_allclose(to[:, PROPRIO:], jo[:, PROPRIO:], atol=1e-3)
  np.testing.assert_allclose(tr, jr, atol=1e-2)
  np.testing.assert_array_equal(td, jd)
  np.testing.assert_allclose(ts.current_time.numpy(), js.current_time,
                             atol=1e-6)
  np.testing.assert_array_equal(ts.step_counter.numpy(), js.step_counter)
  # the controller's gait bookkeeping follows the same contacts
  np.testing.assert_array_equal(ts.controller.desired_leg_state.numpy(),
                                js.controller.desired_leg_state)
  np.testing.assert_array_equal(ts.controller.leg_state.numpy(),
                                js.controller.leg_state)
  # the robots walk: every env moved and none fell
  moved = np.linalg.norm(js.robot.phys.pos[:, :2] - js.last_base_pos[:, :2],
                         axis=-1)
  assert (moved > 1e-3).all() and not jd.any()


def test_settle_matches_jax_over_its_first_substeps():
  """The reset's settle (one window launch per reset) against the JAX
  reset's per-env settle, cut to 20 substeps."""
  jenv, params = _jax_env(20)
  keys = jax.random.split(jax.random.PRNGKey(4), E)
  renv, jstate, _ = _reset_replay(jenv, keys, params)
  draws = renv.reset_draws
  init = torch.tensor(tterr.INIT_POSITION[renv.cfg.terrain_type])
  pos = torch.cat([init[:2] + draws.init_jitter, init[2].expand(E, 1)], 1)
  dyn = tmpc_env.a1.default_dynamics(renv.model, (E,))
  rs = tmpc_env.A1MPCGymEnv.settle(renv, pos, draws.terrain, dyn)
  jp = jstate.robot.phys
  np.testing.assert_allclose(rs.phys.pos.numpy(), np.asarray(jp.pos),
                             atol=1e-5)
  np.testing.assert_allclose(rs.phys.joint_q.numpy(), np.asarray(jp.joint_q),
                             atol=3e-5)
  np.testing.assert_allclose(rs.phys.lin.numpy(), np.asarray(jp.lin),
                             atol=6e-3)
  np.testing.assert_allclose(rs.phys.joint_qd.numpy(),
                             np.asarray(jp.joint_qd), atol=6e-3)
  np.testing.assert_allclose(rs.obs_hist.numpy(),
                             np.asarray(jstate.robot.obs_hist), atol=6e-3)
  # the robot is still in the air and has dropped: the check saw motion
  assert (rs.phys.pos[:, 2] < 0.32).all() and (rs.phys.pos[:, 2] > 0.3).all()


# ---------------------------------------------------------------------------
# the env through the port's collector and the agent, and what the agent
# refuses
# ---------------------------------------------------------------------------

def test_get_env_reads_the_mpc_config():
  with open(CONFIG) as f:
    params = json.load(f)
  env, meta = torch_get_env(params["env_name"], params["env"], device="cpu")
  assert isinstance(env, tmpc_env.A1MPCGymEnv)
  assert env.cfg.policy_freq == 20 and env.cfg.clip_num == (0.3, 0.4)
  assert env.cfg.action_dim == 2 and env.cfg.proprio_dim == PROPRIO
  assert env.obs_dim == PROPRIO + 4 * 64 * 64 and meta["obs_norm"]
  assert env.cfg.terrain_type == "random_blocks_sparse_with_subgoal"
  np.testing.assert_allclose(env.action_high.numpy(), [0.3, 0.4])


def test_collection_runs_through_the_rollout_fn():
  """Two steps of the port's collector on the MPC env with its own draws
  (settle cut to 20 substeps), the second at the episode cap, so every
  env is reset in the rollout and scattered back into the batch."""
  params = _params(policy_freq=2)
  env, meta = torch_get_env(params["env_name"], params["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=20)
  net = LocoTransformerActorCritic(
      action_dim=2, state_input_shape=PROPRIO, encoder_hidden_shapes=(16,),
      transformer_params=((1, 32), (1, 32)), append_hidden_shapes=(16,),
      token_dim=16, generator=torch.Generator().manual_seed(0))
  gen = torch.Generator().manual_seed(3)
  cs = troll.init_collector(env, E, gen)
  assert env.settle_windows == 1
  rollout = troll.make_rollout_fn(
      env, net.pi_v, net.v, horizon=2, max_episode_frames=2, discount=0.99,
      proprio_dim=PROPRIO, obs_norm=meta["obs_norm"],
      action_low=env.action_low, action_high=env.action_high)
  cs, traj, last_v = rollout(cs)
  assert traj.obs.shape == (2, E, env.obs_dim) and traj.acts.shape == (2, E, 2)
  for x in (traj.obs, traj.rewards, traj.values, last_v):
    assert torch.isfinite(x).all()
  assert traj.terminals[1].all() and env.settle_windows == 2
  assert isinstance(cs.env_states, tmpc_env.MpcEnvState)
  # the reset envs start over: fresh clock, counter and controller
  assert (cs.env_states.current_time == 0).all()
  assert (cs.env_states.step_counter == 0).all()
  assert (cs.env_states.controller.vel_count == 0).all()
  assert float(cs.normalizer.count) > E


def _agent_on_mpc_env(tmp_path, env=None, **kw):
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.algo.ppo import PPOConfig
  if env is None:
    env, _ = torch_get_env(_params(policy_freq=2)["env_name"],
                           _params(policy_freq=2)["env"], device="cpu")
    env.cfg = dataclasses.replace(env.cfg, settle_steps=20)
  net = LocoTransformerActorCritic(
      action_dim=2, state_input_shape=PROPRIO, encoder_hidden_shapes=(16,),
      transformer_params=((1, 32),), append_hidden_shapes=(16,),
      token_dim=16)
  return PPOAgent(env=env, ac_module=net, cfg=PPOConfig(epoch_frames=128),
                  num_envs=2, seed=0, logger=None, save_dir=str(tmp_path),
                  device="cpu", **kw)


def test_agent_builds_on_the_mpc_env(tmp_path):
  agent = _agent_on_mpc_env(tmp_path)
  cs = agent.collector_state
  assert isinstance(cs.env_states, tmpc_env.MpcEnvState)
  assert cs.raw_obs.shape == (2, PROPRIO + 4 * 64 * 64)
  assert agent.horizon == 64 and agent.env.settle_windows == 1


def test_agent_refuses_unported_options_on_the_mpc_env(tmp_path):
  """Every option is ported now: the MPC env takes a mesh
  (tests/test_torch_parallel.py shards it over two ranks); a mesh on
  another device than the agent's is refused, and a world of one
  collects what the unranked agent collects."""
  from vision4leg_torch.parallel.mesh import Mesh
  with pytest.raises(ValueError, match="mesh on cuda"):
    _agent_on_mpc_env(tmp_path, mesh=Mesh(1, 0, torch.device("cuda")))
  ranked = _agent_on_mpc_env(tmp_path, mesh=Mesh(1, 0, torch.device("cpu")))
  plain = _agent_on_mpc_env(tmp_path)
  assert torch.equal(ranked.collector_state.raw_obs,
                     plain.collector_state.raw_obs)


@pytest.mark.parametrize("option", ["inference_dtype", "eval_env",
                                    "curriculum"])
def test_agent_takes_the_ported_options_on_the_mpc_env(tmp_path, option):
  """bf16 collection, a separate eval env and the curriculum cap, on the
  MPC env."""
  env, _ = torch_get_env(_params(policy_freq=2)["env_name"],
                         _params(policy_freq=2)["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=20)
  if option == "curriculum":
    env.cfg = dataclasses.replace(env.cfg, curriculum=True)
    agent = _agent_on_mpc_env(tmp_path, env=env)
    assert agent._curriculum_episode_cap() == 1000
  elif option == "eval_env":
    agent = _agent_on_mpc_env(tmp_path, eval_env=env)
    assert agent.eval_env is env and agent.env is not env
  else:
    agent = _agent_on_mpc_env(tmp_path, inference_dtype=torch.bfloat16)
    obs = agent.collector_state.raw_obs.to(torch.bfloat16)
    with torch.no_grad():
      (mean, _, _), value = agent.collect_module.pi_v(obs)
    assert mean.dtype == value.dtype == torch.bfloat16
    assert torch.isfinite(mean.float()).all()


def test_env_walks_forward_on_plane():
  """tests/test_mpc.py::test_mpc_env_walks_forward on the port: commanded
  0.3 m/s forward on flat ground for 20 env steps (2 s), the robot stays
  upright, above 0.15 m, and makes forward progress."""
  env = tmpc_env.A1MPCGymEnv(tmpc_env.MpcEnvConfig(
      motor_control_mode="POSITION", clip_num=(0.3, 0.4), time_step_s=0.001,
      num_action_repeat=5, policy_freq=20, terrain_type="plane",
      target_vel=0.3, check_contact=False, settle_steps=300,
      alive_reward=0.1), device="cpu")
  gen = torch.Generator().manual_seed(0)
  state, obs = env.reset(1, gen)
  assert obs.shape == (1, PROPRIO)
  act = torch.tensor([[0.3, 0.0]])
  for step in range(20):
    state, obs, rew, done, _ = env.step_batch(state, act, gen)
    pos = state.robot.phys.pos[0]
    assert torch.isfinite(pos).all() and torch.isfinite(rew).all()
    assert not done.any(), f"fell at step {step}, z={float(pos[2])}"
    assert float(pos[2]) > 0.15, f"body too low at step {step}: {pos}"
  assert float(pos[0]) > 0.15, f"no forward progress: {pos}"
