"""Parity of the torch port's A1MoveGround env (thin-goal config, kernel
path) with the JAX env on the CPU, at 2 envs.

The torch env replays the JAX env's randomness: terrain, dynamics and
start jitter are read from the JAX reset, and the depth camera's blind
spots are recomputed from the JAX state's keys.  The settled standing
template is taken from the JAX env too: the 400-substep settle through
stick-slip contact is chaotic (f32 differences of 1e-8 grow to millimetres
in position by its end between two correct implementations), so it is held
against JAX only over its first substeps (test_torch_physics.py;
tools/compare_settle.py prints the drift).

Tolerances: joint angles and positions after a 16-substep window 3e-5
(the JAX CPU window is the env-first engine; see test_torch_physics.py),
velocity-derived observations (IMU rates) 6e-3, rewards 2e-3 (finite
differences of positions over 0.04 s plus squared torques), depth image
1e-3 in normalized units.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import camera as jcam
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_torch import convert
from vision4leg_torch.envs import camera as tcam
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs.get_env import get_env as torch_get_env
from vision4leg_torch.physics import maths as tmaths

CONFIG = os.path.join(os.path.dirname(__file__), "..", "config", "rl",
                      "static", "locotransformer", "thin-goal.json")
E = 2
N_STEPS = 4
PROPRIO = 84


def _blind_from_key(key):
  """The blind spots preprocess_depth draws from `k_blind`."""
  k1, k2 = jax.random.split(key)
  return (np.asarray(jax.random.randint(k1, (), 3, 30)),
          np.asarray(jax.random.randint(k2, (30, 2), 0, 64)))


def _reset_blind(keys):
  """env.reset(key): k_state = split(key, 7)[6]; _capture_frame splits it."""
  out = [_blind_from_key(jax.random.split(
      jax.random.split(k, 7)[6])[1]) for k in keys]
  return (torch.tensor(np.stack([o[0] for o in out])),
          torch.tensor(np.stack([o[1] for o in out])))


def _step_blind(state_keys):
  """step: _step_pre splits the state key in 3 (keeps [0]); the capture
  splits that again and uses [1]."""
  out = [_blind_from_key(jax.random.split(jax.random.split(k, 3)[0])[1])
         for k in state_keys]
  return (torch.tensor(np.stack([o[0] for o in out])),
          torch.tensor(np.stack([o[1] for o in out])))


class ReplayEnv(tenv_mod.A1GymEnv):
  """The torch env with its draws replaced by queued JAX draws."""
  reset_draws = None
  blinds = ()

  def draw_reset(self, n_env, gen):
    return self.reset_draws

  def draw_blind_spots(self, n_env, gen):
    num, idx = self.blinds.pop(0)
    return tenv_mod.BlindSpots(num, idx)


def _np_tree(x):
  return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def rollout():
  """Reset + N_STEPS steps of both envs on the same actions."""
  with open(CONFIG) as f:
    params = json.load(f)
  jenv, _ = jax_get_env(params["env_name"], params["env"])
  tenv, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  renv = ReplayEnv(tenv.cfg, device="cpu")
  renv._template = convert.robot_state(_np_tree(jenv.settled_template()))

  keys = jax.random.split(jax.random.PRNGKey(3), E)
  jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
  js = _np_tree(jstate)
  init = np.asarray(tterr.INIT_POSITION[tenv.cfg.terrain_type], np.float32)
  renv.reset_draws = tenv_mod.ResetDraws(
      terrain=convert.terrain(js.terrain), dyn=convert.dynamics(js.dyn),
      init_jitter=torch.tensor(js.robot.phys.pos[:, :2] - init[:2]),
      blind=tenv_mod.BlindSpots(*_reset_blind(keys)))
  gen = torch.Generator().manual_seed(0)
  tstate, tobs = renv.reset(E, gen)

  rng = np.random.default_rng(0)
  lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
  jstep = jax.jit(jenv.step_batch)
  steps = []
  for _ in range(N_STEPS):
    act = (lo + (hi - lo) * rng.uniform(size=(E, 6))).astype(np.float32)
    renv.blinds = [_step_blind(jstate.key)]
    jstate, jo, jr, jd, _ = jstep(jstate, jnp.asarray(act))
    tstate, to, tr, td, _ = renv.step_batch(tstate, torch.tensor(act), gen)
    steps.append(((np.asarray(jo), np.asarray(jr), np.asarray(jd)),
                  (to.numpy(), tr.numpy(), td.numpy())))
  return (np.asarray(jobs), tobs.numpy()), steps, (_np_tree(jstate), tstate)


def test_reset_obs_matches_jax(rollout):
  (jobs, tobs), _, _ = rollout
  assert tobs.shape == jobs.shape == (E, PROPRIO + 4 * 64 * 64)
  np.testing.assert_allclose(tobs[:, :PROPRIO], jobs[:, :PROPRIO], atol=1e-5)
  np.testing.assert_allclose(tobs[:, PROPRIO:], jobs[:, PROPRIO:], atol=1e-3)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_matches_jax(rollout, step):
  _, steps, _ = rollout
  (jo, jr, jd), (to, tr, td) = steps[step]
  motor = slice(PROPRIO - 36, PROPRIO)           # HSW(MotorAngle)
  np.testing.assert_allclose(to[:, motor], jo[:, motor], atol=3e-5)
  np.testing.assert_allclose(to[:, :PROPRIO], jo[:, :PROPRIO], atol=6e-3)
  depth_t = to[:, PROPRIO:].reshape(E, 4, 64, 64)
  depth_j = jo[:, PROPRIO:].reshape(E, 4, 64, 64)
  np.testing.assert_allclose(depth_t, depth_j, atol=1e-3)
  assert np.ptp(depth_t[:, 0]) > 0.1           # frames are not constant
  np.testing.assert_allclose(tr, jr, atol=2e-3)
  np.testing.assert_array_equal(td, jd)


def test_final_state_matches_jax(rollout):
  _, _, (js, ts) = rollout
  np.testing.assert_allclose(ts.robot.phys.pos.numpy(), js.robot.phys.pos,
                             atol=3e-5)
  np.testing.assert_allclose(ts.robot.phys.joint_q.numpy(),
                             js.robot.phys.joint_q, atol=3e-5)
  np.testing.assert_allclose(ts.task.subgoal_trackers.numpy(),
                             js.task.subgoal_trackers)
  np.testing.assert_array_equal(ts.step_counter.numpy(), js.step_counter)


def test_render_depth_matches_jax():
  """render_depth alone, on random trunk poses among a block terrain
  generated by the JAX package."""
  from vision4leg_tpu.envs import terrain as jterr
  from vision4leg_tpu.physics import maths as jmaths
  rng = np.random.default_rng(5)
  n = 3
  jt = jax.vmap(lambda k: jterr.gen_blocks_sparse(k, subgoal=True))(
      jax.random.split(jax.random.PRNGKey(1), n))
  pos = np.stack([rng.uniform(0, 6, n), rng.uniform(-1, 1, n),
                  rng.uniform(0.2, 0.35, n)], -1).astype(np.float32)
  rpy = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
  quat = np.asarray(jmaths.rpy_to_quat(jnp.asarray(rpy)))
  h_fn, _ = jterr.flat_height_fn(None)
  jdepth = jax.jit(jax.vmap(
      lambda p, q, t: jcam.render_depth(
          p, jmaths.quat_to_mat(q), t, h_fn, True, show_subgoals=True,
          max_boxes=16, far_t=10.5)))(jnp.asarray(pos), jnp.asarray(quat), jt)
  tdepth = tcam.render_depth(
      torch.tensor(pos), tmaths.quat_to_mat(torch.tensor(quat)),
      convert.terrain(_np_tree(jt)), show_subgoals=True, max_boxes=16)
  jd, td = np.asarray(jdepth), tdepth.numpy()
  assert (jd < 10).mean() > 0.3 and (td < 1000).all()
  # depths are view-axis meters up to 20; f32 ray-slab arithmetic
  np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)


def test_env_rejects_what_it_does_not_run():
  with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
    tenv_mod.A1GymEnv(tenv_mod.EnvConfig(rgbd=True), device="cpu")
  # the sphere terrain and random_dir are ported: the env builds with them
  env = tenv_mod.A1GymEnv(
      tenv_mod.EnvConfig(terrain_type="random_sphere_with_subgoal"),
      device="cpu")
  assert env.kernel_capable
  env = tenv_mod.A1GymEnv(tenv_mod.EnvConfig(random_dir=True), device="cpu")
  assert env.cfg.proprio_dim == tenv_mod.EnvConfig().proprio_dim + 2
  # the action filter is ported: the env builds with it
  env = tenv_mod.A1GymEnv(tenv_mod.EnvConfig(enable_action_filter=True),
                          device="cpu")
  assert env._filter_coeffs.a[0] == 1.0


def test_env_draws_its_own_randomness():
  """With its own generator the env builds a valid thin-goal batch: the
  Poisson-disc pillars keep 1 m apart and the obs are finite."""
  with open(CONFIG) as f:
    params = json.load(f)
  env, meta = torch_get_env(params["env_name"], params["env"], device="cpu")
  gen = torch.Generator().manual_seed(1)
  draws = env.draw_reset(3, gen)
  c = draws.terrain.boxes[:, :50, :2]
  d = torch.cdist(c, c) + torch.eye(50) * 10
  assert float(d.min()) >= 1.0 - 1e-5
  assert draws.dyn.kp.shape == (3, 12) and meta["obs_norm"]
  assert int(draws.blind.num.min()) >= 3 and int(draws.blind.num.max()) < 30


def test_plane_env_steps_without_obstacles():
  """The plane terrain has no boxes: the window's contact read reports no
  obstacle penetration and the env steps to finite observations."""
  env = tenv_mod.A1GymEnv(tenv_mod.EnvConfig(
      terrain_type="plane", time_step_s=0.0025, num_action_repeat=4,
      diagonal_act=True, clip_num=(0.05, 0.5, 0.5) * 4, settle_steps=50),
      device="cpu")
  gen = torch.Generator().manual_seed(2)
  state, obs = env.reset(3, gen)
  assert state.terrain.boxes.shape == (3, 0, 8)
  act = (env.action_low + env.action_high) / 2
  state, obs, rew, done, _ = env.step_batch(state, act.expand(3, 6), gen)
  assert obs.shape == (3, env.obs_dim) and torch.isfinite(obs).all()
  assert torch.isfinite(rew).all() and not done.any()

