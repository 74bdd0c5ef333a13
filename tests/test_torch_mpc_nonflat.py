"""Parity of the port's A1MoveGroundMPC step on a heightfield (the MPC
thin-heightfield config: the controller ticks over the per-env engine,
batched over the envs) with the JAX env's vmapped per-env `step`
(vision4leg_tpu/envs/mpc_env.py:185-310), on the CPU, at 2 envs, with
policy_freq cut to 2.

The torch env replays the JAX reset's draws (terrain with its heightfield,
start jitter, the camera's blind spots) and takes the JAX env's settled
states: the settle is chaotic between two correct implementations
(ROADMAP section 3), so it is held against the JAX reset over its first
20 substeps only, at the bands of tests/test_torch_mpc_env.py (position
1e-5, joint angles 3e-5, velocities 6e-3).

The step is held in float64 on both sides, from the same state (the JAX
reset state, each leaf cast up), the JAX side under jax.enable_x64: a
float32 step parts by the QP's cond ~1.5e8 (tests/test_torch_mpc.py) and
by contact onsets on the bumps (tests/test_torch_env_nonflat.py), a
float64 one does not.  Tolerances, those of those two files: positions,
quaternions and joint angles 1e-9, velocities 1e-7
(tests/test_torch_env_nonflat.py); the warm QP's iterates and K^-1 1e-8
relative to their largest entry, and the gait phases 1e-9
(tests/test_torch_mpc.py); the leg states, done and the step counter
equal; the reward 1e-9; the proprio observation (cast to float32 at the
end on both sides) 1e-6.  The step launches no physics window.

The camera is off on both sides, as for the mountain in
tests/test_torch_env_nonflat.py: its heightfield march is the one that
file and tests/test_torch_heightfield.py hold, the MPC env's frames go
through A1GymEnv's `_render`, and each JAX compile it saves keeps this
file within its time.
"""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env_nonflat import _double
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_tpu.mpc import convex_mpc as jmpc
from vision4leg_torch import convert
from vision4leg_torch.envs import mpc_env as tmpc_env
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs.get_env import get_env as torch_get_env
from vision4leg_torch.mpc import convex_mpc as tmpc
from vision4leg_torch.ops import physics_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config/mpc/locotransformer/thin-heightfield.json")
E = 2
PROPRIO = 6
SETTLE = 400   # the config's settle: the robots have landed
ACTS = np.array([[0.3, 0.2], [0.1, -0.4]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  """Small eager ops: with the suite's workers sharing the cores, torch's
  intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


class ReplayMpcEnv(tmpc_env.A1MPCGymEnv):
  """The torch MPC env with its draws and its settle replaced by the JAX
  env's."""
  reset_draws = None
  settled = None

  def draw_reset(self, n_env, gen):
    return self.reset_draws

  def settle(self, pos, terrain, dyn):
    return self.settled


def _envs(settle_steps):
  """(JAX env, torch replay env) of the config, policy_freq 2, the
  camera off."""
  with open(CONFIG) as f:
    params = json.load(f)
  params["env"]["env_build"].update(policy_freq=2, get_image=False)
  jenv, _ = jax_get_env(params["env_name"], params["env"])
  jenv.cfg = dataclasses.replace(jenv.cfg, settle_steps=settle_steps)
  tenv, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  renv = ReplayMpcEnv(
      dataclasses.replace(tenv.cfg, settle_steps=settle_steps), device="cpu")
  return jenv, renv


def _replay_reset(jenv, renv, keys):
  """The JAX reset of `keys` and the draws that replay it."""
  jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
  js = jax.tree.map(np.asarray, jstate)
  r = jenv.cfg.random_init_range
  jitter = np.stack([np.asarray(jax.random.uniform(
      jax.random.split(k, 5)[1], (2,), minval=-r, maxval=r)) for k in keys])
  renv.reset_draws = tmpc_env.MpcResetDraws(
      terrain=convert.terrain(js.terrain), init_jitter=torch.tensor(jitter),
      blind=None)
  return jstate, js, np.asarray(jobs)


def _from_jax(template, j, dtype):
  """`template` (a torch state tree) with every tensor taken from the JAX
  state `j` (numpy leaves) by field name, floats in `dtype`; a field the
  JAX state leaves None (no obstacle spheres) keeps the template's."""
  if isinstance(template, torch.Tensor):
    if j is None:
      return template.to(dtype) if template.is_floating_point() else template
    x = torch.tensor(np.asarray(j))
    return x.to(dtype) if template.is_floating_point() else x.to(
        template.dtype)
  return dataclasses.replace(template, **{
      f.name: _from_jax(getattr(template, f.name), getattr(j, f.name), dtype)
      for f in dataclasses.fields(template)})


def _f64(tree):
  return jax.tree.map(
      lambda x: jnp.asarray(x, jnp.float64)
      if np.issubdtype(np.asarray(x).dtype, np.floating) else jnp.asarray(x),
      tree)


@pytest.fixture(scope="module")
def stepped():
  """Reset (JAX settled states injected), then one step of both envs in
  float64 on the same actions; the window's calls counted over the torch
  reset and step."""
  jenv, renv = _envs(SETTLE)
  keys = jax.random.split(jax.random.PRNGKey(8), E)
  jstate, js, jobs = _replay_reset(jenv, renv, keys)
  renv.settled = convert.robot_state(js.robot)
  calls = []
  window = physics_kernel.robot_window

  def counted(*a, **kw):
    calls.append(1)
    return window(*a, **kw)

  gen = torch.Generator().manual_seed(0)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(physics_kernel, "robot_window", counted)
    tstate, tobs = renv.reset(E, gen)
    # the float64 env: the same float32 constants, cast up
    env64 = copy.copy(renv)
    env64.model = _double(renv.model)
    env64.mpc_canon = tmpc.canonical_constants(renv.mpc_cfg).to(
        "cpu", torch.float64)
    env64._act_low, env64._act_high = (renv._act_low.double(),
                                       renv._act_high.double())
    s64 = _from_jax(tstate, js, torch.float64)
    t2, to, tr, td, _ = env64.step_batch(s64, torch.tensor(ACTS).double(),
                                         gen)
    # the toes' contacts with the heightfield after the step
    cfn = env64._contact_fn(t2.terrain, t2.dyn, s64.robot.phys.pos[:, :2])
    toes = (env64._engine_pen(t2.robot, cfn)[:, :4].amax(-1) > 0).sum()

  with jax.enable_x64(True):
    jenv64 = copy.copy(jenv)
    jenv64.model = _f64(jenv.model)
    jenv64.mpc_canon = jmpc.canonical_constants(jenv.mpc_cfg)
    jenv64.action_low = _f64(jenv.action_low)
    jenv64.action_high = _f64(jenv.action_high)
    j2, jo, jr, jd, _ = jax.jit(jax.vmap(jenv64.step))(
        _f64(jstate), jnp.asarray(ACTS, jnp.float64))
    out = jax.tree.map(np.asarray, (j2, jo, jr, jd))
  return ((jobs, tobs.numpy()), out, (t2, to.numpy(), tr.numpy(),
                                      td.numpy()), (len(calls), int(toes)),
          js)


def _rel(got, ref):
  return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_reset_obs_matches_jax(stepped):
  (jobs, tobs), _, _, _, _ = stepped
  assert tobs.shape == jobs.shape == (E, PROPRIO)
  np.testing.assert_allclose(tobs, jobs, atol=1e-5)


def test_step_physics_matches_jax_in_float64(stepped):
  _, (js, _, _, _), (ts, _, _, _), (_, toes), before = stepped
  assert ts.robot.phys.pos.dtype == torch.float64
  for f in ("pos", "quat", "joint_q"):
    np.testing.assert_allclose(getattr(ts.robot.phys, f).numpy(),
                               getattr(js.robot.phys, f), atol=1e-9,
                               err_msg=f)
  for f in ("lin", "ang", "joint_qd"):
    np.testing.assert_allclose(getattr(ts.robot.phys, f).numpy(),
                               getattr(js.robot.phys, f), atol=1e-7,
                               err_msg=f)
  np.testing.assert_allclose(ts.robot.observed_torques.numpy(),
                             js.robot.observed_torques, rtol=1e-8, atol=1e-8)
  np.testing.assert_allclose(ts.robot.obs_hist.numpy(), js.robot.obs_hist,
                             atol=1e-7)
  np.testing.assert_array_equal(ts.robot.step_counter.numpy(),
                                js.robot.step_counter)
  # the robots moved, and stand on the heightfield: the contacts were in
  # the check
  moved = np.abs(js.robot.phys.pos - before.robot.phys.pos).max()
  assert moved > 1e-4 and toes >= 4


def test_step_controller_matches_jax_in_float64(stepped):
  _, (js, _, _, _), (ts, _, _, _), _, _ = stepped
  tc, jc = ts.controller, js.controller
  for f in ("leg_state", "desired_leg_state", "vel_count"):
    np.testing.assert_array_equal(getattr(tc, f).numpy(), getattr(jc, f),
                                  err_msg=f)
  for f in ("normalized_phase", "swing_start_foot_pos", "vel_window",
            "swing_joint_angles"):
    np.testing.assert_allclose(getattr(tc, f).numpy(), getattr(jc, f),
                               atol=1e-9, err_msg=f)
  for f in ("x", "z", "y", "kinv"):
    assert _rel(getattr(tc.qp_warm, f).numpy(),
                getattr(jc.qp_warm, f)) < 1e-8, f
  np.testing.assert_allclose(ts.current_time.numpy(), js.current_time,
                             atol=1e-12)
  # legs in stance: the warm QP's torques drove the step
  assert (jc.leg_state == 1).any()
  assert np.abs(js.robot.observed_torques).max() > 1.0


def test_step_reward_done_obs_match_jax_in_float64(stepped):
  _, (js, jo, jr, jd), (ts, to, tr, td), _, _ = stepped
  np.testing.assert_allclose(tr, jr, atol=1e-9)
  np.testing.assert_array_equal(td, jd)
  np.testing.assert_array_equal(ts.step_counter.numpy(), js.step_counter)
  np.testing.assert_allclose(ts.task.current_base_pos.numpy(),
                             js.task.current_base_pos, atol=1e-9)
  assert to.dtype == jo.dtype == np.float32 and to.shape == (E, PROPRIO)
  np.testing.assert_allclose(to, jo, atol=1e-6)
  assert np.isfinite(to).all() and np.isfinite(tr).all()


def test_step_launches_no_window(stepped):
  _, _, _, (calls, _), _ = stepped
  assert calls == 0


def test_settle_matches_jax_over_its_first_substeps():
  """The reset's settle on the heightfield (the per-env engine, every box
  unpruned) against the JAX reset's, cut to 20 substeps."""
  jenv, renv = _envs(20)
  keys = jax.random.split(jax.random.PRNGKey(9), E)
  jstate, js, _ = _replay_reset(jenv, renv, keys)
  draws = renv.reset_draws
  init = torch.tensor(tterr.INIT_POSITION[renv.cfg.terrain_type])
  pos = torch.cat([init[:2] + draws.init_jitter, init[2].expand(E, 1)], 1)
  dyn = tmpc_env.a1.default_dynamics(renv.model, (E,))
  rs = tmpc_env.A1MPCGymEnv.settle(renv, pos, draws.terrain, dyn)
  jp = js.robot.phys
  np.testing.assert_allclose(rs.phys.pos.numpy(), jp.pos, atol=1e-5)
  np.testing.assert_allclose(rs.phys.joint_q.numpy(), jp.joint_q, atol=3e-5)
  np.testing.assert_allclose(rs.phys.lin.numpy(), jp.lin, atol=6e-3)
  np.testing.assert_allclose(rs.phys.joint_qd.numpy(), jp.joint_qd,
                             atol=6e-3)
  np.testing.assert_allclose(rs.obs_hist.numpy(), js.robot.obs_hist,
                             atol=6e-3)
  # no height shift at the reset: the robot starts at the config's 0.32 m
  # and is still falling after 20 substeps
  assert (rs.phys.pos[:, 2] < 0.32).all() and (rs.phys.pos[:, 2] > 0.3).all()
  assert renv.settle_windows == 0
