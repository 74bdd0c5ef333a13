"""The port's locomotion-controller demo
(vision4leg_torch/starter/locomotion_controller_example.py) against the
JAX package's MPC env, on the CPU.

The demo's tick is `A1MPCGymEnv.controller_step`: one exact KKT inverse
of the warm QP, then the env's controller tick (one hybrid window
launch).  Its reference is the JAX env's `kkt_inverse` and
`_controller_tick` composed the same way per tick: the JAX demo alone
carries the KKT inverse across the run and its robot falls (ROADMAP
section 3).  The first 40 ticks run in float64 on both sides (JAX under
jax.enable_x64) from the JAX reset state injected into the port, since
the 300-substep settle is chaotic between implementations (ROADMAP
section 3).  Tolerances, those of tests/test_torch_mpc_nonflat.py for a
float64 step: positions, rpy and joint angles 1e-9, velocities 1e-7, the
warm QP's iterates 1e-8 relative; the clock 1e-12.  The CLI runs each
robot for 0.25 s on the CPU.
"""
import copy
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env_nonflat import _double
from test_torch_mpc_nonflat import _f64, _from_jax
from vision4leg_tpu.envs import mpc_env as jmpc_env
from vision4leg_tpu.mpc import convex_mpc as jmpc
from vision4leg_tpu.mpc import leg_kinematics as jlk
from vision4leg_tpu.physics import maths as jmaths
from vision4leg_torch.mpc import convex_mpc as tmpc
from vision4leg_torch.ops import physics_kernel
from vision4leg_torch.starter import locomotion_controller_example as demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  """Small eager ops: with the suite's workers sharing the cores, torch's
  intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _jax_demo():
  """The JAX package's demo module (its speed profile), loaded from the
  file: starter/ is not a package."""
  spec = importlib.util.spec_from_file_location(
      "jax_locomotion_demo",
      os.path.join(ROOT, "starter", "locomotion_controller_example.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _jax_ticks(jenv, state, mult, n):
  """n ticks of the JAX env: the yawless exact KKT inverse, then
  `_controller_tick` at the demo profile's command; the base and
  controller after each."""
  speed_profile = _jax_demo().speed_profile

  def tick(state, _):
    lin, ang = speed_profile(state.current_time, mult)
    rs = state.robot
    rpy = jmaths.quat_to_rpy(rs.phys.quat)
    kinv = jmpc.kkt_inverse(jenv.mpc_cfg, jenv.mpc_canon, rpy.at[2].set(0.0),
                            jlk.foot_positions_base_frame(rs.phys.joint_q))
    cs = state.controller
    state = state.replace(controller=cs.replace(
        qp_warm=cs.qp_warm._replace(kinv=kinv)))
    cfn = jenv._contact_fn(state.terrain, state.dyn,
                           base_xy=rs.phys.pos[:2])
    state = jenv._controller_tick(state, lin, ang, cfn)
    phys = state.robot.phys
    return state, (state.current_time, phys.pos,
                   jmaths.quat_to_rpy(phys.quat),
                   jmaths.quat_rotate_inv(phys.quat, phys.lin))

  return jax.lax.scan(tick, state, None, length=n)


@pytest.fixture(scope="module")
def ticked():
  """The JAX reset (float32, as the demo's), then TICKS ticks of both in
  float64 from it; the port's window launches counted."""
  cfg = demo.demo_config()
  jenv = jmpc_env.A1MPCGymEnv(jmpc_env.MpcEnvConfig(
      **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
  jstate = jax.jit(jax.vmap(jenv.reset))(
      jax.random.PRNGKey(0)[None])[0]
  js = jax.tree.map(np.asarray, jstate)
  mult = demo.robot_params.A1.velocity_multiplier
  with jax.enable_x64(True):
    jenv64 = copy.copy(jenv)
    jenv64.model = _f64(jenv.model)
    jenv64.mpc_canon = jmpc.canonical_constants(jenv.mpc_cfg)
    s0 = jax.tree.map(lambda x: x[0], _f64(jstate))
    jlast, jtraj = jax.jit(lambda s: _jax_ticks(jenv64, s, mult, TICKS))(s0)
    jlast, jtraj = jax.tree.map(np.asarray, (jlast, jtraj))

  env = demo.build_env("a1", device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=5)
  tstate, _ = env.reset(1, torch.Generator().manual_seed(0))
  env64 = copy.copy(env)
  env64.model = _double(env.model)
  env64.mpc_canon = tmpc.canonical_constants(env.mpc_cfg).to(
      "cpu", torch.float64)
  s64 = _from_jax(tstate, js, torch.float64)
  calls = []
  window = physics_kernel.robot_window

  def counted(*a, **kw):
    calls.append(a[8])
    return window(*a, **kw)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(physics_kernel, "robot_window", counted)
    traj = demo.run("a1", env=env64, state=s64, ticks=TICKS)
  return jlast, jtraj, traj, calls, js


def test_ticks_match_jax_in_float64(ticked):
  jlast, (jt, jpos, jrpy, jvel), traj, _, _ = ticked
  assert traj["pos"].dtype == np.float64 and traj["pos"].shape == (TICKS, 3)
  np.testing.assert_allclose(traj["t"], jt, atol=1e-12)
  np.testing.assert_allclose(traj["pos"], jpos, atol=1e-9)
  np.testing.assert_allclose(traj["rpy"], jrpy, atol=1e-9)
  np.testing.assert_allclose(traj["vel_body"], jvel, atol=1e-7)
  ts = traj["state"]
  np.testing.assert_allclose(ts.robot.phys.joint_q[0].numpy(),
                             jlast.robot.phys.joint_q, atol=1e-9)
  np.testing.assert_allclose(ts.robot.phys.joint_qd[0].numpy(),
                             jlast.robot.phys.joint_qd, atol=1e-7)
  tc, jc = ts.controller, jlast.controller
  for f in ("leg_state", "desired_leg_state", "vel_count"):
    np.testing.assert_array_equal(getattr(tc, f)[0].numpy(),
                                  getattr(jc, f), err_msg=f)
  for f in ("x", "z", "y", "kinv"):
    got, want = getattr(tc.qp_warm, f)[0].numpy(), getattr(jc.qp_warm, f)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-8, f
  # the gait switched legs and the stance torques drove the window
  assert len(np.unique(jc.leg_state)) >= 2
  assert np.abs(jlast.robot.observed_torques).max() > 1.0


def test_each_tick_launches_the_hybrid_window_once(ticked):
  _, _, _, calls, _ = ticked
  assert calls == [5] * TICKS


def test_speed_profile_matches_the_jax_demo():
  jdemo = _jax_demo()
  t = np.arange(0.0, 40.0, 0.25, dtype=np.float32)
  for mult in (0.5, 0.7, 1.0):
    jlin, jang = jax.vmap(lambda x: jdemo.speed_profile(x, mult))(
        jnp.asarray(t))
    lin, ang = demo.speed_profile(torch.tensor(t), mult)
    np.testing.assert_array_equal(lin.numpy(), np.asarray(jlin))
    np.testing.assert_array_equal(ang.numpy(), np.asarray(jang))


def test_segment_report():
  """Per SEGMENT_S: the command at the segment's end, the mean speed
  error and height."""
  t = np.arange(2000, dtype=np.float64) * 0.005
  lin = np.zeros((2000, 3))
  lin[t >= 5.0, 0] = 0.3
  vel = lin + 0.1
  traj = dict(t=t, lin=lin, ang=np.zeros(2000), vel_body=vel,
              pos=np.c_[np.zeros((2000, 2)), np.full(2000, 0.26)],
              rpy=np.zeros((2000, 3)))
  rep = demo.segment_report(traj)
  assert [(r["t0"], r["t1"]) for r in rep] == [(0.0, 5.0), (5.0, 10.0)]
  assert rep[1]["cmd_vx"] == pytest.approx(0.3)
  for r in rep:
    assert r["v_err"] == pytest.approx(np.sqrt(0.02))
    assert r["z"] == pytest.approx(0.26)
  assert demo.upright(traj)
  traj["pos"][7, 2] = 0.1
  assert not demo.upright(traj)
  assert len(demo.segment_lines(traj)) == 2


@pytest.mark.parametrize("robot", ["a1", "laikago", "spirit40"])
def test_cli_runs_each_robot_on_the_cpu(robot, capsys):
  rc = demo.main(["--robot", robot, "--max_time", "0.25", "--device", "cpu"])
  out = capsys.readouterr().out
  assert rc == 0, out
  assert f"robot={robot}  sim 0.2s" in out and "upright=True" in out
  assert "t=[ 0.0, 5.0)s" in out
  assert ("note: articulated body is the A1" in out) == (robot != "a1")


def test_build_env_swaps_mass_and_inertia_only():
  env = demo.build_env("laikago", device="cpu")
  a1 = demo.build_env("a1", device="cpu")
  rp = demo.robot_params.LAIKAGO
  assert env.mpc_cfg.mass == rp.body_mass
  assert env.mpc_cfg.inertia == tuple(rp.body_inertia)
  assert env.mpc_cfg._replace(mass=0, inertia=()) == a1.mpc_cfg._replace(
      mass=0, inertia=())
  # the A1's frozen QP scaling is kept, as the JAX demo keeps it
  assert torch.equal(env.mpc_canon.kinv0, a1.mpc_canon.kinv0)
