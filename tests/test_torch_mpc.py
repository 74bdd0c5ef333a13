"""Parity of the port's MPC controller stack (vision4leg_torch.mpc) with
the JAX package on the CPU.

Inputs are drawn with numpy from fixed seeds, or read off a short
trajectory of the port's A1MoveGroundMPC env, and handed to both sides.

Tolerances and why:
  * leg kinematics (FK, Jacobians, IK), float32: 1e-6 absolute on values
    of O(0.3) (a few float32 roundings of the trigonometry);
  * gait / estimator / swing, float32: 1e-5 (the swing target goes
    through the IK and its arccos);
  * the QP (`_build_qp` pieces, `canonical_constants`, `kkt_inverse`,
    `compute_contact_forces_warm` chained along the trajectory) in
    float64 against the same JAX functions run under jax_enable_x64 in a
    subprocess (x64 is a process-wide switch), 1e-8 relative to the
    largest entry of each quantity: the condensed QP keeps cond ~1.5e8
    after equilibration (tests/test_mpc.py:401-410), so float32 parity of
    the solver would prove nothing, while float64 leaves ~1e-8 of room;
  * float32 forces only within the JAX package's own 0.35 band of the
    float64 forces (tests/test_mpc.py:352-399);
  * degenerate poses and NaN-poisoned warm state (tests/test_mpc.py:
    443-491): finite outputs, |f| <= fmax, and per env: a bad env does
    not change its neighbours' results.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.mpc import controllers as jctrl
from vision4leg_tpu.mpc import leg_kinematics as jlk
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.mpc import controllers as tctrl
from vision4leg_torch.mpc import convex_mpc as tmpc
from vision4leg_torch.mpc import leg_kinematics as tlk
from vision4leg_torch.physics import maths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config/mpc/locotransformer/thin-goal.json")
LO = np.array([-0.8, 0.2, -2.4] * 4, np.float32)
HI = np.array([0.8, 1.4, -1.0] * 4, np.float32)


def _q(rng, n):
  """Joint angles in the locomotion envelope (foot below the hip)."""
  return (LO + (HI - LO) * rng.uniform(size=(n, 12))).astype(np.float32)


def test_leg_kinematics_match_jax():
  rng = np.random.default_rng(0)
  q = _q(rng, 16)
  j_feet = np.asarray(jax.vmap(jlk.foot_positions_base_frame)(q))
  j_jac = np.asarray(jax.vmap(jlk.all_leg_jacobians)(q))
  t_feet = tlk.foot_positions_base_frame(torch.tensor(q))
  np.testing.assert_allclose(t_feet.numpy(), j_feet, atol=1e-6)
  np.testing.assert_allclose(tlk.all_leg_jacobians(torch.tensor(q)).numpy(),
                             j_jac, atol=1e-6)
  for leg in range(4):
    rel = j_feet[:, leg] - jlk.HIP_ORIGINS[leg].astype(np.float32)
    j_ik = np.asarray(jax.vmap(lambda p: jlk.foot_ik_hip_frame(
        p, float(jlk.SIDE_SIGN[leg])))(rel))
    t_ik = tlk.foot_ik_base_frame(t_feet[:, leg], leg)
    np.testing.assert_allclose(t_ik.numpy(), j_ik, atol=1e-6)
    np.testing.assert_allclose(t_ik.numpy(), q[:, 3 * leg:3 * leg + 3],
                               atol=1e-4)


def _controller_inputs(seed, E=16):
  rng = np.random.default_rng(seed)
  f32 = lambda x: np.asarray(x, np.float32)
  feet = np.asarray(jax.vmap(jlk.foot_positions_base_frame)(_q(rng, E)))
  cs = dict(
      leg_state=rng.integers(0, 4, (E, 4)).astype(np.int32),
      desired_leg_state=rng.integers(0, 4, (E, 4)).astype(np.int32),
      normalized_phase=f32(rng.uniform(size=(E, 4))),
      swing_start_foot_pos=f32(feet + rng.normal(0, 0.02, feet.shape)),
      vel_window=f32(rng.normal(0, 0.3, (E, tctrl.VEL_WINDOW, 3))),
      vel_count=rng.integers(0, tctrl.VEL_WINDOW + 1, E).astype(np.int32),
      swing_joint_angles=_q(rng, E))
  step = dict(
      time=f32(rng.uniform(0, 3, E)),
      contacts=rng.uniform(size=(E, 4)) < 0.5,
      vel_body=f32(rng.normal(0, 0.3, (E, 3))),
      yaw_rate=f32(rng.normal(0, 0.5, E)),
      speed=f32(np.c_[rng.uniform(-0.05, 0.3, E), np.zeros((E, 2))]),
      twist=f32(rng.uniform(-0.4, 0.4, E)),
      feet=np.asarray(jax.vmap(jlk.foot_positions_base_frame)(_q(rng, E))))
  return cs, step


def test_gait_estimator_swing_match_jax():
  """One tick of the controller's bookkeeping: gait_update,
  estimator_update, com_velocity_body and swing_action, float32."""
  cs_np, s = _controller_inputs(1)
  gait = jctrl.GaitConfig()

  def jtick(cs, t, fc, v, yr, sp, tw, feet):
    cs = jctrl.gait_update(gait, cs, t, fc)
    g = (cs.leg_state, cs.desired_leg_state, cs.normalized_phase)
    cs = jctrl.estimator_update(cs, v)
    com = jctrl.com_velocity_body(cs)
    cs, ang = jctrl.swing_action(cs, gait, yr, sp, tw, feet)
    return g, com, cs, ang

  jcs = jctrl.ControllerState(**{k: jnp.asarray(v) for k, v in
                                 cs_np.items()})
  jg, jcom, jcs2, jang = jax.jit(jax.vmap(jtick))(
      jcs, s["time"], s["contacts"], s["vel_body"], s["yaw_rate"],
      s["speed"], s["twist"], s["feet"])

  t = lambda x: torch.tensor(np.asarray(x))
  tcs = tctrl.ControllerState(**{k: t(v) for k, v in cs_np.items()},
                              qp_warm=None)
  tcs = tctrl.gait_update(gait, tcs, t(s["time"]), t(s["contacts"]))
  np.testing.assert_array_equal(tcs.leg_state.numpy(), np.asarray(jg[0]))
  np.testing.assert_array_equal(tcs.desired_leg_state.numpy(),
                                np.asarray(jg[1]))
  np.testing.assert_allclose(tcs.normalized_phase.numpy(), np.asarray(jg[2]),
                             atol=1e-5)
  tcs = tctrl.estimator_update(tcs, t(s["vel_body"]))
  np.testing.assert_allclose(tctrl.com_velocity_body(tcs).numpy(),
                             np.asarray(jcom), atol=1e-5)
  tcs, tang = tctrl.swing_action(tcs, gait, t(s["yaw_rate"]), t(s["speed"]),
                                 t(s["twist"]), t(s["feet"]))
  np.testing.assert_allclose(tang.numpy(), np.asarray(jang), atol=1e-5)
  np.testing.assert_allclose(tcs.swing_start_foot_pos.numpy(),
                             np.asarray(jcs2.swing_start_foot_pos), atol=1e-6)
  np.testing.assert_array_equal(tcs.vel_count.numpy(),
                                np.asarray(jcs2.vel_count))
  # the draws cover every leg state and both branches of the swing phase
  assert set(np.unique(tcs.leg_state.numpy())) == {0, 1, 2, 3}
  assert (tcs.normalized_phase <= 0.5).any() and (
      tcs.normalized_phase > 0.5).any()


# ---------------------------------------------------------------------------
# the QP along a short trajectory, float64 against JAX under x64
# ---------------------------------------------------------------------------

N_ENV, N_STEPS = 2, 6

_X64 = r'''
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from vision4leg_tpu.mpc import convex_mpc as cm

d = dict(np.load(sys.argv[1]))
cfg = cm.MpcConfig(mass=float(d["mass"]), inertia=tuple(d["inertia"]),
                   qp_weights=tuple(d["qp_weights"]), horizon=10,
                   timestep=0.025, alpha=1e-5, admm_iters=40)
canon = cm.canonical_constants(cfg)
out = {f"canon_{k}": np.asarray(v) for k, v in canon._asdict().items()}
build = jax.jit(lambda *a: cm._build_qp(cfg, *a))
kkt = jax.jit(lambda P, c: cm._scaled_kkt(canon, P, c))
kinv_fn = jax.jit(lambda r, f: cm.kkt_inverse(cfg, canon, r, f))
solve = jax.jit(lambda w, *a: cm.compute_contact_forces_warm(
    cfg, canon, w, *a, warm_iters=cfg.warm_iters, ns_iters=cfg.ns_iters))
T, E = d["rpy"].shape[:2]
res = {k: [] for k in ("P", "q", "cone", "lb", "ub", "K", "kinv", "f", "x",
                       "z", "y")}
for e in range(E):
  warm = cm.init_warm_state(canon)
  for t in range(T):
    args = (jnp.zeros(1), d["com_vel"][t, e], d["rpy"][t, e],
            d["rpy_rate"][t, e], d["contact"][t, e], d["feet"][t, e],
            jnp.full(4, 0.45), jnp.array([0.0, 0.0, 0.24]),
            d["speed"][t, e], jnp.zeros(3), d["twist"][t, e])
    P, q, cone, lb, ub = build(*args)
    K, _ = kkt(P, cone)
    kinv = kinv_fn(d["rpy"][t, e], d["feet"][t, e])
    f, warm = solve(warm._replace(kinv=kinv), *args)
    for k, v in zip(res, (P, q, cone, lb, ub, K, kinv, f, warm.x, warm.z,
                          warm.y)):
      res[k].append(np.asarray(v))
for k, v in res.items():
  out[k] = np.stack(v).reshape((E, T) + v[0].shape).swapaxes(0, 1)
np.savez(sys.argv[2], **out)
print("OK")
'''


def _rel(got, ref):
  """Largest |got - ref| over the largest |ref|."""
  got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
  return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def trajectory():
  """The MPC controller's inputs at the start of each of N_STEPS env steps
  of the port's env (plane, commanded 0.3 m/s forward), N_ENV envs: the
  poses, rates and contact states of a real gait, across its switches."""
  with open(CONFIG) as f:
    params = json.load(f)
  build = dict(params["env"]["env_build"], terrain_type="plane",
               get_image=False, check_contact=False)
  env, _ = get_env("A1MoveGroundMPC", dict(params["env"], env_build=build),
                   device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=100)
  gen = torch.Generator().manual_seed(0)
  states, _ = env.reset(N_ENV, gen)
  act = torch.tensor([[0.3, 0.1], [0.25, -0.2]])
  rec = {k: [] for k in ("com_vel", "rpy", "rpy_rate", "contact", "feet",
                         "speed", "twist")}
  for _ in range(N_STEPS):
    cs, phys = states.controller, states.robot.phys
    rpy = maths.quat_to_rpy(phys.quat)
    rec["com_vel"].append(tctrl.com_velocity_body(cs))
    rec["rpy"].append(torch.cat([rpy[:, :2], torch.zeros(N_ENV, 1)], 1))
    rec["rpy_rate"].append(maths.quat_rotate_inv(phys.quat, phys.ang))
    rec["contact"].append(((cs.desired_leg_state == 1)
                           | (cs.desired_leg_state == 2)).int())
    rec["feet"].append(tlk.foot_positions_base_frame(phys.joint_q))
    rec["speed"].append(torch.cat([act[:, :1], torch.zeros(N_ENV, 2)], 1))
    rec["twist"].append(torch.cat([torch.zeros(N_ENV, 2), act[:, 1:]], 1))
    states, _, _, done, _ = env.step_batch(states, act, gen)
    assert not done.any()
  traj = {k: torch.stack(v).double().numpy() for k, v in rec.items()}
  traj["contact"] = traj["contact"].astype(np.int64)
  # the trajectory crosses gait switches: contact states vary over it
  assert len(np.unique(traj["contact"].reshape(-1, 4), axis=0)) >= 2
  return env.mpc_cfg, traj


@pytest.fixture(scope="module")
def x64(trajectory, tmp_path_factory):
  cfg, traj = trajectory
  d = tmp_path_factory.mktemp("mpc_x64")
  np.savez(d / "in.npz", mass=cfg.mass, inertia=np.asarray(cfg.inertia),
           qp_weights=np.asarray(cfg.qp_weights, np.float64), **traj)
  proc = subprocess.run([sys.executable, "-c", _X64, str(d / "in.npz"),
                         str(d / "out.npz")], capture_output=True, text=True,
                        timeout=900, cwd=ROOT)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return dict(np.load(d / "out.npz"))


def _torch_chain(cfg, canon, traj, dtype):
  """The port's pieces along the trajectory, warm state chained per env."""
  t = lambda k: torch.tensor(traj[k], dtype=dtype)
  canon = canon.to("cpu", dtype)
  warm = tmpc.init_warm_state(canon, N_ENV)
  out = {k: [] for k in ("P", "q", "cone", "lb", "ub", "K", "kinv", "f",
                         "x", "z", "y")}
  for s in range(N_STEPS):
    args = (torch.zeros(N_ENV, 1, dtype=dtype), t("com_vel")[s], t("rpy")[s],
            t("rpy_rate")[s], t("contact")[s].int(), t("feet")[s],
            torch.full((N_ENV, 4), 0.45, dtype=dtype),
            torch.tensor([0.0, 0.0, 0.24], dtype=dtype), t("speed")[s],
            torch.zeros(3, dtype=dtype), t("twist")[s])
    P, q, cone, lb, ub = tmpc._build_qp(cfg, *args)
    K, _ = tmpc._scaled_kkt(canon, P, cone)
    kinv = tmpc.kkt_inverse(cfg, canon, t("rpy")[s], t("feet")[s])
    f, warm = tmpc.compute_contact_forces_warm(
        cfg, canon, warm.replace(kinv=kinv), *args,
        warm_iters=cfg.warm_iters, ns_iters=cfg.ns_iters)
    for k, v in zip(out, (P, q, cone, lb, ub, K, kinv, f, warm.x, warm.z,
                          warm.y)):
      out[k].append(v)
  return {k: torch.stack(v).numpy() for k, v in out.items()}


def test_canonical_constants_match_jax_x64(trajectory, x64):
  cfg, _ = trajectory
  canon = tmpc.canonical_constants(cfg)
  for f in dataclasses.fields(canon):
    got = getattr(canon, f.name).numpy()
    assert _rel(got, x64[f"canon_{f.name}"]) < 1e-8, f.name


@pytest.fixture(scope="module")
def chain64(trajectory):
  cfg, traj = trajectory
  return _torch_chain(cfg, tmpc.canonical_constants(cfg), traj,
                      torch.float64)


@pytest.mark.parametrize("piece", ["P", "q", "cone", "lb", "ub", "K", "kinv",
                                   "f", "x", "z", "y"])
def test_warm_qp_matches_jax_x64_along_trajectory(chain64, x64, piece):
  """Every piece of the warm path in float64, warm state chained over
  the trajectory, against the JAX package's functions under x64."""
  err = _rel(chain64[piece], x64[piece])
  assert err < 1e-8, (piece, err)
  if piece == "f":
    # the forces carry the robot: about its weight in total on the ground
    fz = -chain64["f"][..., 2].sum(-1)
    assert (fz > 50).all() and (fz < 250).all(), fz


def test_float32_forces_within_the_jax_band(trajectory, x64):
  """What the env runs: float32 warm forces, chained along the same
  trajectory, within the JAX package's 0.35 band of the float64 forces
  (the band its own f32 solver carries on the a1 SRB case)."""
  cfg, traj = trajectory
  got = _torch_chain(cfg, tmpc.canonical_constants(cfg), traj,
                     torch.float32)
  ref = x64["f"]
  for s in range(N_STEPS):
    err = np.abs(got["f"][s] - ref[s]).max() / max(np.abs(ref[s]).max(), 1.0)
    assert err < 0.35, (s, err)


# ---------------------------------------------------------------------------
# degenerate poses and poisoned warm state
# ---------------------------------------------------------------------------

DEG_CFG = tmpc.MpcConfig(
    mass=12.5, inertia=(0.0017, 0, 0, 0, 0.0057, 0, 0, 0, 0.0064),
    qp_weights=(5, 5, 0.2, 0, 0, 10, 0., 0., 1., 1., 1., 0., 0))
FEET_NOM = [[0.17, -0.13, -0.25], [0.17, 0.13, -0.25],
            [-0.17, -0.13, -0.25], [-0.17, 0.13, -0.25]]


def _solve(canon, warm, rpy, vel, rate):
  E = rpy.shape[0]
  feet = torch.tensor(FEET_NOM).expand(E, 4, 3)
  return tmpc.compute_contact_forces_warm(
      DEG_CFG, canon, warm, torch.zeros(E, 1), vel, rpy, rate,
      torch.ones(E, 4, dtype=torch.int32), feet, torch.full((E, 4), 0.45),
      torch.tensor([0.0, 0.0, 0.25]), torch.tensor([0.3, 0.0, 0.0]),
      torch.zeros(3), torch.zeros(3))


def test_warm_mpc_survives_degenerate_poses():
  """tests/test_mpc.py::test_warm_mpc_survives_degenerate_poses, batched:
  a face-plant (pitch at pi/2), upside down and pitched, and nominal, in
  one batch; then NaN-poisoned carried state and a NaN pose next to a
  healthy env.  Every output is finite and inside the force box, and the
  bad envs change nothing in the healthy one."""
  canon = tmpc.canonical_constants(DEG_CFG).to("cpu", torch.float32)
  fmax = DEG_CFG.mass * 9.8 * 10.0 * 2.0
  feet = torch.tensor(FEET_NOM).expand(3, 4, 3)
  rpy = torch.tensor([[0.0, 1.5707, 0.0], [3.1, -1.57, 0.0],
                      [0.0, 0.0, 0.0]])
  kinv = tmpc.kkt_inverse(DEG_CFG, canon, rpy, feet)
  assert torch.isfinite(kinv).all()
  warm = tmpc.init_warm_state(canon, 3).replace(kinv=kinv)
  f, _ = _solve(canon, warm, rpy, torch.tensor([[0.0, 0.0, -3.0]] * 3),
                torch.tensor([[9.0, -7.0, 2.0]] * 3))
  assert torch.isfinite(f).all() and f.abs().max() <= fmax + 1e-3
  # each env's result is its own: the nominal env alone gives the same
  f1, _ = _solve(canon, tmpc.init_warm_state(canon, 1).replace(
      kinv=kinv[2:]), rpy[2:], torch.tensor([[0.0, 0.0, -3.0]]),
      torch.tensor([[9.0, -7.0, 2.0]]))
  np.testing.assert_allclose(f[2].numpy(), f1[0].numpy(), rtol=1e-5,
                             atol=1e-4)

  # NaN-poisoned carried state self-heals to finite zero forces, and only
  # in the poisoned env
  good = tmpc.init_warm_state(canon, 2)
  bad = good.replace(x=good.x.clone())
  bad.x[0] = float("nan")
  zero3 = torch.zeros(2, 3)
  f_bad, healed = _solve(canon, bad, zero3, zero3, zero3)
  f_good, _ = _solve(canon, good, zero3, zero3, zero3)
  assert torch.isfinite(f_bad).all() and torch.isfinite(healed.x).all()
  assert torch.equal(f_bad[0], torch.zeros(4, 3))
  assert torch.equal(healed.kinv[0], canon.kinv0)
  np.testing.assert_array_equal(f_bad[1].numpy(), f_good[1].numpy())

  # a NaN pose: its K is not finite, so its inverse falls back to the
  # canonical one; the healthy env's inverse is its own
  rpy_nan = torch.tensor([[float("nan"), 0.0, 0.0], [0.0, 0.0, 0.0]])
  kinv2 = tmpc.kkt_inverse(DEG_CFG, canon, rpy_nan, feet[:2])
  assert torch.equal(kinv2[0], canon.kinv0)
  np.testing.assert_allclose(kinv2[1].numpy(), kinv[2].numpy(), rtol=1e-6,
                             atol=1e-6)


def test_no_tf32_restores_the_callers_setting():
  before = torch.backends.cuda.matmul.allow_tf32
  try:
    torch.backends.cuda.matmul.allow_tf32 = True
    with tmpc.no_tf32():
      assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is True
  finally:
    torch.backends.cuda.matmul.allow_tf32 = before
