"""Parity of the port's cold convex-MPC solve, the cold stance controller,
the QP torque optimizer and the robot parameter sets with the JAX
package, on the CPU.

Inputs come from numpy seeds, or from a short trajectory of the port's
MPC env.  Tolerances and why:
  * float64 against the JAX functions under jax.enable_x64, 1e-8
    relative to the largest entry of each quantity (the Ruiz-scaled QP,
    the ADMM's x, the forces, the torques): the condensed QP keeps cond
    ~1.5e8 after equilibration (tests/test_mpc.py:401-410), so float32
    parity of a solver would prove nothing, while float64 leaves ~1e-8 of
    room (tests/test_torch_mpc.py holds the warm path so); the QP torque
    optimizer's forces 1e-7 (its P has cond 2e6-3.4e6, below);
  * the float32 standing cases at the JAX package's own bands
    (tests/test_mpc.py:73-103: total fz within 25% of the weight; :238-
    289: within 35% (a1) and 10% of the x64 fixed points);
  * the block-diagonal solver against the dense one in float32 at
    rtol 1e-4, atol 1e-5 (tests/test_mpc.py:321-349);
  * the warm path against the cold solve along an 8-step trajectory in
    float32 within 0.35 of the cold forces' largest entry
    (tests/test_mpc.py:352-398);
  * robot_params and pose_utils equal to the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.mpc import controllers as jctrl
from vision4leg_tpu.mpc import convex_mpc as jmpc
from vision4leg_tpu.mpc import leg_kinematics as jlk
from vision4leg_tpu.mpc import qp_torque_optimizer as jqp
from vision4leg_tpu.mpc import robot_params as jrp
from vision4leg_tpu.robots import pose_utils as jpu
from vision4leg_torch.envs.mpc_env import A1MPCGymEnv, MpcEnvConfig
from vision4leg_torch.mpc import controllers as tctrl
from vision4leg_torch.mpc import convex_mpc as tmpc
from vision4leg_torch.mpc import leg_kinematics as tlk
from vision4leg_torch.mpc import qp_torque_optimizer as tqp
from vision4leg_torch.mpc import robot_params as trp
from vision4leg_torch.physics import maths
from vision4leg_torch.robots import a1_params as P
from vision4leg_torch.robots import pose_utils as tpu

WEIGHTS = (5, 5, 0.2, 0, 0, 10, 0., 0., 1., 1., 1., 0., 0)
LO = np.array([-0.8, 0.2, -2.4] * 4, np.float32)
HI = np.array([0.8, 1.4, -1.0] * 4, np.float32)


def _rel(got, ref):
  got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
  return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _cfgs(admm_iters=40):
  """The MPC env's config (A1 RL-MPC SRB) and a1_sim's tiny-inertia one,
  in both packages."""
  a1 = trp.A1
  out = []
  for mass, inertia in ((float(P.MPC_BODY_MASS),
                         tuple(float(x) for x in P.MPC_BODY_INERTIA)),
                        (a1.body_mass, tuple(a1.body_inertia))):
    kw = dict(mass=mass, inertia=inertia, qp_weights=WEIGHTS, horizon=10,
              timestep=0.025, alpha=1e-5, admm_iters=admm_iters)
    out.append((tmpc.MpcConfig(**kw), jmpc.MpcConfig(**kw)))
  return out


def _problems(seed, E=6):
  """MPC state arguments of E envs (float64 numpy): feet of joint angles
  in the locomotion envelope, small tilts, velocities and rates, contact
  sets from all four legs to two, commands."""
  rng = np.random.default_rng(seed)
  q = LO + (HI - LO) * rng.uniform(size=(E, 12))
  feet = np.asarray(jax.vmap(jlk.foot_positions_base_frame)(
      q.astype(np.float32)), np.float64)
  contact = (rng.uniform(size=(E, 4)) < 0.7).astype(np.int32)
  contact[0] = 1
  contact[1] = [1, 0, 0, 1]
  rpy = np.c_[rng.normal(0, 0.05, (E, 2)), np.zeros(E)]
  return dict(
      com_position=np.zeros((E, 1)), com_vel=rng.normal(0, 0.2, (E, 3)),
      rpy=rpy, rpy_rate=rng.normal(0, 0.3, (E, 3)), contact=contact,
      feet=feet, friction=np.full((E, 4), 0.45),
      d_pos=np.array([0.0, 0.0, 0.24]),
      d_vel=np.c_[rng.uniform(-0.05, 0.3, E), np.zeros((E, 2))],
      d_rpy=np.zeros(3),
      d_ang=np.c_[np.zeros((E, 2)), rng.uniform(-0.4, 0.4, E)])


_ORDER = ("com_position", "com_vel", "rpy", "rpy_rate", "contact", "feet",
          "friction", "d_pos", "d_vel", "d_rpy", "d_ang")
_BATCHED = ("com_position", "com_vel", "rpy", "rpy_rate", "contact", "feet",
            "friction", "d_vel", "d_ang")


def _torch_args(pb, dtype=torch.float64):
  return tuple(torch.tensor(pb[k]) if k == "contact"
               else torch.tensor(pb[k], dtype=dtype) for k in _ORDER)


def _jax_x64(fn, pb):
  """fn(*state_args) of one env, vmapped over the batched arguments,
  under x64."""
  axes = tuple(0 if k in _BATCHED else None for k in _ORDER)
  with jax.enable_x64(True):
    args = tuple(jnp.asarray(pb[k]) for k in _ORDER)
    out = jax.jit(jax.vmap(fn, in_axes=axes))(*args)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("cfg_idx", [0, 1])
def test_cold_solve_matches_jax_x64(cfg_idx):
  """The Ruiz-scaled block-diagonal QP, the ADMM's solution and the cold
  forces in float64 against JAX under x64, on the env's SRB and on
  a1_sim's tiny-inertia one (the ill-conditioned case)."""
  tcfg, jcfg = _cfgs()[cfg_idx]
  pb = _problems(10 + cfg_idx)

  def jfn(*a):
    P_, q, cone, lb, ub = jmpc._build_qp(jcfg, *a)
    scaled = jmpc._ruiz_equilibrate_blockdiag(P_, q, cone, lb, ub)
    u = jmpc._admm_box_qp_blockdiag(P_, q, cone, lb, ub, jcfg.admm_iters,
                                    jcfg.rho, jcfg.sigma)
    return scaled, u, jmpc.compute_contact_forces(jcfg, *a)

  j_scaled, j_u, j_f = _jax_x64(jfn, pb)
  args = _torch_args(pb)
  P_, q, cone, lb, ub = tmpc._build_qp(tcfg, *args)
  t_scaled = tmpc._ruiz_equilibrate_blockdiag(P_, q, cone, lb, ub)
  for name, got, want in zip(("P", "q", "A", "lb", "ub", "D"), t_scaled,
                             j_scaled):
    assert _rel(got.numpy(), want) < 1e-8, name
  t_u = tmpc._admm_box_qp_blockdiag(P_, q, cone, lb, ub, tcfg.admm_iters,
                                    tcfg.rho, tcfg.sigma)
  assert _rel(t_u.numpy(), j_u) < 1e-8
  t_f = tmpc.compute_contact_forces(tcfg, *args)
  assert t_f.shape == (6, 4, 3) and t_f.dtype == torch.float64
  assert _rel(t_f.numpy(), j_f) < 1e-8
  # the swing legs carry (almost) no force
  assert np.abs(j_f[1, 1:3]).max() < 0.01 * np.abs(j_f[1]).max()
  if cfg_idx == 0:
    # the stance legs hold the body up; on a1_sim's inertia the 25
    # iterations of admm_iters 40 leave the solve near u = 0, in JAX too
    # (tests/test_mpc.py:238-258 runs it 200)
    assert (-j_f[..., 2].sum(-1) > 50).all()


def test_dense_admm_matches_jax_x64():
  """The dense-constraint solver (the torque optimizer's) on random SPD
  QPs in float64 against JAX under x64, each env its own rho."""
  rng = np.random.RandomState(3)
  E, n, m = 4, 12, 20
  G = rng.randn(E, n, n)
  Pm = G @ G.transpose(0, 2, 1) + 0.1 * np.eye(n)
  q = rng.randn(E, n) * rng.uniform(0.1, 10, (E, 1))
  A = rng.randn(E, m, n)
  lb = -np.abs(rng.randn(E, m))
  ub = np.abs(rng.randn(E, m))
  with jax.enable_x64(True):
    want = np.asarray(jax.jit(jax.vmap(
        lambda *a: jmpc._admm_box_qp(*a, 100, 0.1, 1e-6)))(
            *map(jnp.asarray, (Pm, q, A, lb, ub))))
  got = tmpc._admm_box_qp(*map(torch.tensor, (Pm, q, A, lb, ub)), 100, 0.1,
                          1e-6)
  assert _rel(got.numpy(), want) < 1e-8


def test_blockdiag_matches_dense():
  """tests/test_mpc.py::test_admm_blockdiag_matches_dense: random SPD QPs
  (the JAX test's seed and trials, batched as 3 envs) agree in
  float32."""
  rng = np.random.RandomState(7)
  M, r, c = 8, 5, 3
  n = M * c
  cases = []
  for _ in range(3):
    G = rng.randn(n, n).astype(np.float32)
    P_mat = G @ G.T + 0.1 * np.eye(n, dtype=np.float32)
    q = rng.randn(n).astype(np.float32)
    blocks = rng.randn(M, r, c).astype(np.float32)
    lb = -np.abs(rng.randn(M * r)).astype(np.float32)
    ub = np.abs(rng.randn(M * r)).astype(np.float32)
    dense = np.zeros((M * r, n), np.float32)
    for i in range(M):
      dense[i * r:(i + 1) * r, i * c:(i + 1) * c] = blocks[i]
    cases.append((P_mat, q, blocks, dense, lb, ub))
  P_m, q, blocks, dense, lb, ub = (torch.tensor(np.stack(x))
                                   for x in zip(*cases))
  x_dense = tmpc._admm_box_qp(P_m, q, dense, lb, ub, 100, 0.1, 1e-6)
  x_blk = tmpc._admm_box_qp_blockdiag(P_m, q, blocks, lb, ub, 100, 0.1, 1e-6)
  np.testing.assert_allclose(x_blk.numpy(), x_dense.numpy(), rtol=1e-4,
                             atol=1e-5)


def _standing(cfg, height, feet):
  E = 1
  z = torch.tensor([[0.0, 0.0, height]])
  zeros = torch.zeros(E, 3)
  return tmpc.compute_contact_forces(
      cfg, z, zeros, zeros, zeros, torch.ones(E, 4, dtype=torch.int32),
      torch.tensor(feet, dtype=torch.float32)[None],
      torch.full((E, 4), 0.45), z[0], zeros[0], zeros[0], zeros[0])[0]


def test_cold_standing_float32():
  """tests/test_mpc.py::test_convex_mpc_standing: four feet in stance at
  the desired height, float32: the total fz within 25% of the weight,
  each leg above a tenth of its share."""
  cfg = tmpc.MpcConfig(mass=float(P.MPC_BODY_MASS),
                       inertia=tuple(float(x) for x in P.MPC_BODY_INERTIA),
                       qp_weights=WEIGHTS, admm_iters=60)
  feet = [[0.17, -0.13, -0.24], [0.17, 0.13, -0.24],
          [-0.19, -0.13, -0.24], [-0.19, 0.13, -0.24]]
  f = _standing(cfg, 0.24, feet).numpy()
  weight = float(P.MPC_BODY_MASS) * 9.8
  total = -f[:, 2].sum()
  assert abs(total - weight) / weight < 0.25, (total, weight)
  assert np.all(-f[:, 2] > 0.1 * weight / 4)


@pytest.mark.parametrize("name", ["a1", "laikago", "spirit40"])
def test_cold_standing_all_robots_float32(name):
  """tests/test_mpc.py::test_convex_mpc_standing_all_robots: each robot's
  standing QP near its x64 ADMM fixed point, in float32 (the a1 row's
  band is 35%: cond ~1.5e8 after equilibration)."""
  expected = {"a1": 126.5, "laikago": 253.9, "spirit40": 139.4}[name]
  tol = {"a1": 0.35, "laikago": 0.10, "spirit40": 0.10}[name]
  rp = trp.ROBOTS[name]
  cfg = tmpc.MpcConfig(mass=rp.body_mass,
                       inertia=tuple(float(x) for x in rp.body_inertia),
                       qp_weights=WEIGHTS, admm_iters=200)
  feet = [[hx, hy, -rp.body_height] for hx, hy, _ in rp.hip_positions]
  f = _standing(cfg, rp.body_height, feet).numpy()
  total = float(-f[:, 2].sum())
  weight = rp.body_mass * 9.8
  assert abs(total - expected) / expected < tol, (name, total)
  assert 0.75 * weight < total < 1.5 * weight
  assert np.all(-f[:, 2] > 0.1 * weight / 4)


def test_warm_matches_cold_along_trajectory():
  """tests/test_mpc.py::test_warm_mpc_matches_cold_along_trajectory on the
  port's env (plane, policy_freq 20, settle 100, 0.3 m/s forward): at
  the start of each of 8 env steps, across the first gait switches, the
  warm forces from the carried state and a fresh KKT inverse within 0.35
  of the cold forces, float32."""
  env = A1MPCGymEnv(MpcEnvConfig(
      motor_control_mode="POSITION", clip_num=(0.3, 0.4), time_step_s=0.001,
      num_action_repeat=5, policy_freq=20, terrain_type="plane",
      target_vel=0.3, check_contact=False, settle_steps=100,
      alive_reward=0.1), device="cpu")
  gen = torch.Generator().manual_seed(0)
  state, _ = env.reset(1, gen)
  act = torch.tensor([[0.3, 0.0]])
  errs, switches = [], set()
  for _ in range(8):
    rs, cs = state.robot, state.controller
    rpy = maths.quat_to_rpy(rs.phys.quat)
    yawless = torch.cat([rpy[:, :2], torch.zeros(1, 1)], 1)
    rate = maths.quat_rotate_inv(rs.phys.quat, rs.phys.ang)
    feet = tlk.foot_positions_base_frame(rs.phys.joint_q)
    contact = ((cs.desired_leg_state == 1)
               | (cs.desired_leg_state == 2)).int()
    switches.add(tuple(contact[0].tolist()))
    args = (torch.zeros(1, 1), tctrl.com_velocity_body(cs), yawless, rate,
            contact, feet, torch.full((1, 4), 0.45),
            torch.tensor([0.0, 0.0, tctrl.MPC_BODY_HEIGHT]),
            torch.tensor([0.3, 0.0, 0.0]), torch.zeros(3), torch.zeros(3))
    f_cold = tmpc.compute_contact_forces(env.mpc_cfg, *args)
    kinv = tmpc.kkt_inverse(env.mpc_cfg, env.mpc_canon, yawless, feet)
    f_warm, _ = tmpc.compute_contact_forces_warm(
        env.mpc_cfg, env.mpc_canon, cs.qp_warm.replace(kinv=kinv), *args)
    errs.append(float((f_cold - f_warm).abs().max()
                      / max(float(f_cold.abs().max()), 1.0)))
    state, _, rew, done, _ = env.step_batch(state, act, gen)
    assert torch.isfinite(rew).all() and not done.any()
  assert len(switches) >= 2, switches
  assert max(errs) < 0.35, errs


def test_cold_stance_action_matches_jax_x64():
  """controllers.stance_action (cold QP, then tau = f^T J) on random
  controller states in float64 against JAX under x64."""
  rng = np.random.default_rng(4)
  E = 5
  q = (LO + (HI - LO) * rng.uniform(size=(E, 12))).astype(np.float64)
  feet = np.asarray(jax.vmap(jlk.foot_positions_base_frame)(
      q.astype(np.float32)), np.float64)
  cs = dict(
      leg_state=rng.integers(0, 4, (E, 4)).astype(np.int32),
      desired_leg_state=rng.integers(0, 4, (E, 4)).astype(np.int32),
      normalized_phase=rng.uniform(size=(E, 4)),
      swing_start_foot_pos=feet,
      vel_window=rng.normal(0, 0.3, (E, tctrl.VEL_WINDOW, 3)),
      vel_count=rng.integers(1, tctrl.VEL_WINDOW + 1, E).astype(np.int32),
      swing_joint_angles=q)
  cs["desired_leg_state"][0] = 1
  rpy = np.c_[rng.normal(0, 0.05, (E, 2)), rng.normal(0, 1, E)]
  rate = rng.normal(0, 0.3, (E, 3))
  speed = np.c_[rng.uniform(-0.05, 0.3, E), np.zeros((E, 2))]
  twist = rng.uniform(-0.4, 0.4, E)
  tcfg, jcfg = _cfgs()[0]
  with jax.enable_x64(True):
    jcs = jctrl.ControllerState(**{k: jnp.asarray(v) for k, v in cs.items()})
    j_tau, j_cs = jax.jit(jax.vmap(
        lambda c, *a: jctrl.stance_action(jcfg, c, *a)))(
            jcs, *map(jnp.asarray, (rpy, rate, feet, q, speed, twist)))
    j_tau, j_cs = np.asarray(j_tau), np.asarray(j_cs)
  tcs = tctrl.ControllerState(**{k: torch.tensor(v) for k, v in cs.items()},
                              qp_warm=None)
  t_tau, t_cs = tctrl.stance_action(
      tcfg, tcs, *map(torch.tensor, (rpy, rate, feet, q, speed, twist)))
  np.testing.assert_array_equal(t_cs.numpy(), j_cs)
  assert t_tau.dtype == torch.float64
  assert _rel(t_tau.numpy(), j_tau) < 1e-8
  assert np.abs(j_tau).max() > 1.0


def test_qp_torque_optimizer_matches_jax_x64():
  """compute_mass_matrix and compute_contact_force (the dense cold ADMM)
  on random feet, desired accelerations and contact sets, float64
  against JAX under x64."""
  rng = np.random.default_rng(5)
  E = 6
  q = (LO + (HI - LO) * rng.uniform(size=(E, 12))).astype(np.float32)
  feet = np.asarray(jax.vmap(jlk.foot_positions_base_frame)(q), np.float64)
  acc = rng.normal(0, 1.0, (E, 6))
  contacts = (rng.uniform(size=(E, 4)) < 0.7).astype(np.int32)
  contacts[0] = 1
  mass = float(P.MPC_BODY_MASS)
  inertia = np.asarray(P.MPC_BODY_INERTIA, np.float64).reshape(3, 3)
  with jax.enable_x64(True):
    j_M = np.asarray(jax.vmap(lambda f: jqp.compute_mass_matrix(
        mass, jnp.asarray(inertia), f))(jnp.asarray(feet)))
    j_f = np.asarray(jax.jit(jax.vmap(lambda f, a, c: jqp.compute_contact_force(
        mass, jnp.asarray(inertia), f, a, c)))(
            jnp.asarray(feet), jnp.asarray(acc), jnp.asarray(contacts)))
  t_M = tqp.compute_mass_matrix(mass, inertia, torch.tensor(feet))
  assert _rel(t_M.numpy(), j_M) < 1e-12
  t_f = tqp.compute_contact_force(mass, inertia, torch.tensor(feet),
                                  torch.tensor(acc), torch.tensor(contacts))
  assert t_f.shape == (E, 4, 3)
  # P = 2 (M^T Q M + 2e-4 I) is rank 6 plus the regularization: cond(P)
  # 2e6-3.4e6 here, so the two packages' roundings of P and q (1e-16)
  # part the solution by up to ~5e-8
  assert _rel(t_f.numpy(), j_f) < 1e-7
  # the standing env holds its weight, float32, within 10% (the solve
  # stops after 50 ADMM iterations: 102 N of 108 N here)
  f32 = tqp.compute_contact_force(
      mass, torch.tensor(inertia, dtype=torch.float32),
      torch.tensor(feet[:1], dtype=torch.float32), torch.zeros(1, 6),
      torch.ones(1, 4, dtype=torch.int32))
  total = float(-f32[0, :, 2].sum())
  assert abs(total - mass * 9.8) / (mass * 9.8) < 0.1, total


def test_robot_params_and_pose_utils_equal_jax():
  assert set(trp.ROBOTS) == set(jrp.ROBOTS)
  for name in jrp.ROBOTS:
    assert dataclasses.asdict(trp.ROBOTS[name]) == dataclasses.asdict(
        jrp.ROBOTS[name]), name
    np.testing.assert_array_equal(trp.ROBOTS[name].init_angles,
                                  jrp.ROBOTS[name].init_angles)
  for robot in ("a1", "laikago"):
    t, j = tpu.default_pose(robot), jpu.default_pose(robot)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    np.testing.assert_array_equal(tpu.laikago_pose_to_joint_angles(t),
                                  jpu.laikago_pose_to_joint_angles(j))
    ja = jpu.laikago_pose_to_joint_angles(j)
    assert dataclasses.asdict(tpu.laikago_joint_angles_to_pose(ja)) == \
        dataclasses.asdict(jpu.laikago_joint_angles_to_pose(ja))
  for name in ("LAIKAGO_DEFAULT_HIP_ANGLE", "LAIKAGO_DEFAULT_KNEE_ANGLE",
               "A1_DEFAULT_HIP_ANGLE", "A1_DEFAULT_KNEE_ANGLE",
               "LAIKAGO_UPPER_LEG_JOINT_OFFSET", "LAIKAGO_KNEE_JOINT_OFFSET"):
    assert getattr(tpu, name) == getattr(jpu, name), name
  assert tpu.A1Pose is tpu.LaikagoPose is tpu.QuadrupedPose
