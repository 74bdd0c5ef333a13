"""Parity of the torch port's physics (engine, contacts, A1 robot layer,
env-last window) with the JAX package on the CPU.

Inputs are drawn with numpy from fixed seeds and handed to both sides.
Tolerances: single-step quantities (kinematics, mass matrix, bias, contact
forces) agree to float32 rounding of O(1..100) values, so 1e-5 absolute
plus 1e-5 relative.  Multi-substep trajectories through stiff penalty
contacts use the JAX package's own window tolerances
(tests/test_physics_kernel.py): positions and joint angles 1e-5,
velocities and history 6e-3, post-window penetration 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import terrain as jterr
from vision4leg_tpu.ops import physics_envlast as jpe
from vision4leg_tpu.ops.physics_kernel import (_dyn_to_envlast,
                                               _rs_to_envlast,
                                               robot_window_pallas)
from vision4leg_tpu.physics import contact as jcontact
from vision4leg_tpu.physics import engine as jengine
from vision4leg_tpu.robots import a1 as ja1
from vision4leg_tpu.robots import a1_model as ja1_model
from vision4leg_torch import convert
from vision4leg_torch.ops import physics_kernel as tpk
from vision4leg_torch.physics import contact as tcontact
from vision4leg_torch.physics import engine as tengine
from vision4leg_torch.robots import a1 as ta1
from vision4leg_torch.robots import a1_model as ta1_model

TIGHT = dict(atol=1e-5, rtol=1e-5)
INIT_Q = np.array([0, 0.9, -1.8] * 4, np.float32)


@pytest.fixture(scope="module")
def models():
  return ja1_model.build(dt=0.0025), ta1_model.build(dt=0.0025)


def _random_states(n, seed, vel_scale=1.0):
  """numpy PhysState fields for n envs (cases of tests/test_physics.py)."""
  rng = np.random.default_rng(seed)
  quat = rng.normal(size=(n, 4)).astype(np.float32)
  quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
  lo = np.array([-0.8, -1.0, -2.7] * 4, np.float32)
  hi = np.array([0.8, 4.2, -0.9] * 4, np.float32)
  return dict(
      pos=rng.normal(size=(n, 3)).astype(np.float32), quat=quat,
      joint_q=(lo + (hi - lo) * rng.uniform(size=(n, 12))).astype(np.float32),
      ang=(vel_scale * rng.normal(size=(n, 3))).astype(np.float32),
      lin=(vel_scale * rng.normal(size=(n, 3))).astype(np.float32),
      joint_qd=(vel_scale * rng.normal(size=(n, 12))).astype(np.float32))


def _jax_state(d):
  return jengine.PhysState(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_state(d):
  return tengine.PhysState(**{k: torch.tensor(v) for k, v in d.items()})


def _np(x):
  return np.asarray(x)


@pytest.fixture(scope="module")
def engine_pieces(models):
  jm, _ = models
  d = _random_states(6, seed=0)

  @jax.jit
  def pieces(s):
    def one(s):
      kin = jengine.fwd_kinematics(jm, s)
      pos, vel, _ = jengine.contact_points_world(jm, s, kin)
      return (kin.R, kin.p, kin.com_w, jengine.mass_matrix(jm, kin),
              jengine.bias_forces(jm, s, kin), pos, vel)
    return jax.vmap(one)(s)

  return d, [_np(x) for x in pieces(_jax_state(d))]


@pytest.mark.parametrize("piece", ["R", "p", "com_w", "mass_matrix",
                                   "bias_forces", "cp_pos", "cp_vel"])
def test_engine_pieces_match_jax(models, engine_pieces, piece):
  _, tm = models
  d, ref = engine_pieces
  s = _torch_state(d)
  kin = tengine.fwd_kinematics(tm, s)
  pos, vel, _ = tengine.contact_points_world(tm, s, kin)
  got = dict(R=kin.R, p=kin.p, com_w=kin.com_w,
             mass_matrix=tengine.mass_matrix(tm, kin),
             bias_forces=tengine.bias_forces(tm, s, kin), cp_pos=pos,
             cp_vel=vel)
  names = ["R", "p", "com_w", "mass_matrix", "bias_forces", "cp_pos",
           "cp_vel"]
  np.testing.assert_allclose(got[piece].numpy(), ref[names.index(piece)],
                             **TIGHT)


def _obstacles():
  """One box near the front toes and one sphere clipping a rear toe (the
  _setup of tests/test_physics_kernel.py), padded to 8 boxes / 2 spheres."""
  boxes = np.zeros((8, 8), np.float32)
  boxes[0] = [0.15, 0.0, 0.05, 0.1, 0.1, 0.05, 0.3, 1.0]
  spheres = np.zeros((2, 5), np.float32)
  spheres[0] = [-0.18, 0.13, 0.0, 0.12, 1.0]
  return boxes, spheres


def _standing(n=1):
  d = dict(pos=np.tile([[0.0, 0.0, 0.27]], (n, 1)).astype(np.float32),
           quat=np.tile([[1.0, 0, 0, 0]], (n, 1)).astype(np.float32),
           joint_q=np.tile(INIT_Q, (n, 1)),
           ang=np.zeros((n, 3), np.float32), lin=np.zeros((n, 3), np.float32),
           joint_qd=np.zeros((n, 12), np.float32))
  return d


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_engine_steps_match_jax(models, solver):
  """20 substeps of the per-env engine under PD hold against flat ground,
  a box and a sphere."""
  jm, tm = models
  boxes, spheres = _obstacles()
  d = {k: v[0] for k, v in _standing().items()}
  jcfn = jcontact.make_terrain_contact_fn(
      *jterr.flat_height_fn(None), boxes=jnp.asarray(boxes),
      spheres=jnp.asarray(spheres), friction=0.9, box_friction=0.7)

  @jax.jit
  def jrun(s):
    def body(s, _):
      tau = -80.0 * (s.joint_q - INIT_Q) - 0.4 * s.joint_qd
      s, pen, _ = jengine.step(jm, s, tau, jcfn, solver=solver)
      return s, pen
    return jax.lax.scan(body, s, None, length=20)

  js, jpen = jrun(_jax_state(d))
  tflat = lambda xy: torch.zeros(xy.shape[:-1])
  tnorm = lambda xy: torch.tensor([0.0, 0.0, 1.0]).expand(xy.shape[:-1] + (3,))
  tcfn = tcontact.make_terrain_contact_fn(
      tflat, tnorm, boxes=torch.tensor(boxes), spheres=torch.tensor(spheres),
      friction=0.9, box_friction=0.7)
  s = _torch_state(d)
  pens = []
  for _ in range(20):
    tau = -80.0 * (s.joint_q - torch.tensor(INIT_Q)) - 0.4 * s.joint_qd
    s, pen, _ = tengine.step(tm, s, tau, tcfn, solver=solver)
    pens.append(pen)
  np.testing.assert_allclose(s.pos.numpy(), _np(js.pos), atol=1e-5)
  np.testing.assert_allclose(s.joint_q.numpy(), _np(js.joint_q), atol=1e-5)
  np.testing.assert_allclose(s.quat.numpy(), _np(js.quat), atol=1e-5)
  np.testing.assert_allclose(s.joint_qd.numpy(), _np(js.joint_qd), atol=6e-3)
  np.testing.assert_allclose(torch.stack(pens).numpy(), _np(jpen), atol=1e-4)


def test_engine_free_space_matches_jax(models):
  """100 contact-free substeps from random moving states with zero torque
  (the free-fall and free-space cases of tests/test_physics.py): without
  contacts the dynamics are smooth, so the tight tolerance holds."""
  jm, tm = models
  d = _random_states(3, seed=4, vel_scale=0.5)
  jnone = lambda p, v, r: (jnp.zeros_like(p), -jnp.ones(p.shape[:-1] + (2,)))
  tnone = lambda p, v, r: (torch.zeros_like(p),
                           -torch.ones(p.shape[:-1] + (2,)))

  @jax.jit
  def jrun(s):
    def body(s, _):
      s, _, _ = jengine.step(jm, s, jnp.zeros(12), jnone)
      return s, None
    return jax.lax.scan(body, s, None, length=100)[0]

  js = jax.vmap(jrun)(_jax_state(d))
  s = _torch_state(d)
  for _ in range(100):
    s, _, _ = tengine.step(tm, s, torch.zeros(3, 12), tnone)
  for name in ("pos", "quat", "joint_q", "ang", "lin", "joint_qd"):
    np.testing.assert_allclose(getattr(s, name).numpy(),
                               _np(getattr(js, name)), **TIGHT,
                               err_msg=name)


def test_robot_substep_and_delayed_reads_match_jax(models):
  """a1.substep (PD + engine + history push) then the latency-interpolated
  sensor reads, with randomized dynamics."""
  jm, tm = models
  rng = np.random.default_rng(3)
  dyn_np = dict(
      kp=np.full(12, 61.0, np.float32), kd=np.full(12, 0.55, np.float32),
      strength_ratios=rng.uniform(0.8, 1.2, 12).astype(np.float32),
      motor_friction=np.float32(0.03), joint_friction=np.float32(0.02),
      control_latency=np.float32(0.0137), lateral_friction=np.float32(0.9),
      mass_scale=np.r_[1.1, np.full(12, 0.9)].astype(np.float32),
      inertia_scale=np.r_[0.7, np.full(12, 1.3)].astype(np.float32))
  cmd = (INIT_Q + rng.uniform(-0.2, 0.2, 12)).astype(np.float32)
  phys = {k: v[0] for k, v in _standing().items()}
  jdyn = ja1.DynamicsParams(**{k: jnp.asarray(v) for k, v in dyn_np.items()})
  jcfn = jcontact.make_terrain_contact_fn(*jterr.flat_height_fn(None),
                                          friction=0.9)

  @jax.jit
  def jrun(rs):
    md = ja1.apply_dynamics(jm, jdyn)
    def body(rs, _):
      return ja1.substep(md, rs, jnp.asarray(cmd), jdyn, jcfn)[0], None
    rs = jax.lax.scan(body, rs, None, length=12)[0]
    rpy, drpy = ja1.delayed_rpy_and_rate(rs, jdyn, jm.dt)
    return rs, ja1.delayed_motor_angles(rs, jdyn, jm.dt), rpy, drpy

  jrs, jmotor, jrpy, jdrpy = jrun(ja1.init_robot_state(jm, _jax_state(phys)))
  tdyn = ta1.DynamicsParams(**{k: torch.tensor(v) for k, v in dyn_np.items()})
  md = ta1.apply_dynamics(tm, tdyn)
  tcfn = tcontact.make_terrain_contact_fn(
      lambda xy: torch.zeros(xy.shape[:-1]),
      lambda xy: torch.tensor([0.0, 0.0, 1.0]).expand(xy.shape[:-1] + (3,)),
      friction=0.9)
  rs = ta1.init_robot_state(_torch_state(phys))
  for _ in range(12):
    rs, _ = ta1.substep(md, rs, torch.tensor(cmd), tdyn, tcfn)
  rpy, drpy = ta1.delayed_rpy_and_rate(rs, tdyn, tm.dt)
  np.testing.assert_allclose(rs.phys.pos.numpy(), _np(jrs.phys.pos),
                             atol=1e-5)
  np.testing.assert_allclose(rs.obs_hist.numpy(), _np(jrs.obs_hist),
                             atol=6e-3)
  np.testing.assert_allclose(
      ta1.delayed_motor_angles(rs, tdyn, tm.dt).numpy(), _np(jmotor),
      atol=1e-5)
  np.testing.assert_allclose(rpy.numpy(), _np(jrpy), atol=1e-5)
  np.testing.assert_allclose(drpy.numpy(), _np(jdrpy), atol=6e-3)
  assert int(rs.step_counter) == int(jrs.step_counter) == 12


@pytest.mark.parametrize("friction", [0.0, 0.8])
def test_slope_contact_matches_jax(friction):
  """Contact on a 20 degree ramp (the probe of tests/test_slope_contact.py):
  JAX's heightfield ramp against the same ramp given analytically."""
  angle = np.deg2rad(20.0)
  n, cell = 96, 0.2
  xs = (jnp.arange(n) - n / 2) * cell
  grid = jnp.tile((jnp.tan(angle) * xs)[:, None], (1, n))
  ts = jterr._empty(num_boxes=0, hf_n=n).replace(
      height=grid, hf_cell=jnp.asarray(cell),
      hf_origin=jnp.asarray([-n / 2 * cell] * 2), hf_zoff=jnp.asarray(0.0))
  jcfn = jcontact.make_terrain_contact_fn(*jterr.heightfield_fns(ts),
                                          friction=friction)
  rng = np.random.default_rng(7)
  x = rng.uniform(0.5, 2.0, 8).astype(np.float32)
  pos = np.stack([x, rng.uniform(-1, 1, 8),
                  np.tan(angle) * x + rng.uniform(-0.01, 0.03, 8)],
                 -1).astype(np.float32)
  vel = rng.normal(scale=0.3, size=(8, 3)).astype(np.float32)
  rad = np.full(8, 0.02, np.float32)
  jf, jphi = jax.jit(jcfn)(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(rad))

  t_ang = torch.tensor(float(np.tan(angle)))
  normal = torch.stack([-t_ang, torch.tensor(0.0), torch.tensor(1.0)])
  normal = normal / torch.linalg.norm(normal)
  tcfn = tcontact.make_terrain_contact_fn(
      lambda xy: t_ang * xy[..., 0],
      lambda xy: normal.expand(xy.shape[:-1] + (3,)), friction=friction)
  tf, tphi = tcfn(torch.tensor(pos), torch.tensor(vel), torch.tensor(rad))
  assert (jphi[:, 0] > 0).any() and (jphi[:, 0] < 0).any()
  # the heightfield's finite-difference normal and bilinear height carry
  # f32 grid rounding; forces are O(100) N
  np.testing.assert_allclose(tphi.numpy(), _np(jphi), atol=2e-5)
  np.testing.assert_allclose(tf.numpy(), _np(jf), atol=2e-2, rtol=1e-4)


# ---------------------------------------------------------------------------
# the physics window (plain version of the CUDA kernel)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def window_case(models):
  """E=4 envs with a box and a sphere in contact, distinct per env."""
  jm, _ = models
  E = 4
  rng = np.random.default_rng(11)
  boxes1, spheres1 = _obstacles()
  boxes = np.tile(boxes1, (E, 1, 1))
  boxes[:, 0, 6] += rng.uniform(-0.3, 0.3, E)
  spheres = np.tile(spheres1, (E, 1, 1))
  phys = _standing(E)
  phys["joint_q"] += rng.uniform(-0.05, 0.05, (E, 12)).astype(np.float32)
  jrs = jax.vmap(lambda p: ja1.init_robot_state(jm, p))(_jax_state(phys))
  jrs = jrs.replace(step_counter=jnp.arange(E, dtype=jnp.int32))
  dyn = dict(
      kp=np.full((E, 12), 70.0, np.float32),
      kd=np.full((E, 12), 0.5, np.float32),
      strength_ratios=rng.uniform(0.8, 1.2, (E, 12)).astype(np.float32),
      motor_friction=rng.uniform(0, 0.05, E).astype(np.float32),
      joint_friction=rng.uniform(0, 0.05, E).astype(np.float32),
      control_latency=np.zeros(E, np.float32),
      lateral_friction=np.ones(E, np.float32),
      mass_scale=rng.uniform(0.8, 1.2, (E, 13)).astype(np.float32),
      inertia_scale=rng.uniform(0.5, 1.5, (E, 13)).astype(np.float32))
  cmd = (INIT_Q + rng.uniform(-0.3, 0.3, (E, 12))).astype(np.float32)
  fg = rng.uniform(0.5, 1.25, E).astype(np.float32)
  fb = rng.uniform(0.5, 1.25, E).astype(np.float32)
  return E, jrs, dyn, cmd, boxes, spheres, fg, fb


def _torch_window_inputs(window_case):
  E, jrs, dyn, cmd, boxes, spheres, fg, fb = window_case
  rs = convert.robot_state(jax.tree.map(np.asarray, jrs))
  tdyn = ta1.DynamicsParams(**{k: torch.tensor(v) for k, v in dyn.items()})
  return (rs, torch.tensor(cmd), tdyn, torch.tensor(boxes),
          torch.tensor(spheres), torch.tensor(fg), torch.tensor(fb))


@pytest.mark.parametrize("interpolate", [False, True])
def test_window_matches_jax_envlast(models, window_case, interpolate):
  """The plain window against vision4leg_tpu.ops.physics_envlast.window
  (the math of the TPU kernel) on the same env-last inputs."""
  jm, tm = models
  E, jrs, dyn, cmd, boxes, spheres, fg, fb = window_case
  jdyn = ja1.DynamicsParams(**{k: jnp.asarray(v) for k, v in dyn.items()})
  t = lambda x: jnp.moveaxis(jnp.asarray(x), 0, -1)
  jnew, jpen = jax.jit(
      lambda r, c, d, b, sp, f1, f2: jpe.window(
          jm, r, c, d, b, sp, f1, f2, 16, interpolate))(
              _rs_to_envlast(jrs), t(cmd), _dyn_to_envlast(jdyn), t(boxes),
              t(spheres), jnp.asarray(fg), jnp.asarray(fb))
  rs, c, d, b, sp, f1, f2 = _torch_window_inputs(window_case)
  new, pen = tpk.window_plain(tm, rs, c, d, b, sp, f1, f2, 16, interpolate)
  tl = lambda x: x.movedim(0, -1).numpy()
  for name, got, tol in (("pos", new.phys.pos, 1e-5),
                         ("quat", new.phys.quat, 1e-5),
                         ("q", new.phys.joint_q, 1e-5),
                         ("qd", new.phys.joint_qd, 6e-3),
                         ("lin", new.phys.lin, 6e-3),
                         ("hist", new.obs_hist, 6e-3),
                         ("obs_tau", new.observed_torques, 6e-3)):
    np.testing.assert_allclose(tl(got), _np(jnew[name]), atol=tol,
                               err_msg=name)
  np.testing.assert_allclose(tl(pen), _np(jpen), atol=1e-4)
  np.testing.assert_array_equal(new.step_counter.numpy(),
                                _np(jnew["counter"]))


def test_robot_window_cpu_matches_jax_entry_point(models, window_case):
  """robot_window on CPU tensors against robot_window_pallas's CPU path
  (the env-first vmapped engine) — the public entry points."""
  jm, tm = models
  E, jrs, dyn, cmd, boxes, spheres, fg, fb = window_case
  jdyn = ja1.DynamicsParams(**{k: jnp.asarray(v) for k, v in dyn.items()})
  jnew, jpen = robot_window_pallas(jm, jrs, jnp.asarray(cmd), jdyn,
                                   jnp.asarray(boxes), jnp.asarray(spheres),
                                   jnp.asarray(fg), jnp.asarray(fb), 16)
  before = tpk.robot_window.launches
  new, pen = tpk.robot_window(tm, *_torch_window_inputs(window_case), 16)
  assert tpk.robot_window.launches == before   # plain path: no launch
  np.testing.assert_allclose(new.phys.pos.numpy(), _np(jnew.phys.pos),
                             atol=1e-5)
  # the JAX entry point's CPU path is the env-first engine, whose sums run
  # in another order than the env-last math; with these +-0.3 rad commands
  # its joint angles drift from it by slightly more than 1e-5 over the
  # window (a 1e-5 check fails), so 3e-5 here — the env-last comparison
  # above holds 1e-5
  np.testing.assert_allclose(new.phys.joint_q.numpy(),
                             _np(jnew.phys.joint_q), atol=3e-5)
  np.testing.assert_allclose(new.phys.joint_qd.numpy(),
                             _np(jnew.phys.joint_qd), atol=6e-3)
  np.testing.assert_allclose(new.obs_hist.numpy(), _np(jnew.obs_hist),
                             atol=6e-3)
  np.testing.assert_allclose(pen.numpy(), _np(jpen), atol=1e-4)
  np.testing.assert_allclose(new.last_robot_action.numpy(), cmd)


def _hybrid_inputs(E, seed):
  """Feedforward torques and a stance mask that mixes stance and swing
  legs within every env (whole legs, as the MPC env masks them)."""
  rng = np.random.default_rng(seed)
  tau_ff = rng.uniform(-8.0, 8.0, (E, 12)).astype(np.float32)
  legs = rng.uniform(size=(E, 4)) < 0.5
  legs[:, 0], legs[:, 1] = True, False
  return tau_ff, np.repeat(legs, 3, axis=1).astype(np.float32)


@pytest.mark.parametrize("n_sub", [5, 16])
def test_hybrid_window_matches_jax_envlast(models, window_case, n_sub):
  """The plain window in hybrid mode (torque = (1-mask) PD + mask tau_ff,
  the MPC env's window) against vision4leg_tpu.ops.physics_envlast.window
  with tau_ff/tau_mask, at the window tolerances; obs_tau is the blended
  torque."""
  jm, tm = models
  E, jrs, dyn, cmd, boxes, spheres, fg, fb = window_case
  tau_ff, mask = _hybrid_inputs(E, n_sub)
  jdyn = ja1.DynamicsParams(**{k: jnp.asarray(v) for k, v in dyn.items()})
  t = lambda x: jnp.moveaxis(jnp.asarray(x), 0, -1)
  jnew, jpen = jax.jit(
      lambda r, c, d, b, sp, f1, f2, tf, tm_: jpe.window(
          jm, r, c, d, b, sp, f1, f2, n_sub, False, tf, tm_))(
              _rs_to_envlast(jrs), t(cmd), _dyn_to_envlast(jdyn), t(boxes),
              t(spheres), jnp.asarray(fg), jnp.asarray(fb), t(tau_ff),
              t(mask))
  rs, c, d, b, sp, f1, f2 = _torch_window_inputs(window_case)
  new, pen = tpk.window_plain(tm, rs, c, d, b, sp, f1, f2, n_sub, False,
                              torch.tensor(tau_ff), torch.tensor(mask))
  tl = lambda x: x.movedim(0, -1).numpy()
  for name, got, tol in (("pos", new.phys.pos, 1e-5),
                         ("quat", new.phys.quat, 1e-5),
                         ("q", new.phys.joint_q, 1e-5),
                         ("qd", new.phys.joint_qd, 6e-3),
                         ("lin", new.phys.lin, 6e-3),
                         ("hist", new.obs_hist, 6e-3),
                         ("obs_tau", new.observed_torques, 6e-3)):
    np.testing.assert_allclose(tl(got), _np(jnew[name]), atol=tol,
                               err_msg=name)
  np.testing.assert_allclose(tl(pen), _np(jpen), atol=1e-4)
  # stance joints report the feedforward torque itself
  ff = mask > 0.5
  np.testing.assert_array_equal(new.observed_torques.numpy()[ff], tau_ff[ff])
  # and the blend changes the outcome: the PD-only window ends elsewhere
  pd_only, _ = tpk.window_plain(tm, rs, c, d, b, sp, f1, f2, n_sub)
  assert float((pd_only.phys.joint_q - new.phys.joint_q).abs().max()) > 1e-3


def test_robot_window_rejects_hybrid_mode(models, window_case):
  """Hybrid mode takes tau_ff and tau_mask together: one without the
  other is refused, on the wrapper and on the plain version."""
  _, tm = models
  args = _torch_window_inputs(window_case)
  with pytest.raises(ValueError, match="hybrid"):
    tpk.robot_window(tm, *args, 16, tau_ff=torch.zeros(4, 12))
  with pytest.raises(ValueError, match="hybrid"):
    tpk.window_plain(tm, *args, 16, tau_mask=torch.zeros(4, 12))


def test_kernel_buffers_follow_the_model(models):
  """The kernel's packed model buffer and state rows have the sizes its
  source is compiled for."""
  _, tm = models
  assert tpk.model_buffer(tm).numel() == tpk.MODEL_SIZE
  assert tpk.NUM_STATE_ROWS == 49 + 20 * 31
  other = tm.replace(parent=(-1,) + tm.parent[1:-1] + (0,))
  with pytest.raises(ValueError, match="A1 tree"):
    tpk.model_buffer(other)
