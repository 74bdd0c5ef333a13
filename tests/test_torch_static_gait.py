"""The port's static gait (vision4leg_torch/mpc/static_gait.py) against the
JAX package's, on the CPU.

The port's controller walks the A1 on the port's per-env engine (the JAX
test's setting, tests/test_mpc.py:175-235: 2 ms substeps, 400 to settle,
then a tick of two substeps at 250 Hz), recording the toe, base and
quaternion inputs of every tick.  Held: the run stays up and starts a foot
step; the JAX controller, fed the same recorded inputs from its own fresh
state, commands the same motor angles at 1e-6 (float32 IK of the same
float64 targets) and walks its state machine through the same events.
"""
import numpy as np
import pytest
import torch

from vision4leg_tpu.mpc import static_gait as jsg
from vision4leg_torch.envs import terrain as terr
from vision4leg_torch.mpc import leg_kinematics as lk
from vision4leg_torch.mpc import static_gait as tsg
from vision4leg_torch.physics import contact, engine
from vision4leg_torch.robots import a1, a1_model
from vision4leg_torch.robots import a1_params as P

TICKS = 500


@pytest.fixture(autouse=True)
def _one_torch_thread():
  """Small eager ops: with the suite's workers sharing the cores, torch's
  intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _walk():
  """The port's controller on the port's engine: (inputs per tick,
  commands per tick, base z every 50 ticks, foot steps started)."""
  model = a1_model.build(dt=0.002, device="cpu")
  h, n = terr.flat_height_fn()
  cfn = contact.make_terrain_contact_fn(h, n)
  dyn = a1.default_dynamics(model)
  model_d = a1.apply_dynamics(model, dyn)
  init_q = torch.tensor(P.INIT_MOTOR_ANGLES, dtype=torch.float32)
  phys = engine.zero_state(model).replace(
      pos=torch.tensor([0.0, 0.0, 0.27]), joint_q=init_q.clone())
  rs = a1.init_robot_state(phys)
  for _ in range(400):
    rs, _ = a1.substep(model_d, rs, init_q, dyn, cfn)
  toe_ref = lk.foot_positions_base_frame(rs.phys.joint_q).numpy()
  ctl = tsg.StaticGaitController(toe_ref, step_dist=0.08, dt=1.0 / 250)
  inputs, cmds, zs, started = [], [], [], 0
  for t in range(TICKS):
    toes, _, _ = engine.contact_points_world(
        model, rs.phys, engine.fwd_kinematics(model, rs.phys))
    x = (rs.phys.pos.numpy(), rs.phys.quat.numpy(), toes[:4].numpy())
    inputs.append(x)
    was = ctl.stepper.move_swing_foot
    cmd = ctl.act(*x)
    started += int(ctl.stepper.move_swing_foot and not was)
    cmds.append(cmd)
    c = torch.tensor(cmd)
    for _ in range(2):
      rs, _ = a1.substep(model_d, rs, c, dyn, cfn)
    if t % 50 == 0:
      zs.append(float(rs.phys.pos[2]))
  return toe_ref, inputs, np.stack(cmds), np.array(zs), started


def test_static_gait_matches_jax_and_stays_up():
  toe_ref, inputs, cmds, zs, started = _walk()
  assert np.all(zs > 0.15) and np.all(zs < 0.40), zs
  assert started >= 1, "no foot step was ever triggered"
  assert cmds.dtype == np.float32 and cmds.shape == (TICKS, 12)
  jctl = jsg.StaticGaitController(toe_ref, step_dist=0.08, dt=1.0 / 250)
  jstarted = 0
  for t, x in enumerate(inputs):
    was = jctl.stepper.move_swing_foot
    want = jctl.act(*x)
    jstarted += int(jctl.stepper.move_swing_foot and not was)
    np.testing.assert_allclose(cmds[t], want, atol=1e-6, err_msg=str(t))
  assert jstarted == started


def test_foot_stepper_state_matches_jax():
  """FootStepper.update alone on random inputs: the same targets and
  state, including the far/close switch and the yaw balance."""
  rng = np.random.default_rng(0)
  ref = np.array(lk.foot_positions_base_frame(torch.tensor(
      P.INIT_MOTOR_ANGLES, dtype=torch.float32)).numpy(), np.float64)
  ts, js = tsg.FootStepper(ref), jsg.FootStepper(ref)
  for i in range(120):
    base = np.r_[rng.normal(0, 0.02, 2), 0.26]
    quat = np.r_[1.0, rng.normal(0, 0.02, 3)]
    quat /= np.linalg.norm(quat)
    toes = ref + base + rng.normal(0, 0.01, (4, 3))
    if i % 40 == 10:
      ts.next_foot(), js.next_foot()
      ts.swing_foot(), js.swing_foot()
    np.testing.assert_array_equal(ts.update(base, quat, toes, 0.004),
                                  js.update(base, quat, toes, 0.004))
    assert (ts.is_far, ts.swing_foot_index, ts.state_time) == (
        js.is_far, js.swing_foot_index, js.state_time)
    np.testing.assert_array_equal(ts.toe_pos_local_ref, js.toe_pos_local_ref)
