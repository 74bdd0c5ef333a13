"""The port's deploy stack (vision4leg_torch.hardware) against the JAX
package's (vision4leg_tpu.hardware) on the CPU, with no robot and no
camera: the histories, the policy wrapper and the executor's commands
bit-equal to JAX's on the same seeded sensor streams (both are host
numpy), the state logger's npz round trip, and the native UDP link built
by g++ into vision4leg_torch/_build/ and driven over loopback on
ephemeral ports."""
import socket
import struct
import time

import numpy as np
import pytest

from vision4leg_tpu.hardware import executor as jexecutor
from vision4leg_tpu.hardware import policy_wrapper as jwrapper
from vision4leg_tpu.hardware import sensor_histories as jhist
from vision4leg_tpu.hardware.robot_interface import (IMUState as JIMU,
                                                     LowState as JLowState,
                                                     MotorStateArray as JMotor)
from vision4leg_torch.hardware import (executor, policy_wrapper,
                                       robot_interface)
from vision4leg_torch.hardware import sensor_histories as hist
from vision4leg_torch.hardware.policy_wrapper import PolicyWrapper
from vision4leg_torch.hardware.state_logger import StateLogger
from vision4leg_torch.robots import a1_params as P

OBS_DIM = 84 + 4 * 64 * 64


def _sensor_stream(n, seed=0):
  """n ticks of (rpy, drpy, motor angles, depth frame) from a seed."""
  rng = np.random.default_rng(seed)
  return [(rng.normal(0, 0.1, 3), rng.normal(0, 0.5, 3),
           np.asarray(P.INIT_MOTOR_ANGLES) + rng.normal(0, 0.2, 12),
           rng.uniform(0.0, 12.0, (64, 64))) for _ in range(n)]


def _normalizer(seed=1):
  rng = np.random.default_rng(seed)
  return (rng.normal(0, 0.3, 84).astype(np.float32),
          rng.uniform(0.05, 2.0, 84).astype(np.float32))


def _linear_policy(seed=2):
  """A deterministic stand-in policy: obs (D,) -> (6,), numpy."""
  w = np.random.default_rng(seed).normal(0, 0.02, (OBS_DIM, 6))
  return lambda obs: np.tanh(np.asarray(obs, np.float64) @ w) * 3.0


def test_histories_bit_equal_to_jax():
  rng = np.random.default_rng(3)
  d = rng.uniform(-1.0, 15.0, (64, 64))
  assert np.array_equal(hist.depth_process(d), jhist.depth_process(d))
  mean, var = rng.normal(size=12), rng.uniform(0.1, 2.0, 12)
  a = hist.NormedStateHistory(4, 3, mean, var)
  b = jhist.NormedStateHistory(4, 3, mean, var)
  va, vb = hist.VisualHistory((64, 64), 7), jhist.VisualHistory((64, 64), 7)
  for i in range(6):
    r = rng.normal(size=4) * 5
    assert np.array_equal(a.record_and_normalize(r),
                          b.record_and_normalize(r))
    f = rng.uniform(0.0, 12.0, (64, 64))
    idx = np.arange(4) * 2
    assert np.array_equal(va.record_and_normalize(f, idx),
                          vb.record_and_normalize(f, idx))


@pytest.mark.parametrize("frame_extract,interval", [(1, 1), (2, 1), (1, 2)])
def test_policy_wrapper_bit_equal_to_jax(frame_extract, interval):
  """20 ticks of a seeded sensor stream through both wrappers: the
  observations the policy sees and the commands it gives are the same
  bits."""
  mean, var = _normalizer()
  policy = _linear_policy()
  seen = {"port": [], "jax": []}

  def spy(name):
    def fn(obs):
      seen[name].append(obs)
      return policy(obs)
    return fn

  kw = dict(frame_extract=frame_extract, get_image_interval=interval,
            clip_num=(0.1, 0.6, 0.4) * 4)
  port = PolicyWrapper(spy("port"), mean, var, **kw)
  ref = jwrapper.PolicyWrapper(spy("jax"), mean, var, **kw)
  for tick in _sensor_stream(20):
    got, want = port.get_action(*tick), ref.get_action(*tick)
    assert got.shape == (12,)
    assert np.array_equal(got, want)
  assert all(o.dtype == np.float32 and o.shape == (OBS_DIM,)
             for o in seen["port"])
  assert all(np.array_equal(a, b) for a, b in zip(seen["port"], seen["jax"]))
  assert np.array_equal(port.last_action12, ref.last_action12)


def test_position_cmd_matches_jax():
  q = np.random.default_rng(4).normal(size=12)
  assert np.array_equal(executor.position_cmd(q), jexecutor.position_cmd(q))
  assert np.array_equal(executor.SIT_POSE, jexecutor.SIT_POSE)
  assert np.array_equal(executor.STAND_POSE, jexecutor.STAND_POSE)


def test_state_logger_round_trip(tmp_path):
  path = str(tmp_path / "log.npz")
  log = StateLogger(duration=0.1, control_freq=20, save_path=path)
  rng = np.random.default_rng(5)
  obs = [rng.normal(size=7) for _ in range(15)]
  for i, o in enumerate(obs):
    log.record(o, np.full(3, float(i)))
  log.save()
  data = np.load(path)
  n = int(0.1 * 20) + 10
  assert int(data["idx"]) == n == 12          # rows past n are dropped
  np.testing.assert_array_equal(data["observation"], np.stack(obs[:n]))
  np.testing.assert_array_equal(data["action"][:, 0], np.arange(n))
  assert np.all(np.diff(data["time"]) >= 0)


class _StreamRI:
  """A robot that reports a seeded sensor stream, in either framework's
  LowState, and records the commands it is sent."""

  def __init__(self, jax_types: bool):
    self.ticks = _sensor_stream(40, seed=6)
    self.i = 0
    self.sent = []
    self.types = ((JLowState, JMotor, JIMU) if jax_types else
                  (robot_interface.LowState, robot_interface.MotorStateArray,
                   robot_interface.IMUState))

  def ReceiveObservation(self):
    rpy, drpy, q, _ = self.ticks[self.i % len(self.ticks)]
    self.i += 1
    low, motor, imu = self.types
    return low(motorState=motor(q=q, dq=np.zeros(12), tauEst=np.zeros(12)),
               imu=imu(quaternion=np.array([1.0, 0, 0, 0]), gyroscope=drpy,
                       accelerometer=np.array([0, 0, 9.8]), rpy=rpy),
               footForce=np.zeros(4), tick=float(self.i))

  def SendCommand(self, cmd):
    self.sent.append(np.array(cmd))


class _Camera:
  def __init__(self):
    self.frames = [t[3] for t in _sensor_stream(40, seed=7)]
    self.i = 0

  def get_depth(self):
    self.i += 1
    return self.frames[(self.i - 1) % len(self.frames)]


def _executor(mod, types, wrapper_mod):
  mean, var = _normalizer()
  wrapper = wrapper_mod.PolicyWrapper(_linear_policy(), mean, var)
  ri = _StreamRI(types)
  rc = mod.RobotController(ri, control_freq=1000.0)
  return mod.Executor(wrapper, rc, camera=_Camera(), control_freq=1000.0), ri


def test_executor_methods_give_jax_commands():
  """The executor's stand -> warmup -> policy -> sit sequence, each
  method driven directly (no threads, 1 kHz periods): the commands the
  robot receives are JAX's."""
  port, port_ri = _executor(executor, False, policy_wrapper)
  ref, ref_ri = _executor(jexecutor, True, jwrapper)

  def jax_control_step():   # the body of the JAX main_execution loop
    obs = ref._observe()
    ref.rc.set_action(jexecutor.position_cmd(ref.policy.get_action(*obs)))

  for ex, exchange, control_step in (
      (port, port.rc.step, port.control_step),
      (ref, lambda: _jax_rc_step(ref.rc), jax_control_step)):
    exchange()
    ex.stand_up(duration=0.03)
    exchange()
    ex.warmup_observations(steps=3)
    for _ in range(5):
      control_step()
      exchange()
    ex.sit_down(duration=0.03)
    exchange()
  assert len(port_ri.sent) == len(ref_ri.sent) == 8
  for a, b in zip(port_ri.sent, ref_ri.sent):
    assert np.array_equal(a, b)
  assert np.array_equal(port_ri.sent[-1][0::5],
                        executor.SIT_POSE.astype(np.float32))


def _jax_rc_step(rc):
  """One exchange of the JAX RobotController's loop body."""
  state = rc.ri.ReceiveObservation()
  with rc._lock:
    rc._state = state
    cmd = rc._cmd
  rc.ri.SendCommand(cmd)


def test_executor_control_step_waits_for_a_state():
  mean, var = _normalizer()
  calls = []
  wrapper = PolicyWrapper(lambda o: calls.append(o) or np.zeros(6), mean,
                          var)
  rc = executor.RobotController(_StreamRI(False), control_freq=1000.0)
  ex = executor.Executor(wrapper, rc, camera=None, control_freq=1000.0)
  assert not ex.control_step() and not calls
  rc.step()
  assert ex.control_step() and len(calls) == 1


def test_control_thread_runs_and_stops():
  ri = _StreamRI(False)
  rc = executor.RobotController(ri, control_freq=500.0)
  rc.start_thread()
  try:
    deadline = time.time() + 5.0
    while len(ri.sent) < 5 and time.time() < deadline:
      time.sleep(0.005)
  finally:
    rc.stop_thread()
  assert len(ri.sent) >= 5
  assert not rc._thread.is_alive()
  assert rc.get_state() is not None


# --- the native UDP link ------------------------------------------------

_LOW_STATE = struct.Struct("<BHHIB" + "13fb" + "B7fb2I" * 20 + "4h4hI40sII")


def test_robot_interface_loopback_on_ephemeral_ports():
  """The port's ctypes binding of native/robot_interface.cpp, built by
  g++ into vision4leg_torch/_build/: a command reaches a local socket
  with the wire layout of the A1 LowCmd, and a LowState sent back is
  decoded into the 54-float layout.  Both sides bind ephemeral ports."""
  path = robot_interface.build()
  assert "/vision4leg_torch/_build/robot_interface_" in path
  robot = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
  robot.bind(("127.0.0.1", 0))
  robot.settimeout(5.0)
  ri = robot_interface.RobotInterface(
      robot_ip="127.0.0.1", robot_port=robot.getsockname()[1], local_port=0)
  try:
    cmd = executor.position_cmd(np.asarray(P.INIT_MOTOR_ANGLES))
    cmd[0] = 5.0                                # beyond the hip limit
    ri.SendCommand(cmd)
    data, ri_addr = robot.recvfrom(4096)
    assert data[0] == 0xFF                      # low-level flag
    assert data[10] == 0x0A                     # first MotorCmd's mode
    q0, _, _, kp0, kd0 = struct.unpack_from("<5f", data, 11)
    assert q0 == np.float32(0.802)              # clamped to the hip limit
    assert (kp0, kd0) == (np.float32(executor.KP), np.float32(executor.KD))
    q1 = struct.unpack_from("<f", data, 11 + 33)[0]
    assert q1 == np.float32(P.INIT_MOTOR_ANGLES[1])

    rng = np.random.default_rng(8)
    q, dq, tau = (rng.normal(size=12).astype(np.float32) for _ in range(3))
    quat, gyro, acc, rpy = (rng.normal(size=n).astype(np.float32)
                            for n in (4, 3, 3, 3))
    motors = []
    for m in range(20):
      motors += ([10, q[m], dq[m], 0.0, tau[m], 0.0, 0.0, 0.0, 0, 0, 0]
                 if m < 12 else [0] + [0.0] * 7 + [0, 0, 0])
    feet = [11, -12, 13, 140]
    packet = _LOW_STATE.pack(0xFF, 0, 0, 0, 0, *quat, *gyro, *acc, *rpy, 30,
                             *motors, *feet, 0, 0, 0, 0, 777, b"\0" * 40, 0,
                             0)
    robot.sendto(packet, ri_addr)
    deadline = time.time() + 5.0
    state = ri.ReceiveObservation()
    while state.tick != 777.0 and time.time() < deadline:
      time.sleep(0.005)
      state = ri.ReceiveObservation()
    assert state.tick == 777.0
    np.testing.assert_array_equal(state.motorState.q, q)
    np.testing.assert_array_equal(state.motorState.dq, dq)
    np.testing.assert_array_equal(state.motorState.tauEst, tau)
    np.testing.assert_array_equal(state.imu.quaternion, quat)
    np.testing.assert_array_equal(state.imu.gyroscope, gyro)
    np.testing.assert_array_equal(state.imu.accelerometer, acc)
    np.testing.assert_array_equal(state.imu.rpy, rpy)
    np.testing.assert_array_equal(state.footForce, feet)
    with pytest.raises(ValueError, match="60 floats"):
      ri.SendCommand(np.zeros(12))
  finally:
    ri.close()
    robot.close()
