"""Real-robot control-loop executor (mirror of
vision4leg_tpu.hardware.executor; reference
a1_hardware/control_loop_execution/main_executor.py): a UDP control
thread (`RobotController`), warmup filling the history buffers (:33-75),
a sleep-paced 25-50 Hz policy loop (:77-112), and stand/sit transitions
through interpolated predefined poses (a1_utilities/predefined_pose.py).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from vision4leg_torch.robots import a1_params as P

STAND_POSE = np.asarray(P.INIT_MOTOR_ANGLES)
SIT_POSE = np.array([-0.27805507, 1.1002311, -2.7185967] * 4)
KP, KD = 80.0, 0.4


def position_cmd(q: np.ndarray, kp: float = KP, kd: float = KD) -> np.ndarray:
  """12 x [q, Kp, dq, Kd, tau] low-level command
  (a1_sensor_process.prepare_position_cmd)."""
  cmd = np.zeros(60, np.float32)
  cmd[0::5] = q
  cmd[1::5] = kp
  cmd[3::5] = kd
  return cmd


class RobotController:
  """UDP control thread (a1_utilities/robot_controller.py:9-126): reads
  LowState at a fixed rate, sends the latest position command."""

  def __init__(self, robot_interface, control_freq: float = 400.0):
    self.ri = robot_interface
    self.dt = 1.0 / control_freq
    self._cmd = position_cmd(STAND_POSE)
    self._state = None
    self._lock = threading.Lock()
    self._running = False
    self._thread = None

  def set_action(self, cmd60: np.ndarray):
    with self._lock:
      self._cmd = np.asarray(cmd60, np.float32)

  def get_state(self):
    with self._lock:
      return self._state

  def step(self):
    """One exchange: read the state, send the latest command."""
    state = self.ri.ReceiveObservation()
    with self._lock:
      self._state = state
      cmd = self._cmd
    self.ri.SendCommand(cmd)

  def _loop(self):
    while self._running:
      t0 = time.time()
      self.step()
      time.sleep(max(0.0, self.dt - (time.time() - t0)))

  def start_thread(self):
    self._running = True
    self._thread = threading.Thread(target=self._loop, daemon=True)
    self._thread.start()

  def stop_thread(self):
    self._running = False
    if self._thread:
      self._thread.join(timeout=1.0)


class Executor:
  """Policy loop (main_executor.py:77-141)."""

  def __init__(self, policy_wrapper, robot_controller: RobotController,
               camera=None, control_freq: float = 25.0,
               frame_interval: int = 1):
    self.policy = policy_wrapper
    self.rc = robot_controller
    self.camera = camera
    self.dt = 1.0 / control_freq
    self.frame_interval = frame_interval

  def _observe(self):
    state = self.rc.get_state()
    if state is None:
      return None
    rpy = state.imu.rpy
    drpy = state.imu.gyroscope
    q = state.motorState.q
    depth = (self.camera.get_depth() if self.camera is not None
             else np.full((64, 64), 10.0))
    return rpy, drpy, q, depth

  def warmup_observations(self, steps: int = 20):
    """Fill the history rings before control starts (:33-75)."""
    for _ in range(steps):
      obs = self._observe()
      if obs is not None:
        self.policy.process_obs(*obs)
      time.sleep(self.dt)

  def stand_up(self, duration: float = 2.0):
    self._interp_to(STAND_POSE, duration)

  def sit_down(self, duration: float = 2.0):
    self._interp_to(SIT_POSE, duration)

  def _interp_to(self, target: np.ndarray, duration: float):
    state = self.rc.get_state()
    start = state.motorState.q if state is not None else STAND_POSE
    steps = max(int(duration / 0.01), 1)
    for i in range(steps):
      alpha = (i + 1) / steps
      self.rc.set_action(position_cmd((1 - alpha) * start + alpha * target))
      time.sleep(0.01)

  def control_step(self):
    """One policy tick: observe, act, hand the command to the control
    thread; False when no state has arrived yet."""
    obs = self._observe()
    if obs is None:
      return False
    q_cmd = self.policy.get_action(*obs)
    self.rc.set_action(position_cmd(q_cmd))
    return True

  def main_execution(self, seconds: float):
    t_end = time.time() + seconds
    while time.time() < t_end:
      t0 = time.time()
      self.control_step()
      time.sleep(max(0.0, self.dt - (time.time() - t0)))

  def execute(self, seconds: float):
    """stand -> warmup -> policy -> sit (main_executor.py:126-141)."""
    self.rc.start_thread()
    if self.camera is not None:
      self.camera.start_thread()
    try:
      self.stand_up()
      self.warmup_observations()
      self.main_execution(seconds)
      self.sit_down()
    finally:
      if self.camera is not None:
        self.camera.stop_thread()
      self.rc.stop_thread()
