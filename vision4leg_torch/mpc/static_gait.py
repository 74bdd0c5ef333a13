"""Static (statically-stable) gait: a COM-shift + one-foot-at-a-time
stepping state machine (the port's copy of vision4leg_tpu.mpc.static_gait).

Counterpart of the reference's experimental static gait
(mpc_controller/foot_stepper.py + static_gait_controller.py): the same
state machine — shift the body until the COM projects inside the support
triangle of the three stance feet, then swing the fourth foot along a
sinusoidal-height trajectory to its new foothold — with two differences:

  * foot targets resolve to joint angles through the closed-form A1 leg
    IK (mpc/leg_kinematics.py) instead of pybullet's numerical IK;
  * the pybullet debug-sphere drawing is dropped (no GUI client here).

This is a slow-rate supervisory controller with branchy per-event state,
so it stays a host-side (numpy) object like the reference; its IK runs
the port's `leg_kinematics.foot_ik_hip_frame` on CPU float32 tensors.
Foot order: FR FL RR RL.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vision4leg_torch.mpc import leg_kinematics as lk

# state-machine constants (foot_stepper.py:36-41, 68-72)
MAX_SHIFT = 0.0008
FAR_BOUND = 0.005
CLOSE_BOUND = 0.03
SWING_AMP = 0.08          # sinusoidal foot lift; reference uses 0.2 for the
                          # taller Laikago (foot_stepper.py:41), scaled to A1
LOCAL_DIFF_Y_THRESHOLD = 0.05
STEP_ORDER = (1, 3, 0, 2)  # feetindices (foot_stepper.py:65)
SUPPORT_VERTICES = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def _quat_rotate_np(q_wxyz, v):
  w, x, y, z = q_wxyz
  u = np.array([x, y, z])
  uv = np.cross(u, v)
  return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_conj_np(q_wxyz):
  return np.array([q_wxyz[0], -q_wxyz[1], -q_wxyz[2], -q_wxyz[3]])


class FootStepper:
  """COM-shift + swing-foot state machine (foot_stepper.py:25-199)."""

  def __init__(self, toe_pos_local_ref: np.ndarray):
    self.toe_pos_local_ref = np.array(toe_pos_local_ref, np.float64)
    self.state_time = 0.0
    self.is_far = True
    self.move_swing_foot = False
    self._order_idx = 0
    self.swing_foot_index = STEP_ORDER[self._order_idx]
    self.local_diff_y = 100.0
    self.new_pos_local = self.get_reference_pos_swing_foot()

  def next_foot(self):
    self._order_idx = (self._order_idx + 1) % 4
    self.swing_foot_index = STEP_ORDER[self._order_idx]

  def swing_foot(self):
    self.move_swing_foot = True

  def get_reference_pos_swing_foot(self) -> np.ndarray:
    self.new_pos_local = np.array(
        self.toe_pos_local_ref[self.swing_foot_index])
    return self.new_pos_local

  def set_reference_pos_swing_foot(self, new_pos_local):
    self.new_pos_local = np.asarray(new_pos_local, np.float64)

  def is_com_stable(self) -> bool:
    yaw_ok = self.local_diff_y ** 2 < LOCAL_DIFF_Y_THRESHOLD ** 2
    return (not self.is_far) and yaw_ok

  def update(self, base_com_pos, base_quat_wxyz, toe_pos_world, dt):
    """One tick: returns the 4 desired toe positions in WORLD frame
    (foot_stepper.py:97-199, minus the debug drawing)."""
    base_com_pos = np.asarray(base_com_pos, np.float64)

    # support-triangle centroid of the three stance feet
    centroid_world = np.zeros(3)
    for v in SUPPORT_VERTICES[self.swing_foot_index]:
      centroid_world += toe_pos_world[v]
    centroid_world /= 3.0

    diff_world = base_com_pos - centroid_world
    diff_world[2] = 0.0
    dist = np.linalg.norm(diff_world)
    bound = FAR_BOUND if self.is_far else CLOSE_BOUND
    if dist > bound:
      diff_world *= MAX_SHIFT * 0.5 / dist
      self.is_far = True
    else:
      self.is_far = False
    if not self.is_far:
      diff_world = np.zeros(3)

    # shifting every local foot reference by the world diff moves the BODY
    # toward the support centroid (feet are anchored by stance)
    self.toe_pos_local_ref += diff_world[None, :]

    # yaw balance: keep front/rear y-split symmetric (:157-173)
    self.local_diff_y = (self.toe_pos_local_ref[0][1]
                         + self.toe_pos_local_ref[1][1]
                         - self.toe_pos_local_ref[2][1]
                         - self.toe_pos_local_ref[3][1])
    yaw = 0.0
    if self.local_diff_y < -LOCAL_DIFF_Y_THRESHOLD:
      yaw = 0.001
    if self.local_diff_y > LOCAL_DIFF_Y_THRESHOLD:
      yaw = -0.001
    if not self.is_far and yaw != 0.0:
      cy, sy = math.cos(yaw), math.sin(yaw)
      rot = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
      self.toe_pos_local_ref = self.toe_pos_local_ref @ rot.T

    # swing-foot progression (:175-196)
    if self.move_swing_foot and self.state_time <= 1.0:
      self.state_time += 4.0 * dt
    if self.state_time >= 1.0:
      self.move_swing_foot = False
      self.state_time = 0.0
      self.toe_pos_local_ref[self.swing_foot_index] = self.new_pos_local

    targets_local = np.array(self.toe_pos_local_ref)
    t = self.state_time
    old_pos = self.toe_pos_local_ref[self.swing_foot_index]
    targets_local[self.swing_foot_index] = [
        old_pos[0] * (1 - t) + self.new_pos_local[0] * t,
        old_pos[1] * (1 - t) + self.new_pos_local[1] * t,
        old_pos[2] * (1 - t) + self.new_pos_local[2] * t
        + SWING_AMP * math.sin(t * math.pi),
    ]

    return np.stack([
        base_com_pos + _quat_rotate_np(base_quat_wxyz, p)
        for p in targets_local
    ])


class StaticGaitController:
  """Statically-stable walking (static_gait_controller.py:21-70): wait for
  COM stability, pick the next foot, step it `step_dist` forward; foot
  world targets resolve to motor angles via the closed-form leg IK."""

  def __init__(self, toe_pos_local_ref: np.ndarray, step_dist: float = 0.1,
               dt: float = 1.0 / 250):
    self.stepper = FootStepper(toe_pos_local_ref)
    self.step_dist = step_dist
    self.dt = dt
    self._wait_count = 0

  def act(self, base_com_pos, base_quat_wxyz, toe_pos_world) -> np.ndarray:
    """One control tick -> desired 12 motor angles."""
    stepper = self.stepper
    if stepper.is_com_stable() and not stepper.move_swing_foot:
      self._wait_count += 1
      if self._wait_count == 20:
        stepper.next_foot()
      if self._wait_count > 50:
        self._wait_count = 0
        new_pos_local = stepper.get_reference_pos_swing_foot()
        new_pos_local = np.array(new_pos_local)
        new_pos_local[0] += self.step_dist
        stepper.set_reference_pos_swing_foot(new_pos_local)
        stepper.swing_foot()

    toe_world_targets = stepper.update(base_com_pos, base_quat_wxyz,
                                       toe_pos_world, self.dt)
    # world -> base frame -> hip frame -> IK per leg
    q_inv = _quat_conj_np(np.asarray(base_quat_wxyz, np.float64))
    hips = np.asarray(lk.HIP_ORIGINS)
    angles = []
    for leg in range(4):
      local = _quat_rotate_np(q_inv,
                              toe_world_targets[leg] - base_com_pos)
      qleg = lk.foot_ik_hip_frame(
          torch.tensor(local - hips[leg], dtype=torch.float32),
          float(lk.SIDE_SIGN[leg]))
      angles.append(qleg.numpy())
    return np.concatenate(angles).astype(np.float32)
