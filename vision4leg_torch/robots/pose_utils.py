"""Robot pose containers and motor-angle conversions (the port's copy of
vision4leg_tpu.robots.pose_utils, numpy only).

Mirrors the reference's pose-utils family:
  * laikago_pose_utils.py:24-60 — LaikagoPose (per-leg abduction/hip/knee)
    and the joint offsets applied when mapping poses to raw URDF joint
    angles (laikago.py:250-267, laikago_sim.py:30-32).
  * robot_pose_utils.py:40-75 — robot-agnostic conversion helpers.

The A1's URDF has zero joint offsets, so its pose == motor angles; the
Laikago's raw joint angles are pose + (hip, upper, knee) offsets.
Leg order everywhere: 0 FR, 1 FL, 2 RR, 3 RL.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LAIKAGO_DEFAULT_ABDUCTION_ANGLE = 0.0
LAIKAGO_DEFAULT_HIP_ANGLE = 0.67
LAIKAGO_DEFAULT_KNEE_ANGLE = -1.25

A1_DEFAULT_ABDUCTION_ANGLE = 0.0
A1_DEFAULT_HIP_ANGLE = 0.9
A1_DEFAULT_KNEE_ANGLE = -1.8

# raw-URDF-joint offsets (laikago_sim.py:30-32); A1's are all zero
LAIKAGO_HIP_JOINT_OFFSET = 0.0
LAIKAGO_UPPER_LEG_JOINT_OFFSET = -0.6
LAIKAGO_KNEE_JOINT_OFFSET = 0.66


@dataclasses.dataclass
class QuadrupedPose:
  """12 named joint angles, (abduction, hip, knee) x (FR, FL, RR, RL)."""
  abduction_angle_0: float = 0.0
  hip_angle_0: float = 0.0
  knee_angle_0: float = 0.0
  abduction_angle_1: float = 0.0
  hip_angle_1: float = 0.0
  knee_angle_1: float = 0.0
  abduction_angle_2: float = 0.0
  hip_angle_2: float = 0.0
  knee_angle_2: float = 0.0
  abduction_angle_3: float = 0.0
  hip_angle_3: float = 0.0
  knee_angle_3: float = 0.0

  def to_motor_angles(self) -> np.ndarray:
    return np.array([getattr(self, f.name)
                     for f in dataclasses.fields(self)], np.float32)

  @classmethod
  def from_motor_angles(cls, angles) -> "QuadrupedPose":
    names = [f.name for f in dataclasses.fields(cls)]
    return cls(**{n: float(a) for n, a in zip(names, np.asarray(angles))})


# the reference exposes per-robot aliases of the same container
LaikagoPose = QuadrupedPose
A1Pose = QuadrupedPose


def laikago_pose_to_joint_angles(pose: QuadrupedPose) -> np.ndarray:
  """Pose -> raw URDF joint angles with the Laikago offsets
  (laikago.py:250-267)."""
  offsets = np.tile([LAIKAGO_HIP_JOINT_OFFSET,
                     LAIKAGO_UPPER_LEG_JOINT_OFFSET,
                     LAIKAGO_KNEE_JOINT_OFFSET], 4).astype(np.float32)
  return pose.to_motor_angles() + offsets


def laikago_joint_angles_to_pose(angles) -> QuadrupedPose:
  offsets = np.tile([LAIKAGO_HIP_JOINT_OFFSET,
                     LAIKAGO_UPPER_LEG_JOINT_OFFSET,
                     LAIKAGO_KNEE_JOINT_OFFSET], 4).astype(np.float32)
  return QuadrupedPose.from_motor_angles(np.asarray(angles) - offsets)


def default_pose(robot: str = "a1") -> QuadrupedPose:
  """Per-robot standing pose (robot_pose_utils.py:59-75)."""
  if robot == "laikago":
    a, h, k = (LAIKAGO_DEFAULT_ABDUCTION_ANGLE, LAIKAGO_DEFAULT_HIP_ANGLE,
               LAIKAGO_DEFAULT_KNEE_ANGLE)
  else:
    a, h, k = (A1_DEFAULT_ABDUCTION_ANGLE, A1_DEFAULT_HIP_ANGLE,
               A1_DEFAULT_KNEE_ANGLE)
  vals = {}
  for leg in range(4):
    vals[f"abduction_angle_{leg}"] = a
    vals[f"hip_angle_{leg}"] = h
    vals[f"knee_angle_{leg}"] = k
  return QuadrupedPose(**vals)
