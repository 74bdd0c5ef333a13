"""Build the A1 quadruped `Model` for the torch physics engine (mirror of
`vision4leg_tpu/robots/a1_model.py`).

Replaces the reference's URDF load into PyBullet
(`vision4leg/robots/a1.py:221-235` `_LoadRobotURDF`): the same tree, masses
and inertias (see `a1_params`), expressed as engine data.

Collision geometry: toe spheres (the reference's foot contacts,
a1.py:252 GetFootContacts), knee spheres at the calf top, hip cylinders
approximated by spheres, and the trunk collision box approximated by its
8 corner spheres — enough for locomotion contacts and for the task's
"non-foot contact" termination check (move_forward_task.py:113-132).
"""
from __future__ import annotations

import numpy as np

from .model import Model, make_model
from . import a1_params as P

# body indices
TRUNK = 0


def hip_body(leg: int) -> int:
  return 1 + 3 * leg


def upper_body(leg: int) -> int:
  return 2 + 3 * leg


def lower_body(leg: int) -> int:
  return 3 + 3 * leg


def build(dt: float = 0.0025, armature: float = 0.01,
          joint_damping: float = 0.0, device="cpu") -> Model:
  front_x, side_y = P.leg_signs()
  nb = 13
  parent = np.full(nb, -1, np.int32)
  joint_axis = np.zeros((12, 3), np.float32)
  joint_offset = np.zeros((12, 3), np.float32)
  mass = np.zeros(nb, np.float32)
  com = np.zeros((nb, 3), np.float32)
  inertia = np.zeros((nb, 3, 3), np.float32)

  mass[TRUNK] = P.TRUNK_MASS
  com[TRUNK] = P.TRUNK_COM
  inertia[TRUNK] = P.TRUNK_INERTIA

  lower_m, lower_com, lower_I = P.fused_lower_link()

  for leg in range(4):
    sx, sy = front_x[leg], side_y[leg]
    my = -sy  # inertial mirror sign: +1 for right legs (URDF FR base case)
    hip, upper, lower = hip_body(leg), upper_body(leg), lower_body(leg)
    # hip joint: on trunk, axis x
    parent[hip] = TRUNK
    joint_offset[hip - 1] = [sx * P.HIP_OFFSET_X, sy * P.HIP_OFFSET_Y, 0.0]
    joint_axis[hip - 1] = [1.0, 0.0, 0.0]
    mass[hip] = P.HIP_MASS
    com[hip] = P.HIP_COM_FR * np.array([sx, my, 1.0])
    inertia[hip] = P._mirror_inertia(P.HIP_INERTIA_DIAG,
                                     P.HIP_INERTIA_FR_OFFDIAG, sx, my)
    # upper joint: on hip, axis y (thigh is the same part front & rear)
    parent[upper] = hip
    joint_offset[upper - 1] = [0.0, sy * P.UPPER_OFFSET_Y, 0.0]
    joint_axis[upper - 1] = [0.0, 1.0, 0.0]
    mass[upper] = P.UPPER_MASS
    com[upper] = P.UPPER_COM_FR * np.array([1.0, my, 1.0])
    inertia[upper] = P._mirror_inertia(P.UPPER_INERTIA_DIAG,
                                       P.UPPER_INERTIA_FR_OFFDIAG, 1.0, my)
    # lower (knee) joint: on upper, axis y
    parent[lower] = upper
    joint_offset[lower - 1] = [0.0, 0.0, P.LOWER_OFFSET_Z]
    joint_axis[lower - 1] = [0.0, 1.0, 0.0]
    mass[lower] = lower_m
    com[lower] = lower_com
    inertia[lower] = lower_I

  # --- collision points ---
  cp_body, cp_offset, cp_radius, cp_is_foot = [], [], [], []
  # toes (feet), one per leg — order FR, FL, RR, RL first so foot contact
  # flags are cp[:4]
  for leg in range(4):
    cp_body.append(lower_body(leg))
    cp_offset.append(P.TOE_OFFSET)
    cp_radius.append(P.TOE_RADIUS)
    cp_is_foot.append(1.0)
  # knees (calf top)
  for leg in range(4):
    cp_body.append(lower_body(leg))
    cp_offset.append([0.0, 0.0, -0.02])
    cp_radius.append(0.02)
    cp_is_foot.append(0.0)
  # hips (cylinder r=0.046 approximated by a sphere)
  for leg in range(4):
    cp_body.append(hip_body(leg))
    cp_offset.append([0.0, 0.0, 0.0])
    cp_radius.append(0.046)
    cp_is_foot.append(0.0)
  # trunk box corners
  hx, hy, hz = P.TRUNK_BOX_SIZE / 2.0
  for sx_ in (-1, 1):
    for sy_ in (-1, 1):
      for sz_ in (-1, 1):
        cp_body.append(TRUNK)
        cp_offset.append([sx_ * hx, sy_ * hy, sz_ * hz])
        cp_radius.append(0.01)
        cp_is_foot.append(0.0)

  return make_model(
      parent=parent,
      joint_axis=joint_axis,
      joint_offset=joint_offset,
      mass=mass,
      com=com,
      inertia=inertia,
      joint_lower=P.JOINT_LOWER,
      joint_upper=P.JOINT_UPPER,
      cp_body=np.array(cp_body),
      cp_offset=np.array(cp_offset, np.float32),
      cp_radius=np.array(cp_radius, np.float32),
      cp_is_foot=np.array(cp_is_foot, np.float32),
      dt=dt,
      armature=armature,
      joint_damping=joint_damping,
      device=device,
  )

