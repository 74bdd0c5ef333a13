"""Unitree A1 physical constants (the torch port's own copy of
`vision4leg_tpu/robots/a1_params.py`; numpy only).

Numbers are the public Unitree A1 description shipped with the reference
(`vision4leg/assets/a1/a1.urdf` in the upstream project) — link masses, COMs,
inertias, joint placements/axes/limits — plus the control constants the reference
hardcodes in `vision4leg/robots/a1.py` (PD gains a1.py:89-94, init pose
a1.py:97, init position a1.py:52).

Massless bookkeeping links from the URDF (imu_link, *_upper_shoulder, each
0.001 kg) are dropped; the 0.06 kg toe spheres are fused into their parent
lower (calf) links — see `fused_lower_link()`.

Body indexing used across the engine:
  0      trunk (floating base)
  1+3*l  hip    of leg l
  2+3*l  upper (thigh)
  3+3*l  lower (calf, with toe fused)
with legs ordered l = 0:FR, 1:FL, 2:RR, 3:RL (reference motor order,
a1.py MOTOR_NAMES).
"""
from __future__ import annotations

import numpy as np


# --- trunk (a1.urdf link "trunk") ---
TRUNK_MASS = 4.713
TRUNK_COM = np.array([0.012731, 0.002186, 0.000515])
TRUNK_INERTIA = np.array([
    [0.01683993, 8.3902e-05, 0.000597679],
    [8.3902e-05, 0.056579028, 2.5134e-05],
    [0.000597679, 2.5134e-05, 0.064713601],
])
TRUNK_BOX_SIZE = np.array([0.267, 0.194, 0.114])  # collision box

# --- hip links (identical up to mirroring) ---
HIP_MASS = 0.696
# COM mirrors in x (front/rear) and y (right/left):
#   FR: [-0.003311, -0.000635, 3.1e-05]
HIP_COM_FR = np.array([-0.003311, -0.000635, 3.1e-05])
HIP_INERTIA_DIAG = np.array([0.000469246, 0.00080749, 0.000552929])
HIP_INERTIA_FR_OFFDIAG = dict(ixy=9.409e-06, ixz=-3.42e-07, iyz=4.66e-07)

# --- upper (thigh) links ---
UPPER_MASS = 1.013
UPPER_COM_FR = np.array([-0.003237, 0.022327, -0.027326])  # right-side value
UPPER_INERTIA_DIAG = np.array([0.005529065, 0.005139339, 0.001367788])
UPPER_INERTIA_FR_OFFDIAG = dict(ixy=-4.825e-06, ixz=0.000343869, iyz=-2.2448e-05)

# --- lower (calf) links ---
LOWER_MASS = 0.166
LOWER_COM = np.array([0.006435, 0.0, -0.107388])
LOWER_INERTIA = np.array([
    [0.002997972, 0.0, -0.000141163],
    [0.0, 0.003014022, 0.0],
    [-0.000141163, 0.0, 3.2426e-05],
])
TOE_MASS = 0.06
TOE_INERTIA_ISO = 9.6e-06
TOE_OFFSET = np.array([0.0, 0.0, -0.2])  # in lower-link frame
TOE_RADIUS = 0.02

# --- joint placements (parent-frame origins; urdf <joint><origin xyz>) ---
HIP_OFFSET_X = 0.183    # |x| of *_hip_joint origin on trunk
HIP_OFFSET_Y = 0.047    # |y| of *_hip_joint origin on trunk
UPPER_OFFSET_Y = 0.08505  # |y| of *_upper_joint origin on hip
LOWER_OFFSET_Z = -0.2   # *_lower_joint origin on upper

# --- joint limits (urdf) in reference motor order (hip, upper, lower) x 4 ---
HIP_LIMIT = (-0.802851455917, 0.802851455917)
UPPER_LIMIT = (-1.0471975512, 4.18879020479)
LOWER_LIMIT = (-2.69653369433, -0.916297857297)
JOINT_LOWER = np.array([HIP_LIMIT[0], UPPER_LIMIT[0], LOWER_LIMIT[0]] * 4)
JOINT_UPPER = np.array([HIP_LIMIT[1], UPPER_LIMIT[1], LOWER_LIMIT[1]] * 4)

# --- control constants (reference vision4leg/robots/a1.py) ---
MOTOR_KP = np.full(12, 80.0)  # a1.py:89-94 (ABDUCTION/HIP/KNEE all 80, 0.4)
MOTOR_KD = np.full(12, 0.4)
INIT_MOTOR_ANGLES = np.array([0.0, 0.9, -1.8] * 4)  # a1.py:97
INIT_POSITION = np.array([0.0, 0.0, 0.32])  # a1.py:52


def _mirror_inertia(ixx_iyy_izz: np.ndarray, off: dict, sx: float,
                    sy: float) -> np.ndarray:
  """Mirror an inertia tensor for a link reflected in x (sx) and/or y (sy).

  Reflecting a rigid body through a coordinate plane flips the sign of the
  inertia products involving that axis; the URDF encodes FR values and the
  other legs are mirrored copies.
  """
  ixy = off["ixy"] * sx * sy
  ixz = off["ixz"] * sx
  iyz = off["iyz"] * sy
  ixx, iyy, izz = ixx_iyy_izz
  return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


def fused_lower_link():
  """Lower link with the toe point-mass fused in.

  Returns (mass, com, inertia_about_com) in the lower-link frame.
  """
  m = LOWER_MASS + TOE_MASS
  com = (LOWER_MASS * LOWER_COM + TOE_MASS * TOE_OFFSET) / m
  inertia = np.zeros((3, 3))
  for mass_i, com_i, I_i in (
      (LOWER_MASS, LOWER_COM, LOWER_INERTIA),
      (TOE_MASS, TOE_OFFSET, np.eye(3) * TOE_INERTIA_ISO),
  ):
    d = com_i - com
    # parallel axis: I_about_new = I_com + m (|d|^2 E - d d^T)
    inertia += I_i + mass_i * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
  return m, com, inertia


def leg_signs():
  """Per-leg mirror signs in (FR, FL, RR, RL) order.

  Returns (front_x, side_y) where front_x = +1 front / -1 rear legs and
  side_y = -1 right / +1 left legs (the URDF's FR leg is the base case:
  its hip joint sits at (+0.183, -0.047)).
  """
  front_x = np.array([1.0, 1.0, -1.0, -1.0])
  side_y = np.array([-1.0, 1.0, -1.0, 1.0])
  return front_x, side_y
