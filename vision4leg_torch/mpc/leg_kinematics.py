"""A1 leg kinematics: foot FK/IK and Jacobians in the base frame, batched
over leading env dimensions (torch mirror of
vision4leg_tpu.mpc.leg_kinematics).

Closed-form analytic IK for the 3-DOF (hip-roll, thigh-pitch, knee-pitch)
leg, FK by composition and the Jacobian in closed form (the derivative of
the FK below).

Leg frame convention: the leg chain starts at the hip-joint origin on the
trunk at (front_x * 0.183, side_y * 0.047, 0); the thigh joint sits
side_y * 0.08505 lateral of the hip-roll axis; thigh and calf links are
both 0.2 m.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from vision4leg_torch.robots import a1_params as P

L_HIP = P.UPPER_OFFSET_Y   # 0.08505 lateral offset (signed by leg side)
L_THIGH = P.UPPER_LEN      # 0.2
L_CALF = P.LOWER_LEN       # 0.2

_FRONT_X, _SIDE_Y = P.leg_signs()
HIP_ORIGINS = np.stack([
    _FRONT_X * P.HIP_OFFSET_X,
    _SIDE_Y * P.HIP_OFFSET_Y,
    np.zeros(4),
], axis=-1)  # (4, 3) hip-joint origins in base frame
SIDE_SIGN = _SIDE_Y  # (4,) +1 left, -1 right

_CONSTS: Dict[Tuple[str, torch.device, torch.dtype], torch.Tensor] = {}


def const(name: str, arr, like: torch.Tensor) -> torch.Tensor:
  """A numpy constant as a tensor on `like`'s device and dtype, made once
  per (name, device, dtype)."""
  key = (name, like.device, like.dtype)
  if key not in _CONSTS:
    _CONSTS[key] = torch.as_tensor(np.asarray(arr), dtype=like.dtype,
                                   device=like.device)
  return _CONSTS[key]


def foot_position_hip_frame(angles: torch.Tensor, side) -> torch.Tensor:
  """FK of a leg relative to its hip-joint origin, base orientation.

  angles: (..., 3) [hip_roll, thigh_pitch, knee_pitch]; side: +-1 (a
  float or a tensor broadcasting against angles[..., 0]).
  """
  t1, t2, t3 = angles[..., 0], angles[..., 1], angles[..., 2]
  d = side * L_HIP
  # planar 2-link in the x-z plane of the post-roll frame
  x = -L_THIGH * torch.sin(t2) - L_CALF * torch.sin(t2 + t3)
  z = -L_THIGH * torch.cos(t2) - L_CALF * torch.cos(t2 + t3)
  # lift through the hip roll
  c1, s1 = torch.cos(t1), torch.sin(t1)
  y = c1 * d - s1 * z
  z = s1 * d + c1 * z
  return torch.stack([x, y, z], dim=-1)


def foot_positions_base_frame(joint_q: torch.Tensor) -> torch.Tensor:
  """All four feet in the base frame: (..., 12) -> (..., 4, 3)."""
  q = joint_q.reshape(joint_q.shape[:-1] + (4, 3))
  feet = foot_position_hip_frame(q, const("side", SIDE_SIGN, joint_q))
  return feet + const("hips", HIP_ORIGINS, joint_q)


def foot_ik_hip_frame(pos: torch.Tensor, side) -> torch.Tensor:
  """Closed-form IK: foot position (hip-joint frame, (..., 3)) -> joint
  angles (..., 3), on the knee-backward branch the A1 uses (knee < 0).

  With d = side*L_HIP, zp = -sqrt(y^2+z^2-d^2) (foot below the hip-roll
  axis), the FK reads
    (y, z) = Rot(t1) @ (d, zp),
    x  = -k1 sin t2 - k2 cos t2,   zp = -k1 cos t2 + k2 sin t2,
  with k1 = l2 + l3 cos t3, k2 = l3 sin t3 and
  x^2 + zp^2 = l2^2 + l3^2 + 2 l2 l3 cos t3.
  """
  x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
  d = side * L_HIP
  zp = -torch.sqrt(torch.clamp(y * y + z * z - d * d, min=1e-12))
  t1 = torch.atan2(z, y) - torch.atan2(zp, d + torch.zeros_like(zp))
  # wrap to [-pi, pi]
  t1 = torch.atan2(torch.sin(t1), torch.cos(t1))
  reach2 = x * x + zp * zp
  cos_knee = (reach2 - L_THIGH**2 - L_CALF**2) / (2 * L_THIGH * L_CALF)
  t3 = -torch.arccos(torch.clamp(cos_knee, -1.0, 1.0))
  k1 = L_THIGH + L_CALF * torch.cos(t3)
  k2 = L_CALF * torch.sin(t3)
  sin_t2 = (-k1 * x + k2 * zp)
  cos_t2 = (-k2 * x - k1 * zp)
  t2 = torch.atan2(sin_t2, cos_t2)
  return torch.stack([t1, t2, t3], dim=-1)


def foot_ik_base_frame(pos: torch.Tensor, leg: int) -> torch.Tensor:
  return foot_ik_hip_frame(pos - const("hips", HIP_ORIGINS, pos)[leg],
                           float(SIDE_SIGN[leg]))


def leg_jacobian(angles: torch.Tensor, side) -> torch.Tensor:
  """(..., 3, 3) Jacobian d foot_pos / d angles (rows x, y, z)."""
  t1, t2, t3 = angles[..., 0], angles[..., 1], angles[..., 2]
  d = side * L_HIP
  s2, c2 = torch.sin(t2), torch.cos(t2)
  s23, c23 = torch.sin(t2 + t3), torch.cos(t2 + t3)
  x = -L_THIGH * s2 - L_CALF * s23
  zp = -L_THIGH * c2 - L_CALF * c23
  c1, s1 = torch.cos(t1), torch.sin(t1)
  dx2 = -L_THIGH * c2 - L_CALF * c23
  dx3 = -L_CALF * c23
  dzp2 = -x
  dzp3 = L_CALF * s23
  zero = torch.zeros_like(t1)
  row_x = torch.stack([zero, dx2, dx3], dim=-1)
  row_y = torch.stack([-s1 * d - c1 * zp, -s1 * dzp2, -s1 * dzp3], dim=-1)
  row_z = torch.stack([c1 * d - s1 * zp, c1 * dzp2, c1 * dzp3], dim=-1)
  return torch.stack([row_x, row_y, row_z], dim=-2)


def all_leg_jacobians(joint_q: torch.Tensor) -> torch.Tensor:
  """(..., 12) -> (..., 4, 3, 3)."""
  q = joint_q.reshape(joint_q.shape[:-1] + (4, 3))
  return leg_jacobian(q, const("side", SIDE_SIGN, joint_q))
