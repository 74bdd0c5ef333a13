"""Quaternion / rotation math (torch mirror of vision4leg_tpu.physics.maths).

Quaternions are (w, x, y, z), Hamilton convention; every function takes
leading batch dimensions.
"""
from __future__ import annotations

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  aw, ax, ay, az = a.unbind(-1)
  bw, bx, by, bz = b.unbind(-1)
  return torch.stack([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw,
  ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate v by q (body->world if q is body->world)."""
  w = q[..., 0:1]
  u = q[..., 1:4]
  uv = torch.linalg.cross(u, v)
  return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """(..., 4) wxyz -> (..., 3, 3)."""
  w, x, y, z = q.unbind(-1)
  return torch.stack([
      torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], dim=-1),
      torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], dim=-1),
      torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], dim=-1),
  ], dim=-2)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor,
                   dt: float) -> torch.Tensor:
  """Integrate orientation by world-frame angular velocity over dt."""
  angle = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
  axis = omega_world / torch.clamp(angle, min=1e-9)
  half = 0.5 * (angle * dt)
  dq = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
  out = quat_mul(dq, q)
  return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
  """Roll-pitch-yaw (extrinsic xyz), pybullet.getEulerFromQuaternion."""
  w, x, y, z = q.unbind(-1)
  roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
  pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
  yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
  return torch.stack([roll, pitch, yaw], dim=-1)


def wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
  """skew(a) @ b == cross(a, b); (..., 3) -> (..., 3, 3)."""
  x, y, z = v.unbind(-1)
  zero = torch.zeros_like(x)
  return torch.stack([
      torch.stack([zero, -z, y], dim=-1),
      torch.stack([z, zero, -x], dim=-1),
      torch.stack([-y, x, zero], dim=-1),
  ], dim=-2)
