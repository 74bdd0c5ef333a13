"""Compliant contact models (torch mirror of vision4leg_tpu.physics.contact).

Sphere collision points against a terrain surface, yaw-oriented boxes and
static spheres; penalty normal force plus regularized Coulomb friction.
Every function takes leading batch dimensions: points (..., P, 3), boxes
(..., K, 8), spheres (..., Q, 5), friction a scalar or shaped like the
batch (...).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ContactParams:
  stiffness: float = 5000.0
  damping: float = 150.0
  v_slip: float = 0.02   # regularization velocity of the Coulomb cone


def _contact_force(phi, normal, vel, friction, params: ContactParams):
  """Penalty force for penetration phi (>0 inside) along `normal`.
  phi (..., P); normal, vel (..., P, 3); friction broadcastable to phi."""
  in_contact = phi > 0.0
  v_n = torch.sum(vel * normal, dim=-1)
  f_n = params.stiffness * phi - params.damping * v_n
  f_n = torch.clamp(f_n, min=0.0) * in_contact
  v_t = vel - v_n[..., None] * normal
  v_t_norm = torch.sqrt(torch.sum(v_t * v_t, dim=-1) + params.v_slip ** 2)
  f_t = -(friction * f_n / v_t_norm)[..., None] * v_t
  return f_n[..., None] * normal + f_t


def make_terrain_contact_fn(
    height_fn: Callable[[torch.Tensor], torch.Tensor],
    normal_fn: Callable[[torch.Tensor], torch.Tensor],
    boxes: torch.Tensor | None = None,
    spheres: torch.Tensor | None = None,
    friction=0.8, box_friction=0.8,
    params: ContactParams = ContactParams()):
  """ContactFn (pos (...,P,3), vel (...,P,3), radius (P,)) ->
  (force (...,P,3), penetration (...,P,2) = [ground, obstacle])."""

  def contact_fn(pos, vel, radius) -> Tuple[torch.Tensor, torch.Tensor]:
    fr = torch.as_tensor(friction, dtype=pos.dtype, device=pos.device)
    fb = torch.as_tensor(box_friction, dtype=pos.dtype, device=pos.device)
    h = height_fn(pos[..., :2])
    n = normal_fn(pos[..., :2])
    phi = h - (pos[..., 2] - radius)
    force = _contact_force(phi, n, vel, fr[..., None], params)
    phib = torch.full_like(phi, -1.0)
    if boxes is not None and boxes.shape[-2] > 0:
      f_b, phib = _sphere_box_forces(pos, vel, radius, boxes, fb, params)
      force = force + f_b
    if spheres is not None and spheres.shape[-2] > 0:
      f_s, phis = _sphere_sphere_forces(pos, vel, radius, spheres, fb,
                                        params)
      force = force + f_s
      phib = torch.maximum(phib, phis)
    return force, torch.stack([phi, phib], dim=-1)

  return contact_fn


def _sphere_box_forces(pos, vel, radius, boxes, friction, params):
  """P spheres vs K yaw-oriented boxes [center(3), half(3), yaw, valid].
  Returns (forces (...,P,3), max penetration per point (...,P))."""
  c = boxes[..., None, :, 0:3]                         # (...,1,K,3)
  half = boxes[..., None, :, 3:6]
  yaw = boxes[..., None, :, 6]                         # (...,1,K)
  valid = boxes[..., None, :, 7]
  cy, sy = torch.cos(yaw), torch.sin(yaw)
  d = pos[..., :, None, :] - c                         # (...,P,K,3)
  lx = cy * d[..., 0] + sy * d[..., 1]
  ly = -sy * d[..., 0] + cy * d[..., 1]
  lp = torch.stack([lx, ly, d[..., 2]], dim=-1)
  closest = torch.maximum(torch.minimum(lp, half), -half)
  delta = lp - closest
  dist_out = torch.linalg.norm(delta, dim=-1)          # 0 when inside
  inside = dist_out <= 1e-9
  face_gap = half - torch.abs(lp)
  min_gap = torch.amin(face_gap, dim=-1)
  rad = radius[:, None]
  phi = torch.where(inside, rad + min_gap, rad - dist_out)
  n_out = delta / torch.clamp(dist_out, min=1e-9)[..., None]
  g0, g1, g2 = face_gap.unbind(-1)
  m0 = (g0 <= g1) & (g0 <= g2)                         # first-min argmin
  m1 = ~m0 & (g1 <= g2)
  m2 = ~(m0 | m1)
  onehot = torch.stack([m0, m1, m2], dim=-1).to(lp.dtype)
  sign = torch.sign(torch.sum(lp * onehot, dim=-1))
  n_face = onehot * sign[..., None]
  n_local = torch.where(inside[..., None], n_face, n_out)
  nw = torch.stack([
      cy * n_local[..., 0] - sy * n_local[..., 1],
      sy * n_local[..., 0] + cy * n_local[..., 1],
      n_local[..., 2]], dim=-1)
  phi = torch.where(valid > 0.5, phi, torch.full_like(phi, -1.0))
  f = _contact_force(phi, nw, vel[..., :, None, :], friction[..., None, None],
                     params)
  return torch.sum(f, dim=-2), torch.amax(phi, dim=-1)


def _sphere_sphere_forces(pos, vel, radius, spheres, friction, params):
  """P collision spheres vs Q static spheres [center(3), radius, valid]."""
  c = spheres[..., None, :, 0:3]
  r = spheres[..., None, :, 3]
  valid = spheres[..., None, :, 4]
  d = pos[..., :, None, :] - c                         # (...,P,Q,3)
  dist = torch.linalg.norm(d, dim=-1)
  phi = (radius[:, None] + r) - dist
  phi = torch.where(valid > 0.5, phi, torch.full_like(phi, -1.0))
  n = d / torch.clamp(dist, min=1e-9)[..., None]
  f = _contact_force(phi, n, vel[..., :, None, :], friction[..., None, None],
                     params)
  return torch.sum(f, dim=-2), torch.amax(phi, dim=-1)
