"""Depth camera by analytic raycasting (torch mirror of
vision4leg_tpu.envs.camera).

Replaces PyBullet's 64x64 depth render of the reference
(locomotion_gym_env_with_rich_information.py:569-632): eye at the trunk
plus 0.2309 m along its x-axis, view direction (x - z)/2, projection
P00=1.0825318, P11=1.7320509.  Rays have unit forward component, so the
hit parameter t is the view-axis depth the reference linearizes its
z-buffer to.  The ground is the plane z=0 (the flat terrains; the
heightfield march of the others is not copied here).  Every
function is batched over a leading env axis; these are plain torch ops
(the JAX package has no Pallas kernel here).
"""
from __future__ import annotations

import torch

from .terrain import SUBGOAL_RADIUS, TerrainState

IMG_SIZE = 64
P00 = 1.0825318098068237
P11 = 1.732050895690918
DEPTH_CLIP = 10.0
MAX_RENDER_BOXES = 40
MAX_RENDER_SPHERES = 32
NUM_BLIND_SPOTS = 30


def _normalize(v):
  return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def view_frame(trunk_rot):
  """Unit forward, right and up axes (E, 3) of the camera."""
  x_axis = trunk_rot[..., :, 0]
  z_axis = trunk_rot[..., :, 2]
  f = _normalize(0.5 * (x_axis - z_axis))
  up = 0.5 * (x_axis + z_axis)
  r = _normalize(torch.linalg.cross(f, up))
  u = torch.linalg.cross(r, f)
  return f, r, u


def camera_rays(trunk_pos, trunk_rot):
  """Eye (E, 3) and ray directions (E, H*W, 3) with unit forward part."""
  x_axis = trunk_rot[..., :, 0]
  eye = trunk_pos + 0.2309 * x_axis
  f, r, u = view_frame(trunk_rot)
  dev = trunk_pos.device
  idx = torch.arange(IMG_SIZE, device=dev, dtype=torch.float32)
  px = (idx + 0.5) / IMG_SIZE * 2.0 - 1.0
  py = 1.0 - (idx + 0.5) / IMG_SIZE * 2.0
  gy, gx = torch.meshgrid(py, px, indexing="ij")      # (H, W), row 0 top
  dirs = (f[..., None, None, :]
          + (gx / P00)[..., None] * r[..., None, None, :]
          + (gy / P11)[..., None] * u[..., None, None, :])
  return eye, dirs.reshape(dirs.shape[:-3] + (-1, 3))


def _prune_rows(rows, eye, f, r_ax, u_ax, centers, bound_r, valid, k: int):
  """Keep the k rows nearest in view depth among those that can intersect
  the view cone truncated at the depth clip; returns (rows, valid)."""
  if rows.shape[-2] <= k:
    return rows, valid
  d = centers - eye[..., None, :]
  ax = torch.sum(d * f[..., None, :], dim=-1)
  lr = torch.sum(d * r_ax[..., None, :], dim=-1)
  lu = torch.sum(d * u_ax[..., None, :], dim=-1)
  a_max, b_max = 1.0 / P00, 1.0 / P11
  na = (1.0 + a_max ** 2) ** 0.5
  nb = (1.0 + b_max ** 2) ** 0.5
  cull = ((ax - bound_r > DEPTH_CLIP + 0.2)
          | (ax + bound_r < -0.01)
          | ((lr - a_max * ax) / na > bound_r + 0.01)
          | ((-lr - a_max * ax) / na > bound_r + 0.01)
          | ((lu - b_max * ax) / nb > bound_r + 0.01)
          | ((-lu - b_max * ax) / nb > bound_r + 0.01)
          | (valid < 0.5))
  key = torch.where(cull, torch.full_like(ax, float("inf")), ax)
  neg, idx = torch.topk(-key, k, dim=-1)
  kept = torch.gather(rows, -2, idx[..., None].expand(
      idx.shape + (rows.shape[-1],)))
  return kept, torch.isfinite(neg).to(rows.dtype)


def _ray_plane_t(eye, dirs):
  """t of the hit with the ground plane z=0 (inf if none)."""
  dz = dirs[..., 2]
  dz = torch.where(torch.abs(dz) < 1e-9, torch.full_like(dz, -1e-9), dz)
  t = -eye[..., None, 2] / dz
  return torch.where(t > 0, t, torch.full_like(t, float("inf")))


def _ray_boxes_t(eye, dirs, boxes):
  """Min positive t over K yaw-oriented boxes (E, K, 8): slab test."""
  c, half, yaw, valid = (boxes[..., 0:3], boxes[..., 3:6], boxes[..., 6],
                         boxes[..., 7])
  cy, sy = torch.cos(yaw)[..., None, :], torch.sin(yaw)[..., None, :]
  eo = eye[..., None, :] - c
  e = (cy[..., 0, :] * eo[..., 0] + sy[..., 0, :] * eo[..., 1],
       -sy[..., 0, :] * eo[..., 0] + cy[..., 0, :] * eo[..., 1], eo[..., 2])
  dx, dy = dirs[..., 0:1], dirs[..., 1:2]
  d0 = cy * dx + sy * dy                                # (E, N, K)
  d1 = -sy * dx + cy * dy
  d2 = dirs[..., 2:3].expand_as(d0)
  tmin = torch.full_like(d0, -float("inf"))
  tmax = torch.full_like(d0, float("inf"))
  for ea, d, h in ((e[0], d0, half[..., 0]), (e[1], d1, half[..., 1]),
                   (e[2], d2, half[..., 2])):
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t1 = (-h - ea)[..., None, :] * inv
    t2 = (h - ea)[..., None, :] * inv
    tmin = torch.maximum(tmin, torch.minimum(t1, t2))
    tmax = torch.minimum(tmax, torch.maximum(t1, t2))
  hit = (tmax >= torch.clamp(tmin, min=0.0)) & (valid[..., None, :] > 0.5)
  t = torch.where(hit, torch.clamp(tmin, min=1e-4),
                  torch.full_like(tmin, float("inf")))
  return torch.amin(t, dim=-1)


def _ray_spheres_t(eye, dirs, centers, radius, active):
  """Min positive t over S spheres; centers (E, S, 3), radius a number or
  (E, S), active (E, S)."""
  oc = eye[..., None, :] - centers
  d2 = torch.sum(dirs * dirs, dim=-1)                   # (E, N)
  b = torch.einsum("eni,esi->ens", dirs, oc)
  cterm = (torch.sum(oc * oc, dim=-1) - radius * radius)[..., None, :]
  disc = b * b - d2[..., None] * cterm
  sq = torch.sqrt(torch.clamp(disc, min=0.0))
  t = (-b - sq) / d2[..., None]
  hit = (disc > 0) & (t > 0) & (active[..., None, :] > 0.5)
  return torch.amin(torch.where(hit, t, torch.full_like(t, float("inf"))),
                    dim=-1)


def render_depth(trunk_pos, trunk_rot, terrain: TerrainState,
                 show_subgoals: bool, max_boxes: int | None = None,
                 flat: bool = True, far_t: float = 10.5):
  """(E, 64, 64) linearized depth (background 1000): the ground is the
  plane z=0 with `flat`, else the terrain's heightfields marched to far_t
  (10.5 m is exact after preprocess_depth's 10 m clip; the env passes 20
  without it, JAX env.py:405-408)."""
  if max_boxes is None:
    max_boxes = MAX_RENDER_BOXES
  eye, dirs = camera_rays(trunk_pos, trunk_rot)
  f_axis, r_axis, u_axis = view_frame(trunk_rot)
  if not flat:
    raise NotImplementedError("the benchmark's camera reference renders "
                              "the flat terrains only")
  t = _ray_plane_t(eye, dirs)
  boxes = terrain.boxes
  if boxes.shape[-2] > 0:
    if boxes.shape[-2] > max_boxes:
      br = torch.linalg.norm(boxes[..., 3:6], dim=-1)
      boxes, v = _prune_rows(boxes, eye, f_axis, r_axis, u_axis,
                             boxes[..., 0:3], br, boxes[..., 7], max_boxes)
      boxes = torch.cat([boxes[..., :7],
                         torch.minimum(boxes[..., 7], v)[..., None]], dim=-1)
    t = torch.minimum(t, _ray_boxes_t(eye, dirs, boxes))
  q = terrain.obstacle_spheres
  if q.shape[-2] > 0:
    if q.shape[-2] > MAX_RENDER_SPHERES:
      q, v = _prune_rows(q, eye, f_axis, r_axis, u_axis, q[..., 0:3],
                         q[..., 3], q[..., 4], MAX_RENDER_SPHERES)
      q = torch.cat([q[..., :4], torch.minimum(q[..., 4], v)[..., None]],
                    dim=-1)
    t = torch.minimum(t, _ray_spheres_t(eye, dirs, q[..., 0:3], q[..., 3],
                                        q[..., 4]))
  if show_subgoals:
    sg = terrain.subgoals
    centers = torch.cat([sg, torch.full_like(sg[..., :1], SUBGOAL_RADIUS)],
                        dim=-1)
    active = torch.ones_like(sg[..., 0])
    if centers.shape[-2] > MAX_RENDER_SPHERES:
      centers, active = _prune_rows(
          centers, eye, f_axis, r_axis, u_axis, centers, SUBGOAL_RADIUS,
          active, MAX_RENDER_SPHERES)
    t = torch.minimum(t, _ray_spheres_t(eye, dirs, centers, SUBGOAL_RADIUS,
                                        active))
  depth = torch.where(torch.isfinite(t), t, torch.full_like(t, 1000.0))
  return depth.reshape(depth.shape[:-1] + (IMG_SIZE, IMG_SIZE))


def preprocess_depth(depth, blind_num, blind_idx):
  """RealSense blind spots + clip [0.3, 10] + sqrt(log(d + 1)) (reference
  :623-632).  blind_num (E,) in [3, 30) spots painted at the first
  blind_num of blind_idx (E, 30, 2) (row, col)."""
  E = depth.shape[0]
  n_pix = IMG_SIZE * IMG_SIZE
  flat = blind_idx[..., 0] * IMG_SIZE + blind_idx[..., 1]
  used = torch.arange(blind_idx.shape[1], device=depth.device)[None] \
      < blind_num[:, None]
  flat = torch.where(used, flat, torch.full_like(flat, n_pix)).long()
  hit = torch.zeros(E, n_pix + 1, dtype=torch.bool, device=depth.device)
  hit.scatter_(1, flat, True)
  hit = hit[:, :n_pix].reshape(E, IMG_SIZE, IMG_SIZE)
  depth = torch.where(hit, torch.full_like(depth, 10.0), depth)
  depth = torch.clamp(depth, 0.3, 10.0)
  return torch.sqrt(torch.log(depth + 1.0))
