"""Terrain state and generators for the flat terrains (torch mirror of the
parts of vision4leg_tpu.envs.terrain this port runs).

Each env owns a TerrainState: oriented boxes, subgoal centers, the goal
and obstacle spheres, batched over a leading env axis.  Ported here:
`plane` and `random_blocks_sparse_with_subgoal` (the reference's
`random_blocks_sparse` family, a1_randomizer_ground.py: 50 pillars spaced
by Poisson-disc sampling in the corridor x in [2.5, 28.5], y in [-3, 3],
two fence walls at y = +-3.1, 50 subgoal spheres of radius 0.2).  The
other terrains of the JAX package (heightfields, stairs, spheres,
chair_desk, hill, mount) are ROADMAP queue 1 items 2-4.
"""
from __future__ import annotations

import dataclasses
import math

import torch

NUM_SPARSE_BLOCKS = 50
SPARSE_HALF_LEN = 0.3 / (2 * math.sqrt(2)) * 1.7 + 0.05
SPARSE_HALF_HEIGHT = 0.7
FENCE_Y = 3.1
FENCE_HALF = (30.0 + 0.05, 0.3 / (2 * math.sqrt(2)) + 0.05,
              SPARSE_HALF_HEIGHT * 3)
NUM_SUBGOALS = 50
SUBGOAL_RADIUS = 0.2


@dataclasses.dataclass
class TerrainState:
  """Per-episode world geometry of flat terrains, env axis leading."""
  boxes: torch.Tensor             # (E, K, 8): cx cy cz hx hy hz yaw valid
  subgoals: torch.Tensor          # (E, S, 2) subgoal xy centers
  goal_pos: torch.Tensor          # (E, 3) zeros if unused
  obstacle_spheres: torch.Tensor  # (E, Q, 5) [x, y, z, r, valid]

  def replace(self, **kw) -> "TerrainState":
    return dataclasses.replace(self, **kw)


def flat_height_fn():
  """Height and normal functions of the z=0 ground."""

  def h(xy):
    return torch.zeros(xy.shape[:-1], device=xy.device)

  def n(xy):
    out = torch.zeros(xy.shape[:-1] + (3,), device=xy.device)
    out[..., 2] = 1.0
    return out

  return h, n


def _empty(n_env: int, num_boxes: int, device) -> TerrainState:
  return TerrainState(
      boxes=torch.zeros(n_env, num_boxes, 8, device=device),
      subgoals=torch.zeros(n_env, NUM_SUBGOALS, 2, device=device),
      goal_pos=torch.zeros(n_env, 3, device=device),
      obstacle_spheres=torch.zeros(n_env, 0, 5, device=device))


def gen_plane(gen: torch.Generator, n_env: int, device) -> TerrainState:
  del gen
  return _empty(n_env, 0, device)


def _uniform(gen, shape, lo, hi, device):
  lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
  hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
  u = torch.rand(shape, generator=gen, device=device)
  return lo + (hi - lo) * u


def _jittered_corridor_points(gen, n_env, n, lo, hi, device):
  """Stratified jittered samples of n points in [lo, hi], shuffled."""
  nx = int(math.ceil(math.sqrt(n * (hi[0] - lo[0]) / (hi[1] - lo[1]))))
  ny = int(math.ceil(n / nx))
  xs = torch.linspace(lo[0], hi[0], nx + 1, device=device)[:-1]
  ys = torch.linspace(lo[1], hi[1], ny + 1, device=device)[:-1]
  cw = torch.tensor([(hi[0] - lo[0]) / nx, (hi[1] - lo[1]) / ny],
                    device=device)
  gx, gy = torch.meshgrid(xs, ys, indexing="ij")
  cells = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)[:n]
  jitter = torch.rand(n_env, n, 2, generator=gen, device=device) * cw
  pts = cells + jitter
  perm = torch.argsort(torch.rand(n_env, n, generator=gen, device=device),
                       dim=-1)
  return torch.gather(pts, 1, perm[..., None].expand(n_env, n, 2))


def min_dist_points(gen, n_env, n, lo, hi, r, m, device):
  """n points per env in [lo, hi] with pairwise distance >= r: random
  sequential adsorption over m uniform candidates (the reference spaces
  its obstacles by Poisson-disc sampling, a1_randomizer_ground.py:69-242);
  any unfilled tail falls back to stratified-jitter points."""
  cand = _uniform(gen, (n_env, m, 2), lo, hi, device)
  sentinel = torch.tensor(hi, device=device) + 1e6
  pts = sentinel.expand(n_env, n, 2).clone()
  cnt = torch.zeros(n_env, dtype=torch.long, device=device)
  rows = torch.arange(n_env, device=device)
  for i in range(m):
    p = cand[:, i]
    ok = torch.all(torch.sum((pts - p[:, None]) ** 2, dim=-1) >= r * r,
                   dim=-1) & (cnt < n)
    slot = torch.clamp(cnt, max=n - 1)
    cur = pts[rows, slot]
    pts[rows, slot] = torch.where(ok[:, None], p, cur)
    cnt = cnt + ok.long()
  fallback = _jittered_corridor_points(gen, n_env, n, lo, hi, device)
  filled = (torch.arange(n, device=device)[None] < cnt[:, None])[..., None]
  return torch.where(filled, pts, fallback)


def gen_blocks_sparse(gen: torch.Generator, n_env: int, device
                      ) -> TerrainState:
  """random_blocks_sparse(_with_subgoal): 50 pillars in a fenced corridor
  plus 50 subgoals (the JAX generator's `subgoal` flag changes nothing)."""
  n = NUM_SPARSE_BLOCKS
  centers = min_dist_points(gen, n_env, n, (2.5, -3.0), (28.5, 3.0), r=1.0,
                            m=512, device=device)
  half = torch.tensor([SPARSE_HALF_LEN, SPARSE_HALF_LEN, SPARSE_HALF_HEIGHT],
                      device=device).expand(n_env, n, 3)
  cz = torch.full((n_env, n, 1), SPARSE_HALF_HEIGHT, device=device)
  blocks = torch.cat([centers, cz, half, torch.zeros(n_env, n, 1,
                                                     device=device),
                      torch.ones(n_env, n, 1, device=device)], dim=-1)
  fy = FENCE_HALF
  fence = torch.tensor([[15.0, FENCE_Y, fy[2], *fy, 0.0, 1.0],
                        [15.0, -FENCE_Y, fy[2], *fy, 0.0, 1.0]],
                       device=device).expand(n_env, 2, 8)
  subgoals = _uniform(gen, (n_env, NUM_SUBGOALS, 2), (2.0, -2.2),
                      (30.0, 2.2), device)
  return TerrainState(
      boxes=torch.cat([blocks, fence], dim=1), subgoals=subgoals,
      goal_pos=torch.zeros(n_env, 3, device=device),
      obstacle_spheres=torch.zeros(n_env, 0, 5, device=device))


TERRAIN_GENERATORS = {
    "plane": gen_plane,
    "random_blocks_sparse": gen_blocks_sparse,
    "random_blocks_sparse_with_subgoal": gen_blocks_sparse,
}

# camera frustum-prune cap per terrain (see camera.render_depth)
RENDER_BOX_CAPS = {"random_blocks_sparse": 16,
                   "random_blocks_sparse_with_subgoal": 16}

# per-type init pose (QUADRUPED_INIT_POSITION, a1_randomizer_ground.py:286)
INIT_POSITION = {
    "plane": (0, 0, 0.32),
    "random_blocks_sparse": (0, 0, 0.32),
    "random_blocks_sparse_with_subgoal": (0, 0, 0.32),
}
