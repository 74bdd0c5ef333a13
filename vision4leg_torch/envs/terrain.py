"""Terrain state and generators for the flat terrains (torch mirror of the
parts of vision4leg_tpu.envs.terrain this port runs).

Each env owns a TerrainState: oriented boxes with their moving
directions, subgoal centers, the goal and obstacle spheres, batched over
a leading env axis.  Ported here: `plane`, the reference's
`random_blocks_sparse` family (a1_randomizer_ground.py: 50 pillars spaced
by Poisson-disc sampling in the corridor x in [2.5, 28.5], y in [-3, 3],
two fence walls at y = +-3.1, 50 subgoal spheres of radius 0.2), its
`_thin_wide` variant (23 fixed wide slabs before the pillars) and the
moving obstacles' per-step displacement (`moving_blocks_step`).  The
other terrains of the JAX package (heightfields, stairs, spheres,
chair_desk, hill, mount) are ROADMAP queue 1 items 2-4.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NUM_SPARSE_BLOCKS = 50
SPARSE_HALF_LEN = 0.3 / (2 * math.sqrt(2)) * 1.7 + 0.05
SPARSE_HALF_HEIGHT = 0.7
FENCE_Y = 3.1
FENCE_HALF = (30.0 + 0.05, 0.3 / (2 * math.sqrt(2)) + 0.05,
              SPARSE_HALF_HEIGHT * 3)
NUM_SUBGOALS = 50
SUBGOAL_RADIUS = 0.2
NUM_DIRECTIONS = 20
STILL_DIR = 16   # a direction of zero displacement (fences, wide slabs)

# moving-obstacle direction table (a1_randomizer_ground.py:45-66), times
# the per-step scale 3 (:601), in float32 as the JAX package builds it
_DIRECTION = np.array([
    [0.005, 0], [-0.005, 0], [0, 0.005], [0, -0.005],
    [0.004, 0.004], [-0.004, 0.004], [0.004, -0.004], [-0.004, -0.004],
    [0.002, 0.006], [-0.002, 0.006], [0.002, -0.006], [-0.002, -0.006],
    [0.006, 0.002], [-0.006, 0.002], [0.006, -0.002], [-0.006, -0.002],
    [0, 0], [0, 0], [0, 0], [0, 0],
], np.float32) * 3.0
# the direction flip every 150 steps (:425-443): 0<->1, 2<->3; d >= 4 is
# redrawn
_FLIP = np.array([1, 0, 3, 2] + list(range(4, NUM_DIRECTIONS)), np.int64)
FLIP_PERIOD = 150


@dataclasses.dataclass
class TerrainState:
  """Per-episode world geometry of flat terrains, env axis leading."""
  boxes: torch.Tensor             # (E, K, 8): cx cy cz hx hy hz yaw valid
  box_dirs: torch.Tensor          # (E, K) int32 moving-direction indices
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
      box_dirs=torch.zeros(n_env, num_boxes, dtype=torch.int32,
                           device=device),
      subgoals=torch.zeros(n_env, NUM_SUBGOALS, 2, device=device),
      goal_pos=torch.zeros(n_env, 3, device=device),
      obstacle_spheres=torch.zeros(n_env, 0, 5, device=device))


def gen_plane(gen: torch.Generator, n_env: int, device,
              moving: bool = False) -> TerrainState:
  del gen, moving
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


def _fences(n_env, device):
  fy = FENCE_HALF
  return torch.tensor([[15.0, FENCE_Y, fy[2], *fy, 0.0, 1.0],
                       [15.0, -FENCE_Y, fy[2], *fy, 0.0, 1.0]],
                      device=device).expand(n_env, 2, 8)


def _pillars(centers):
  """The sparse family's pillars at centers (E, n, 2)."""
  n_env, n, _ = centers.shape
  dev = centers.device
  half = torch.tensor([SPARSE_HALF_LEN, SPARSE_HALF_LEN, SPARSE_HALF_HEIGHT],
                      device=dev).expand(n_env, n, 3)
  cz = torch.full((n_env, n, 1), SPARSE_HALF_HEIGHT, device=dev)
  return torch.cat([centers, cz, half, torch.zeros(n_env, n, 1, device=dev),
                    torch.ones(n_env, n, 1, device=dev)], dim=-1)


def _draw_sparse(gen, n_env, device):
  """The pillar centers and the subgoals of a sparse-family terrain; the
  moving directions are drawn after them, so that a still terrain's draws
  do not depend on them."""
  centers = min_dist_points(gen, n_env, NUM_SPARSE_BLOCKS, (2.5, -3.0),
                            (28.5, 3.0), r=1.0, m=512, device=device)
  subgoals = _uniform(gen, (n_env, NUM_SUBGOALS, 2), (2.0, -2.2),
                      (30.0, 2.2), device)
  return centers, subgoals


def _raw_dirs(gen, n_env, n_boxes, device, moving):
  """The boxes' moving directions, drawn (after the other draws) only for
  a moving env: a still env's are STILL_DIR, so its generator stream is
  the one of a terrain without directions."""
  if not moving:
    return torch.full((n_env, n_boxes), STILL_DIR, dtype=torch.int32,
                      device=device)
  return torch.randint(0, NUM_DIRECTIONS, (n_env, n_boxes), generator=gen,
                       device=device, dtype=torch.int32)


def blocks_sparse_state(centers, subgoals, raw_dirs) -> TerrainState:
  """random_blocks_sparse(_with_subgoal) from its draws: 50 pillars at
  centers (E, 50, 2), the two fences, subgoals (E, 50, 2); the moving
  directions raw_dirs (E, 52) with the fences' set to STILL_DIR (JAX
  `gen_blocks_sparse`, terrain.py:327-328)."""
  n_env, dev = centers.shape[0], centers.device
  dirs = raw_dirs.clone()
  dirs[:, NUM_SPARSE_BLOCKS:] = STILL_DIR
  return TerrainState(
      boxes=torch.cat([_pillars(centers), _fences(n_env, dev)], dim=1),
      box_dirs=dirs, subgoals=subgoals,
      goal_pos=torch.zeros(n_env, 3, device=dev),
      obstacle_spheres=torch.zeros(n_env, 0, 5, device=dev))


def gen_blocks_sparse(gen: torch.Generator, n_env: int, device,
                      moving: bool = False) -> TerrainState:
  """random_blocks_sparse(_with_subgoal): 50 pillars in a fenced corridor
  plus 50 subgoals (the JAX generator's `subgoal` flag changes nothing);
  moving directions drawn with `moving`."""
  centers, subgoals = _draw_sparse(gen, n_env, device)
  return blocks_sparse_state(
      centers, subgoals,
      _raw_dirs(gen, n_env, NUM_SPARSE_BLOCKS + 2, device, moving))


# the 23 fixed wide slabs of `_generate_convex_blocks_thin_wide`
# (a1_randomizer_ground.py:1652-1930): (2, +-0.75) half (0.3, 0.45, 0.5)
# and a 7-row pattern at (5 + 7i, 0) / (8 + 7i, +-1.8) half
# (0.3, 0.85, 0.5)
_WIDE_SLABS = (
    [[2.0, cy, 0.5, 0.3, 0.45, 0.5, 0.0, 1.0] for cy in (0.75, -0.75)]
    + [[x + 7 * i, y, 0.5, 0.3, 0.85, 0.5, 0.0, 1.0] for i in range(7)
       for x, y in ((5.0, 0.0), (8.0, -1.8), (8.0, 1.8))])
NUM_WIDE_SLABS = len(_WIDE_SLABS)


def thin_wide_state(centers, subgoals, raw_dirs) -> TerrainState:
  """random_blocks_sparse_thin_wide from its draws (JAX `gen_thin_wide`,
  terrain.py:586-634): the 23 wide slabs, 50 pillars at centers
  (E, 50, 2), the two fences; the moving directions raw_dirs (E, 75) with
  the slabs' and the fences' set to STILL_DIR."""
  n_env, dev = centers.shape[0], centers.device
  wide = torch.tensor(_WIDE_SLABS, device=dev).expand(
      n_env, NUM_WIDE_SLABS, 8)
  dirs = raw_dirs.clone()
  dirs[:, :NUM_WIDE_SLABS] = STILL_DIR
  dirs[:, -2:] = STILL_DIR
  return TerrainState(
      boxes=torch.cat([wide, _pillars(centers), _fences(n_env, dev)], dim=1),
      box_dirs=dirs, subgoals=subgoals,
      goal_pos=torch.zeros(n_env, 3, device=dev),
      obstacle_spheres=torch.zeros(n_env, 0, 5, device=dev))


def gen_thin_wide(gen: torch.Generator, n_env: int, device,
                  moving: bool = False) -> TerrainState:
  """random_blocks_sparse_thin_wide: fixed wide slabs, 50 Poisson-placed
  thin pillars, the corridor fences, 50 subgoals; moving directions drawn
  with `moving`."""
  centers, subgoals = _draw_sparse(gen, n_env, device)
  return thin_wide_state(
      centers, subgoals,
      _raw_dirs(gen, n_env, NUM_WIDE_SLABS + NUM_SPARSE_BLOCKS + 2, device,
                moving))


def moving_blocks_step(terrain: TerrainState, step_counter,
                       rand_dirs) -> TerrainState:
  """One step of the moving obstacles (a1_randomizer_ground.py:411-443;
  JAX `moving_blocks_step`): the first NUM_SPARSE_BLOCKS boxes move by their
  direction's displacement; on steps whose counter (E,) is a multiple of
  FLIP_PERIOD their directions flip (0<->1, 2<->3) or, from 4 up, take the
  new draw rand_dirs (E, K) in [0, 20)."""
  dirs = terrain.box_dirs.long()
  dev = dirs.device
  disp = torch.from_numpy(_DIRECTION).to(dev)[dirs]           # (E, K, 2)
  moving = torch.arange(dirs.shape[1], device=dev) < NUM_SPARSE_BLOCKS
  boxes = terrain.boxes.clone()
  boxes[..., 0:2] = boxes[..., 0:2] + disp * moving[:, None].float()
  flip = (step_counter % FLIP_PERIOD) == 0
  flipped = torch.from_numpy(_FLIP).to(dev)[dirs]
  new_dirs = torch.where(dirs >= 4, rand_dirs.long(), flipped)
  dirs = torch.where(flip[:, None] & moving, new_dirs, dirs)
  return terrain.replace(boxes=boxes, box_dirs=dirs.to(torch.int32))


TERRAIN_GENERATORS = {
    "plane": gen_plane,
    "random_blocks_sparse": gen_blocks_sparse,
    "random_blocks_sparse_with_subgoal": gen_blocks_sparse,
    "random_blocks_sparse_thin_wide": gen_thin_wide,
}

# camera frustum-prune cap per terrain (see camera.render_depth)
RENDER_BOX_CAPS = {"random_blocks_sparse": 16,
                   "random_blocks_sparse_with_subgoal": 16,
                   "random_blocks_sparse_thin_wide": 16}

# per-type init pose (QUADRUPED_INIT_POSITION, a1_randomizer_ground.py:286)
INIT_POSITION = {
    "plane": (0, 0, 0.32),
    "random_blocks_sparse": (0, 0, 0.32),
    "random_blocks_sparse_with_subgoal": (0, 0, 0.32),
    "random_blocks_sparse_thin_wide": (0, 0, 0.32),
}
