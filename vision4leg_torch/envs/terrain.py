"""Terrain state, height queries and generators (torch mirror of
vision4leg_tpu.envs.terrain).

Each env owns a TerrainState: a heightfield grid (a 2 x 2 zero grid on
the flat terrains), oriented boxes with their moving directions, subgoal
centers, the goal and obstacle spheres, batched over a leading env axis.
Ported here: `plane`; the reference's `random_blocks_sparse` family
(a1_randomizer_ground.py: 50 pillars spaced by Poisson-disc sampling in
the corridor x in [2.5, 28.5], y in [-3, 3], two fence walls at y = +-3.1,
50 subgoal spheres of radius 0.2), its `_thin_wide` variant (23 fixed wide
slabs before the pillars), its `_and_heightfield` variants (the pillars on
a random 256 x 256 heightfield) and the moving obstacles' per-step
displacement (`moving_blocks_step`); `random_heightfield`; the flat
challenge terrains `stairs`, `multi_stairs`, `random_blocks` and
`random_chair_desk`; the flat `random_sphere_with_subgoal` (50 obstacle
spheres); the non-flat `random_hill`, `mount`, `random_mount` and
`triangle_mesh`.

Every random generator is a draw function and a state-from-draws function
(`*_state`), so that tests can feed the JAX package's draws.  The mount
and the triangle mesh read the port's copies of the JAX package's
heightmap assets (`vision4leg_torch/assets/`); each env keeps a grid of
its own, as the JAX package does, so that the collector's partial resets
and the checkpoint see one plain tensor.
"""
from __future__ import annotations

import dataclasses
import math
import os

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
HEIGHTFIELD_N = 256
HEIGHTFIELD_CELL = 0.12
HEIGHTFIELD_RANGE = 0.1  # env_builder passes height_range=0.1
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

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


@dataclasses.dataclass
class TerrainState:
  """Per-episode world geometry, env axis leading."""
  height: torch.Tensor            # (E, H, W) heightfield samples (m)
  hf_cell: torch.Tensor           # (E,) cell size (m)
  hf_origin: torch.Tensor         # (E, 2) world xy of grid index (0, 0)
  hf_zoff: torch.Tensor           # (E,) additive world z offset
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


def heightfield_fns(terrain: TerrainState):
  """Bilinear height lookup and central-difference normals of each env's
  own grid (JAX `heightfield_fns`, terrain.py:105-184).  Queries xy
  (E, ..., 2) -> heights (E, ...) / unit normals (E, ..., 3).  The JAX
  package runs up to 512 queries as a one-hot hat-weight einsum and more
  as this 4-corner gather; the two agree to rounding.  Non-finite query
  coordinates (a diverged env's) read index 0 and all are clipped to
  [0, H - 1.001]: on the card an out-of-range gather index is a device
  assert that kills the process."""
  grid = terrain.height
  E, H, W = grid.shape
  flat_grid = grid.reshape(E, H * W)
  cell, origin, zoff = terrain.hf_cell, terrain.hf_origin, terrain.hf_zoff

  def per_env(x, xy):
    return x.reshape((E,) + (1,) * (xy.dim() - 2))

  def _coords(xy):
    gx = (xy[..., 0] - per_env(origin[:, 0], xy)) / per_env(cell, xy)
    gy = (xy[..., 1] - per_env(origin[:, 1], xy)) / per_env(cell, xy)
    gx = torch.where(torch.isfinite(gx), gx, torch.zeros_like(gx))
    gy = torch.where(torch.isfinite(gy), gy, torch.zeros_like(gy))
    return torch.clamp(gx, 0.0, H - 1.001), torch.clamp(gy, 0.0, W - 1.001)

  def h(xy):
    gx, gy = _coords(xy)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    idx = (x0.long() * W + y0.long()).reshape(E, -1)

    def corner(offset):
      return torch.gather(flat_grid, 1, idx + offset).reshape(gx.shape)

    h00, h10, h01, h11 = corner(0), corner(W), corner(1), corner(W + 1)
    return (((h00 * (1 - fx) + h10 * fx) * (1 - fy)
             + (h01 * (1 - fx) + h11 * fx) * fy) + per_env(zoff, xy))

  def n(xy):
    eps = cell.reshape((E,) + (1,) * (xy.dim() - 1))
    zero = torch.zeros_like(eps)
    ex = torch.cat([eps, zero], dim=-1)
    ey = torch.cat([zero, eps], dim=-1)
    dx = h(xy + ex) - h(xy - ex)
    dy = h(xy + ey) - h(xy - ey)
    nrm = torch.stack([-dx, -dy, 2 * eps[..., 0] * torch.ones_like(dx)],
                      dim=-1)
    return nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)

  return h, n


def height_fns(terrain: TerrainState, flat: bool):
  """(h, n) of the flat ground or of the terrain's heightfields."""
  return flat_height_fn() if flat else heightfield_fns(terrain)


def _flat_field(n_env, device, hf_n=2):
  """The zero grid of a flat terrain (JAX `_empty`, terrain.py:195-207):
  (height, hf_cell, hf_origin, hf_zoff)."""
  return dict(
      height=torch.zeros(n_env, hf_n, hf_n, device=device),
      hf_cell=torch.full((n_env,), HEIGHTFIELD_CELL, device=device),
      hf_origin=torch.full((n_env, 2), -0.5 * hf_n * HEIGHTFIELD_CELL,
                           device=device),
      hf_zoff=torch.zeros(n_env, device=device))


def _empty(n_env: int, num_boxes: int, device) -> TerrainState:
  return TerrainState(
      **_flat_field(n_env, device),
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


def _terrain(boxes, box_dirs, subgoals=None, goal_pos=None,
             field=None, spheres=None) -> TerrainState:
  """A TerrainState of boxes (E, K, 8) and their directions (E, K); the
  subgoals, the goal, the heightfield and the obstacle spheres default to
  none, zeros, the flat 2 x 2 grid and none."""
  n_env, dev = boxes.shape[0], boxes.device
  return TerrainState(
      **(field if field is not None else _flat_field(n_env, dev)),
      boxes=boxes, box_dirs=box_dirs,
      subgoals=(subgoals if subgoals is not None
                else torch.zeros(n_env, NUM_SUBGOALS, 2, device=dev)),
      goal_pos=(goal_pos if goal_pos is not None
                else torch.zeros(n_env, 3, device=dev)),
      obstacle_spheres=(spheres if spheres is not None
                        else torch.zeros(n_env, 0, 5, device=dev)))


def _still(n_env, n_boxes, device):
  return torch.full((n_env, n_boxes), STILL_DIR, dtype=torch.int32,
                    device=device)


def blocks_sparse_state(centers, subgoals, raw_dirs,
                        heights=None) -> TerrainState:
  """random_blocks_sparse(_with_subgoal) from its draws: 50 pillars at
  centers (E, 50, 2), the two fences, subgoals (E, 50, 2); the moving
  directions raw_dirs (E, 52) with the fences' set to STILL_DIR (JAX
  `gen_blocks_sparse`, terrain.py:327-328); with `heights` (E, 128, 128)
  the pillars stand on that random heightfield (`_and_heightfield`)."""
  n_env, dev = centers.shape[0], centers.device
  dirs = raw_dirs.clone()
  dirs[:, NUM_SPARSE_BLOCKS:] = STILL_DIR
  return _terrain(
      torch.cat([_pillars(centers), _fences(n_env, dev)], dim=1), dirs,
      subgoals=subgoals,
      field=random_heightfield_field(heights) if heights is not None
      else None)


def gen_blocks_sparse(gen: torch.Generator, n_env: int, device,
                      moving: bool = False,
                      heightfield: bool = False) -> TerrainState:
  """random_blocks_sparse(_with_subgoal)(_and_heightfield): 50 pillars in
  a fenced corridor plus 50 subgoals (the JAX generator's `subgoal` flag
  changes nothing), on a random heightfield with `heightfield`; moving
  directions drawn with `moving`."""
  centers, subgoals = _draw_sparse(gen, n_env, device)
  heights = draw_heightfield(gen, n_env, device) if heightfield else None
  return blocks_sparse_state(
      centers, subgoals,
      _raw_dirs(gen, n_env, NUM_SPARSE_BLOCKS + 2, device, moving), heights)


def gen_blocks_sparse_heightfield(gen: torch.Generator, n_env: int, device,
                                  moving: bool = False) -> TerrainState:
  return gen_blocks_sparse(gen, n_env, device, moving, heightfield=True)


def draw_heightfield(gen, n_env, device):
  """The random heightfield's draws: (E, 128, 128) heights in [0, 0.1)."""
  half = HEIGHTFIELD_N // 2
  return _uniform(gen, (n_env, half, half), 0.0, HEIGHTFIELD_RANGE, device)


def random_heightfield_field(heights):
  """The heightfield of PyBullet's `_generate_field` from its draws
  (E, 128, 128) (JAX `_random_heightfield_arrays`, terrain.py:335-352):
  the 10 x 10 centre block flat, each draw repeated over 2 x 2 cells of
  the 256 x 256 grid, 0.12 m cells, centred on its z range."""
  n_env, half, _ = heights.shape
  dev = heights.device
  c = half // 2
  ii = torch.arange(half, device=dev)
  m = (ii >= c - 5) & (ii < c + 5)
  h = torch.where(m[:, None] & m[None], torch.zeros_like(heights), heights)
  grid = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
  zoff = -(grid.amax(dim=(1, 2)) + grid.amin(dim=(1, 2))) / 2.0
  n = 2 * half
  return dict(
      height=grid,
      hf_cell=torch.full((n_env,), HEIGHTFIELD_CELL, device=dev),
      hf_origin=torch.full((n_env, 2), -0.5 * n * HEIGHTFIELD_CELL,
                           device=dev),
      hf_zoff=zoff)


def random_heightfield_state(heights) -> TerrainState:
  """random_heightfield from its draws: the heightfield alone."""
  n_env, dev = heights.shape[0], heights.device
  return _terrain(torch.zeros(n_env, 0, 8, device=dev),
                  torch.zeros(n_env, 0, dtype=torch.int32, device=dev),
                  field=random_heightfield_field(heights))


def gen_random_heightfield(gen: torch.Generator, n_env: int, device,
                           moving: bool = False) -> TerrainState:
  del moving
  return random_heightfield_state(draw_heightfield(gen, n_env, device))


def stairs_state(n_env: int, device) -> TerrainState:
  """stairs (JAX `gen_stairs`, terrain.py:360-375): 7 overlapping slabs
  (half 2 x 25 x 0.2) at x = 2.75 + 0.44 k rising 0.1 m a step then
  descending; goal at x = 10."""
  xs = 2.75 + 0.44 * np.array([0, 1, 2, 3, 4, 5, 6])
  lvl = np.array([1, 2, 3, 4, 3, 2, 1], np.float32)
  boxes = np.zeros((7, 8), np.float32)
  boxes[:, 0] = xs
  boxes[:, 2] = -0.2 + lvl * 0.10
  boxes[:, 3:6] = [2.0, 25.0, 0.2]
  boxes[:, 7] = 1.0
  return _terrain(
      torch.tensor(boxes, device=device).expand(n_env, 7, 8).clone(),
      _still(n_env, 7, device),
      goal_pos=torch.tensor([10.0, 0.0, 0.0], device=device).expand(
          n_env, 3).clone())


def gen_stairs(gen: torch.Generator, n_env: int, device,
               moving: bool = False) -> TerrainState:
  del gen, moving
  return stairs_state(n_env, device)


MULTI_STAIRS_MAX = 5


def draw_multi_stairs(gen, n_env, device):
  """multi_stairs' draws: the staircases' count (E,) in [1, 6), their x
  noise (E, 5) in [-4, 4) and step-height noise (E, 5) in [-0.01, 0.01)."""
  num = torch.randint(1, MULTI_STAIRS_MAX + 1, (n_env,), generator=gen,
                      device=device)
  noise = _uniform(gen, (n_env, MULTI_STAIRS_MAX), -4.0, 4.0, device)
  h_noise = _uniform(gen, (n_env, MULTI_STAIRS_MAX), -0.01, 0.01, device)
  return num, noise, h_noise


def multi_stairs_state(num, noise, h_noise) -> TerrainState:
  """multi_stairs from its draws (JAX `gen_multi_stairs`, terrain.py
  :557-583; reference `_generate_multi_stairs` :703-760): 5 staircases of
  7 slabs, the first `num` valid, staircase i at 6.75 i plus its x noise
  (none for the first), steps 0.05 m plus its height noise; goal at
  x = 20."""
  n_env, dev = noise.shape[0], noise.device
  noise = noise.clone()
  noise[:, 0] = 0.0
  lvl = torch.tensor([1, 2, 3, 4, 3, 2, 1], dtype=torch.float32, device=dev)
  offs = 0.44 * torch.arange(7, dtype=torch.float32, device=dev)
  stair_i = torch.arange(MULTI_STAIRS_MAX, device=dev).repeat_interleave(7)
  slab_j = torch.arange(7, device=dev).repeat(MULTI_STAIRS_MAX)
  xs = noise[:, stair_i] + 6.75 * stair_i + 2.75 + offs[slab_j]
  zs = -0.2 + lvl[slab_j] * (0.05 + h_noise[:, stair_i])
  valid = (stair_i[None] < num[:, None]).float()
  full = lambda v: torch.full_like(xs, v)
  boxes = torch.stack([xs, full(0.0), zs, full(2.0), full(25.0), full(0.2),
                       full(0.0), valid], dim=-1)
  return _terrain(
      boxes, _still(n_env, boxes.shape[1], dev),
      goal_pos=torch.tensor([20.0, 0.0, 0.0], device=dev).expand(
          n_env, 3).clone())


def gen_multi_stairs(gen: torch.Generator, n_env: int, device,
                     moving: bool = False) -> TerrainState:
  del moving
  return multi_stairs_state(*draw_multi_stairs(gen, n_env, device))


RANDOM_BLOCKS = 20


def draw_random_blocks(gen, n_env, device):
  """random_blocks' draws: centers (E, 20, 2) in [0, -0.5]..[5, 0.5], side
  draws (E, 20) in [0.1, 0.2) and height draws (E, 20) in
  [0.0375, 0.075)."""
  centers = _uniform(gen, (n_env, RANDOM_BLOCKS, 2), (0.0, -0.5), (5.0, 0.5),
                     device)
  side = _uniform(gen, (n_env, RANDOM_BLOCKS), 0.1, 0.2, device)
  height = _uniform(gen, (n_env, RANDOM_BLOCKS), 0.0375, 0.075, device)
  return centers, side, height


def random_blocks_state(centers, side, height) -> TerrainState:
  """random_blocks from its draws (JAX `gen_random_blocks`, terrain.py
  :534-554; reference `_generate_convex_blocks` :469-520): 20 small
  blocks, half side side / (2 sqrt 2), half height height / 2, those
  within 0.3 m of the origin in x and y invalid."""
  n_env, dev = centers.shape[0], centers.device
  half_len = side / (2 * math.sqrt(2))
  half_h = height / 2
  near = (torch.abs(centers[..., 0]) < 0.3) & (torch.abs(centers[..., 1])
                                                < 0.3)
  boxes = torch.cat([
      centers, half_h[..., None], half_len[..., None], half_len[..., None],
      half_h[..., None], torch.zeros_like(half_h)[..., None],
      (~near).float()[..., None]], dim=-1)
  return _terrain(boxes, _still(n_env, RANDOM_BLOCKS, dev))


def gen_random_blocks(gen: torch.Generator, n_env: int, device,
                      moving: bool = False) -> TerrainState:
  del moving
  return random_blocks_state(*draw_random_blocks(gen, n_env, device))


# chair_desk geometry, decoded from the reference assets by the JAX
# package (terrain.py:653-679): tipped-over chairs (world half
# (0.183, 0.147, 0.324) at z 0.34) and desks (world half (0.300, 0.741,
# 0.289) at z 0.24), 50 + 30 from one Poisson-disc sampling at 1.1 m
# (PoissonDisc2D(26, 6, 1.1), a1_randomizer_ground.py:1868), and two fence
# walls half (30.05, 0.156, 0.5) at (15, +-3, 0.5)
_CHAIRS, _DESKS = 50, 30
_CHAIR_HALF = (0.183, 0.147, 0.324)
_CHAIR_Z = 0.34
_DESK_HALF = (0.300, 0.741, 0.289)
_DESK_Z = 0.24
_CD_FENCE_HALF = (30.0 + 0.05, 0.3 / (2 * math.sqrt(2)) + 0.05, 0.5)


def draw_chair_desk(gen, n_env, device):
  """chair_desk's draws: 80 centers (E, 80, 2) at least 1.1 m apart."""
  return min_dist_points(gen, n_env, _CHAIRS + _DESKS, (2.5, -3.0),
                         (28.5, 3.0), r=1.1, m=2048, device=device)


def chair_desk_state(centers) -> TerrainState:
  """random_chair_desk from its draws (JAX `gen_chair_desk`, terrain.py
  :680-703): chairs at the first 50 centers, desks at the next 30, then
  the two fences."""
  n_env, dev = centers.shape[0], centers.device

  def rows(xy, z, half):
    n = xy.shape[1]
    return torch.cat([
        xy, torch.full((n_env, n, 1), z, device=dev),
        torch.tensor(half, device=dev).expand(n_env, n, 3),
        torch.zeros(n_env, n, 1, device=dev),
        torch.ones(n_env, n, 1, device=dev)], dim=-1)

  fences = torch.tensor([[15.0, y, _CD_FENCE_HALF[2], *_CD_FENCE_HALF, 0.0,
                          1.0] for y in (3.0, -3.0)], device=dev)
  boxes = torch.cat([rows(centers[:, :_CHAIRS], _CHAIR_Z, _CHAIR_HALF),
                     rows(centers[:, _CHAIRS:], _DESK_Z, _DESK_HALF),
                     fences.expand(n_env, 2, 8)], dim=1)
  return _terrain(boxes, _still(n_env, boxes.shape[1], dev))


def gen_chair_desk(gen: torch.Generator, n_env: int, device,
                   moving: bool = False) -> TerrainState:
  del moving
  return chair_desk_state(draw_chair_desk(gen, n_env, device))


HILL_N, HILL_CELL, HILL_BUMPS = 128, 0.2, 40


def draw_hill(gen, n_env, device):
  """random_hill's draws: 40 bump centers (E, 40, 2) in [-11, 11), widths
  (E, 40) in [1.6, 4) and amplitude draws (E, 40) in [0.3, 1)."""
  centers = _uniform(gen, (n_env, HILL_BUMPS, 2), -11.0, 11.0, device)
  sigmas = _uniform(gen, (n_env, HILL_BUMPS), 1.6, 4.0, device)
  amps = _uniform(gen, (n_env, HILL_BUMPS), 0.3, 1.0, device)
  return centers, sigmas, amps


def gaussian_landscape(centers, sigmas, amps, n, cell, height_scale,
                       flat_radius):
  """(E, n, n) sum of gaussian bumps, flattened within flat_radius of the
  origin and blended over 4 m by a cosine ramp (JAX `_gaussian_landscape`,
  terrain.py:376-403); one bump at a time, so that no (E, n, n, bumps)
  tensor is made."""
  dev = centers.device
  xs = (torch.arange(n, dtype=torch.float32, device=dev) - n / 2) * cell
  gx, gy = torch.meshgrid(xs, xs, indexing="ij")
  amps = amps * height_scale
  grid = torch.zeros((centers.shape[0], n, n), device=dev)
  for k in range(centers.shape[1]):
    d2 = ((gx - centers[:, k, 0, None, None]) ** 2
          + (gy - centers[:, k, 1, None, None]) ** 2)
    grid = grid + amps[:, k, None, None] * torch.exp(
        -d2 / (2 * sigmas[:, k, None, None] ** 2))
  r = torch.sqrt(gx ** 2 + gy ** 2)
  frac = torch.clamp((r - flat_radius) / 4.0, 0.0, 1.0)
  return grid * 0.5 * (1.0 - torch.cos(math.pi * frac))


def _field(grid, cell, origin):
  n_env, dev = grid.shape[0], grid.device
  return dict(height=grid, hf_cell=torch.full((n_env,), cell, device=dev),
              hf_origin=torch.tensor(origin, dtype=torch.float32,
                                     device=dev).expand(n_env, 2).clone(),
              hf_zoff=torch.zeros(n_env, device=dev))


def _no_boxes(n_env, dev):
  return (torch.zeros(n_env, 0, 8, device=dev),
          torch.zeros(n_env, 0, dtype=torch.int32, device=dev))


def hill_state(centers, sigmas, amps) -> TerrainState:
  """random_hill from its draws (JAX `gen_hill`, terrain.py:406-427): the
  procedural stand-in for the reference's ground0.txt, 40 bumps of
  amplitude draw x 0.35 on a 128 x 128 grid of 0.2 m cells centred on the
  origin, flat within 1.5 m of it."""
  grid = gaussian_landscape(centers, sigmas, amps, HILL_N, HILL_CELL,
                            height_scale=0.35, flat_radius=1.5)
  half = -HILL_N / 2 * HILL_CELL
  return _terrain(*_no_boxes(grid.shape[0], grid.device),
                  field=_field(grid, HILL_CELL, [half, half]))


def gen_hill(gen: torch.Generator, n_env: int, device,
             moving: bool = False) -> TerrainState:
  del moving
  return hill_state(*draw_hill(gen, n_env, device))


# the reference's mount (a1_randomizer_ground.py:1011-1024): the JAX
# package decoded heightmaps/wm_height_out.png into assets/mount_hf.npz,
# a 256 x 256 crop of 0.1 m cells from index 185, whose grid index 0 lies
# at x = y = 2 + (185 - 255.5) * 0.1; goal sphere at (4, 11.5, 3.5)
_MOUNT_CELL = 0.1
_MOUNT_CROP_I0 = 185
MOUNT_GOAL_POS = (4.0, 11.5, 3.5)


def load_asset(name: str) -> dict:
  """The arrays of one of the port's heightmap assets; raises when the
  file is missing (the JAX package's procedural stand-in is not
  ported)."""
  path = os.path.join(ASSETS, name)
  if not os.path.exists(path):
    raise FileNotFoundError(
        f"heightmap asset {path} is missing: the port keeps copies of the "
        "JAX package's vision4leg_tpu/assets/ files there and has no "
        "stand-in terrain")
  with np.load(path) as data:
    return {k: np.asarray(data[k]) for k in data.files}


def _shared_grid(grid_np, n_env, device):
  """One copy of a fixed grid per env."""
  grid = torch.tensor(np.ascontiguousarray(grid_np, np.float32),
                      device=device)
  return grid.expand((n_env,) + grid.shape).clone()


def mount_state(n_env: int, device, goal: bool = True) -> TerrainState:
  """mount / random_mount (JAX `gen_mount`, terrain.py:500-513): the real
  mount geometry, the same for every env and every reset; the goal at
  MOUNT_GOAL_POS with `goal`."""
  grid = _shared_grid(load_asset("mount_hf.npz")["height"], n_env, device)
  origin = 2.0 + (_MOUNT_CROP_I0 - 255.5) * _MOUNT_CELL
  goal_pos = torch.tensor(MOUNT_GOAL_POS if goal else (0.0, 0.0, 0.0),
                          device=device).expand(n_env, 3).clone()
  return _terrain(*_no_boxes(n_env, device), goal_pos=goal_pos,
                  field=_field(grid, _MOUNT_CELL, [origin, origin]))


def gen_mount(gen: torch.Generator, n_env: int, device,
              moving: bool = False) -> TerrainState:
  del gen, moving
  return mount_state(n_env, device, goal=True)


def gen_random_mount(gen: torch.Generator, n_env: int, device,
                     moving: bool = False) -> TerrainState:
  del gen, moving
  return mount_state(n_env, device, goal=False)


def gen_triangle_mesh(gen: torch.Generator, n_env: int, device,
                      moving: bool = False) -> TerrainState:
  """triangle_mesh (JAX `gen_triangle_mesh`, terrain.py:789-804): the
  reference's terrain9735.obj at mesh scale (0.6, 0.3, 0.2), rasterized
  into assets/terrain9735_hf.npz by the JAX package."""
  del gen, moving
  data = load_asset("terrain9735_hf.npz")
  grid = _shared_grid(data["height"], n_env, device)
  return _terrain(*_no_boxes(n_env, device),
                  field=_field(grid, float(data["cell"][0]),
                               data["origin"].tolist()))


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
  return _terrain(
      torch.cat([wide, _pillars(centers), _fences(n_env, dev)], dim=1),
      dirs, subgoals=subgoals)


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


NUM_OBSTACLE_SPHERES = 50


def draw_spheres(gen, n_env, device):
  """The sphere terrain's draws: the sphere centers (E, 50, 2) in
  [2, -3] .. [16, 3], then the subgoals (E, 50, 2)."""
  centers = _uniform(gen, (n_env, NUM_OBSTACLE_SPHERES, 2), (2.0, -3.0),
                     (16.0, 3.0), device)
  subgoals = _uniform(gen, (n_env, NUM_SUBGOALS, 2), (2.0, -2.2),
                      (30.0, 2.2), device)
  return centers, subgoals


def spheres_state(centers, subgoals) -> TerrainState:
  """random_sphere_with_subgoal from its draws (JAX
  `gen_spheres_with_subgoal`, terrain.py:636-650; the reference's
  `_generate_spheres_and_subgoal` :1249-1310): spheres [x, y, z, r,
  valid] of radius 0.2 at z 0.2 over centers (E, Q, 2), no boxes, the
  subgoals (E, 50, 2)."""
  n_env, n, _ = centers.shape
  dev = centers.device
  spheres = torch.cat([
      centers, torch.full((n_env, n, 2), SUBGOAL_RADIUS, device=dev),
      torch.ones(n_env, n, 1, device=dev)], dim=-1)
  return _terrain(*_no_boxes(n_env, dev), subgoals=subgoals,
                  spheres=spheres)


def gen_spheres_with_subgoal(gen: torch.Generator, n_env: int, device,
                             moving: bool = False) -> TerrainState:
  """random_sphere_with_subgoal: 50 obstacle spheres on flat ground and
  50 subgoals (no boxes, so `moving` moves nothing)."""
  del moving
  return spheres_state(*draw_spheres(gen, n_env, device))


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
    "random_blocks": gen_random_blocks,
    "random_blocks_sparse": gen_blocks_sparse,
    "random_blocks_sparse_with_subgoal": gen_blocks_sparse,
    "random_blocks_sparse_thin_wide": gen_thin_wide,
    "random_blocks_sparse_and_heightfield": gen_blocks_sparse_heightfield,
    "random_blocks_sparse_with_subgoal_heightfield":
        gen_blocks_sparse_heightfield,
    "random_heightfield": gen_random_heightfield,
    "stairs": gen_stairs,
    "multi_stairs": gen_multi_stairs,
    "random_sphere_with_subgoal": gen_spheres_with_subgoal,
    "random_chair_desk": gen_chair_desk,
    "random_hill": gen_hill,
    "random_mount": gen_random_mount,
    "mount": gen_mount,
    "triangle_mesh": gen_triangle_mesh,
}

# camera frustum-prune cap per terrain (see camera.render_depth)
RENDER_BOX_CAPS = {
    "random_blocks_sparse": 16,
    "random_blocks_sparse_with_subgoal": 16,
    "random_blocks_sparse_thin_wide": 16,
    "random_blocks_sparse_and_heightfield": 16,
    "random_blocks_sparse_with_subgoal_heightfield": 16,
    "random_chair_desk": 24,
}

# terrains whose ground is the flat z=0 plane: they take the physics
# window (the JAX package's Pallas kernel path); the others step through
# the per-env engine on their heightfields
FLAT_TERRAINS = frozenset([
    "plane", "random_blocks", "random_blocks_sparse",
    "random_blocks_sparse_with_subgoal", "random_blocks_sparse_thin_wide",
    "stairs", "multi_stairs", "random_sphere_with_subgoal",
    "random_chair_desk",
])

# per-type init pose (QUADRUPED_INIT_POSITION, a1_randomizer_ground.py:286);
# the env places the settled template's height above the local ground and
# ignores the z here, as the JAX env does
INIT_POSITION = {
    "plane": (0, 0, 0.32),
    "random_blocks": (0, 0, 0.32),
    "random_blocks_sparse": (0, 0, 0.32),
    "random_heightfield": (0, 0, 0.32),
    "stairs": (-0.15, 0, 0.32),
    "random_blocks_sparse_and_heightfield": (0, 0, 0.32),
    "random_blocks_sparse_with_subgoal_heightfield": (0, 0, 0.32),
    "random_blocks_sparse_with_subgoal": (0, 0, 0.32),
    "random_blocks_sparse_thin_wide": (0, 0, 0.32),
    "random_hill": (0, 0, 2.25),
    "multi_stairs": (1.0, 0, 0.42),
    "random_sphere_with_subgoal": (0, 0, 0.32),
    "random_chair_desk": (0, 0, 0.32),
    "mount": (1, 1, 1.56),
    "random_mount": (1, 1, 1.56),
    "triangle_mesh": (0, 0, 0.45),
}
