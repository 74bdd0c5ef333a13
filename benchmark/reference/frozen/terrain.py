"""Terrain state and the moving obstacles' step (torch mirror of
vision4leg_tpu.envs.terrain), cut to what the benchmark's env reference
reads: the state's fields, the per-step displacement of the moving boxes
(`moving_blocks_step`), the flat terrains, their init poses and the
camera's box caps.  The generators are not here: the reference takes each
reset's terrain from the program's draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_SPARSE_BLOCKS = 50
SUBGOAL_RADIUS = 0.2
NUM_DIRECTIONS = 20

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


# camera frustum-prune cap per terrain (see camera.render_depth)
RENDER_BOX_CAPS = {
    "random_blocks_sparse": 16,
    "random_blocks_sparse_with_subgoal": 16,
    "random_blocks_sparse_thin_wide": 16,
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

# per-type init pose of the flat terrains (QUADRUPED_INIT_POSITION,
# a1_randomizer_ground.py:286); the env places the settled template's
# height above the local ground and ignores the z here, as the JAX env does
INIT_POSITION = {
    "plane": (0, 0, 0.32),
    "random_blocks": (0, 0, 0.32),
    "random_blocks_sparse": (0, 0, 0.32),
    "stairs": (-0.15, 0, 0.32),
    "random_blocks_sparse_with_subgoal": (0, 0, 0.32),
    "random_blocks_sparse_thin_wide": (0, 0, 0.32),
    "multi_stairs": (1.0, 0, 0.42),
    "random_sphere_with_subgoal": (0, 0, 0.32),
    "random_chair_desk": (0, 0, 0.32),
}
