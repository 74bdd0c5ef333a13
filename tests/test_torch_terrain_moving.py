"""Parity of the port's sparse-family terrains and moving obstacles
(vision4leg_torch.envs.terrain) with the JAX package's, on the CPU, exact.

The generators' random draws (the pillar centers, the subgoals and the
raw moving directions) are taken from the JAX generator and injected
into the port's `blocks_sparse_state` / `thin_wide_state`; the
moving-obstacle step takes the JAX step's per-step direction draws.
Boxes, directions and subgoals are compared bit for bit: the port
repeats the JAX arithmetic (one float32 add of a table displacement
times a 0/1 mask per step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import terrain as jterr
from vision4leg_torch import convert
from vision4leg_torch.envs import terrain as tterr

E = 3
N_STEPS = 301          # direction flips at steps 0, 150 and 300


def _jax_terrain(name, keys):
  gen = jax.jit(jax.vmap(jterr.TERRAIN_GENERATORS[name]))
  return jax.tree.map(np.asarray, gen(keys))


def _raw_dirs(name, keys):
  """The JAX generators' directions before the fixed boxes are set:
  randint over fold_in(kb, 7), kb the first split of the key (in 4 for
  gen_blocks_sparse, in 2 for gen_thin_wide)."""
  n_split, n_boxes = ((2, 75) if name.endswith("thin_wide") else (4, 52))
  return torch.tensor(np.stack([np.asarray(jax.random.randint(
      jax.random.fold_in(jax.random.split(k, n_split)[0], 7), (n_boxes,),
      0, 20)) for k in keys]))


@pytest.mark.parametrize("name,build,first", [
    ("random_blocks_sparse_with_subgoal", tterr.blocks_sparse_state, 0),
    ("random_blocks_sparse", tterr.blocks_sparse_state, 0),
    ("random_blocks_sparse_thin_wide", tterr.thin_wide_state,
     tterr.NUM_WIDE_SLABS)])
def test_generator_matches_jax_on_its_draws(name, build, first):
  keys = jax.random.split(jax.random.PRNGKey(11), E)
  jt = _jax_terrain(name, keys)
  centers = torch.tensor(jt.boxes[:, first:first + tterr.NUM_SPARSE_BLOCKS,
                                  :2])
  got = build(centers, torch.tensor(jt.subgoals), _raw_dirs(name, keys))
  np.testing.assert_array_equal(got.boxes.numpy(), jt.boxes)
  np.testing.assert_array_equal(got.box_dirs.numpy(), jt.box_dirs)
  np.testing.assert_array_equal(got.subgoals.numpy(), jt.subgoals)
  assert got.box_dirs.dtype == torch.int32
  assert (got.box_dirs[:, -2:] == tterr.STILL_DIR).all()
  # the draws leave some pillars moving
  pillars = got.box_dirs[:, first:first + tterr.NUM_SPARSE_BLOCKS]
  assert (pillars != tterr.STILL_DIR).any()


def test_thin_wide_layout():
  """23 wide slabs, 50 pillars at least 1 m apart, 2 fences; the port's
  own draws, the directions drawn last and only for a moving env (a
  still env's are STILL_DIR, the rest of its terrain the same); the
  camera's box cap and the start pose registered."""
  t = tterr.gen_thin_wide(torch.Generator().manual_seed(0), E, "cpu",
                          moving=True)
  still = tterr.gen_thin_wide(torch.Generator().manual_seed(0), E, "cpu")
  assert torch.equal(still.boxes, t.boxes)
  assert torch.equal(still.subgoals, t.subgoals)
  assert (still.box_dirs == tterr.STILL_DIR).all()
  assert t.boxes.shape == (E, 75, 8) and t.box_dirs.shape == (E, 75)
  assert (t.box_dirs[:, :23] == tterr.STILL_DIR).all()
  assert (t.box_dirs[:, 23:73] != tterr.STILL_DIR).any()
  c = t.boxes[:, 23:73, :2]
  d = torch.cdist(c, c) + torch.eye(50) * 10
  assert float(d.min()) >= 1.0 - 1e-5
  assert int(t.box_dirs.min()) >= 0 and int(t.box_dirs.max()) < 20
  name = "random_blocks_sparse_thin_wide"
  assert tterr.RENDER_BOX_CAPS[name] == 16
  assert tterr.INIT_POSITION[name] == (0, 0, 0.32)


@pytest.mark.parametrize("name", ["random_blocks_sparse_thin_wide",
                                  "random_blocks_sparse_with_subgoal"])
def test_moving_blocks_step_matches_jax(name):
  keys = jax.random.split(jax.random.PRNGKey(2), E)
  jt = jax.vmap(jterr.TERRAIN_GENERATORS[name])(keys)
  tt = convert.terrain(jax.tree.map(np.asarray, jt))
  n_boxes = tt.boxes.shape[1]
  step = jax.jit(jax.vmap(
      lambda t, c, k: jterr.moving_blocks_step(t, c, k,
                                               jterr.NUM_SPARSE_BLOCKS)))
  draw = jax.jit(jax.vmap(lambda k: jax.random.randint(k, (n_boxes,), 0,
                                                       20)))
  start = tt.boxes.clone()
  flips = 0
  for i in range(N_STEPS):
    counter = np.full(E, i, np.int32)
    skeys = jax.random.split(jax.random.PRNGKey(1000 + i), E)
    before = tt.box_dirs.clone()
    jt = step(jt, jnp.asarray(counter), skeys)
    tt = tterr.moving_blocks_step(tt, torch.tensor(counter),
                                  torch.tensor(np.asarray(draw(skeys))))
    np.testing.assert_array_equal(tt.box_dirs.numpy(),
                                  np.asarray(jt.box_dirs), err_msg=str(i))
    flips += int((tt.box_dirs != before).any())
  np.testing.assert_array_equal(tt.boxes.numpy(), np.asarray(jt.boxes))
  moved = (tt.boxes[..., :2] - start[..., :2]).abs().amax(-1) > 0
  # only the first 50 boxes move: on thin-wide the 23 slabs (redrawn at
  # step 0) and 27 pillars; the other 23 pillars and the fences stay
  assert not moved[:, tterr.NUM_SPARSE_BLOCKS:].any()
  assert moved[:, :tterr.NUM_SPARSE_BLOCKS].float().mean() > 0.5
  assert flips == 3
