"""Parity of the port's heightfield terrains, generators and heightfield
camera march (vision4leg_torch.envs.terrain / camera) with the JAX
package's, on the CPU.

Heights and normals: the JAX package queries up to 512 points as a
one-hot hat-weight einsum (its contact path) and more as a 4-corner
gather (its camera path); the port always gathers.  Both paths are held,
heights within 2e-6 m and unit normals within 1e-5: the einsum's weights
and sum order round differently, by ~1e-7 of heights below 2 m, and a
normal's central difference divides that by 2 cells.

Generators: the JAX draws (recomputed from the generators' keys) go
through the port's state-from-draws functions; boxes, directions,
subgoals and grids are bit-equal, except the hill's sum of 40 gaussian
bumps (the port adds one bump at a time, XLA reduces in its own order):
within 1e-6 m; and two sizes that XLA's CPU compiler rounds differently
from the written arithmetic (it fuses multiply-adds and turns a division
by a constant into a product): multi_stairs' slab heights -0.2 + level *
(0.05 + noise) and random_blocks' half sides side / (2 sqrt 2), within
1e-8 m.

The march: a 1-ulp height difference can move the first sample below
ground by one 0.19 m step on a grazing ray, so depths are compared ray by
ray: within 1e-4 m on all but a counted few rays (at most 0.5 %), which
may part by up to one step.
"""
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import camera as jcam
from vision4leg_tpu.envs import env as jenv_mod
from vision4leg_tpu.envs import terrain as jterr
from vision4leg_tpu.physics import maths as jmaths
from vision4leg_torch import convert
from vision4leg_torch.envs import camera as tcam
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.physics import maths as tmaths

E = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H_TOL, N_TOL = 2e-6, 1e-5
RAY_TOL, RAY_SHARE = 1e-4, 0.005
STEP = (10.5 - 0.05) / 55          # the march's step at far_t 10.5


def _np_tree(x):
  return jax.tree.map(np.asarray, x)


def _keys(seed, n=E):
  return jax.random.split(jax.random.PRNGKey(seed), n)


@pytest.fixture(scope="module")
def grids():
  """A hill and a random-heightfield batch, generated by the JAX package."""
  return {name: _np_tree(jax.jit(jax.vmap(jterr.TERRAIN_GENERATORS[name]))(
      _keys(seed)))
      for name, seed in (("random_hill", 1), ("random_heightfield", 2))}


def _queries(ts, n, rng):
  """n query points per env over the grid and up to 2 m past its edge,
  with non-finite ones (a diverged env's) in the first env."""
  ext = ts.hf_origin[:, None] + ts.height.shape[1] * ts.hf_cell[:, None,
                                                                 None]
  lo = ts.hf_origin[:, None] - 2.0
  xy = (lo + (ext + 2.0 - lo) * rng.uniform(size=(E, n, 2))).astype(
      np.float32)
  xy[0, :4] = [[np.nan, 0.0], [np.inf, 1.0], [-np.inf, np.nan], [1e30, 0.0]]
  return xy


@pytest.mark.parametrize("n", [300, 2000])     # the JAX einsum / gather path
@pytest.mark.parametrize("name", ["random_hill", "random_heightfield"])
def test_heights_and_normals_match_jax(grids, name, n):
  ts = grids[name]
  xy = _queries(ts, n, np.random.default_rng(n))

  def jfns(t, q):
    h, nrm = jterr.heightfield_fns(t)
    return h(q), nrm(q)

  jh, jn = jax.jit(jax.vmap(jfns))(jax.tree.map(jnp.asarray, ts),
                                   jnp.asarray(xy))
  h, nrm = tterr.heightfield_fns(convert.terrain(ts))
  th, tn = h(torch.tensor(xy)), nrm(torch.tensor(xy))
  assert th.shape == (E, n) and tn.shape == (E, n, 3)
  assert torch.isfinite(th).all() and torch.isfinite(tn).all()
  np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=H_TOL)
  np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=N_TOL)
  assert float(np.ptp(np.asarray(jh))) > 0.05          # not a flat query


def test_out_of_range_queries_read_the_clipped_grid(grids):
  """Non-finite coordinates read index 0, out-of-range ones the clipped
  edge: in bounds on every env, so the card's gather cannot fault."""
  terrain = convert.terrain(grids["random_hill"])
  h, _ = tterr.heightfield_fns(terrain)
  o, c = terrain.hf_origin, terrain.hf_cell[:, None]
  n = terrain.height.shape[1]
  corner = o + (n - 1.001) * c
  xy = torch.stack([
      torch.full_like(o, float("nan")), o - 50.0, o + 1e9,
      torch.stack([torch.full_like(o[:, 0], float("inf")), o[:, 1]], -1),
      corner], dim=1)
  got = h(xy)
  g = terrain.height
  at_corner = (0.001 * g[:, -2, -2] + 0.999 * g[:, -1, -2]) * 0.001 + (
      0.001 * g[:, -2, -1] + 0.999 * g[:, -1, -1]) * 0.999
  np.testing.assert_allclose(got[:, 0], g[:, 0, 0], atol=1e-7)
  np.testing.assert_allclose(got[:, 1], g[:, 0, 0], atol=1e-7)
  np.testing.assert_allclose(got[:, 2], at_corner, atol=1e-6)
  np.testing.assert_allclose(got[:, 3], g[:, 0, 0], atol=1e-7)
  np.testing.assert_allclose(got[:, 4], at_corner, atol=1e-6)


@functools.cache
def _jitted(fn):
  return jax.jit(jax.vmap(fn))


def _jax_gen(fn, keys):
  """The JAX generator `fn` on `keys`, one compile per generator and
  shape in this file."""
  return _np_tree(_jitted(fn)(keys))


def _t(x):
  return torch.tensor(np.asarray(x))


def _assert_terrain_equal(got, want, grid_atol=0.0, box_atol=0.0):
  np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=0,
                             atol=box_atol)
  for f in ("box_dirs", "subgoals", "goal_pos", "hf_cell", "hf_origin",
            "hf_zoff"):
    np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f),
                                  err_msg=f)
  if grid_atol:
    np.testing.assert_allclose(got.height.numpy(), want.height,
                               atol=grid_atol)
  else:
    np.testing.assert_array_equal(got.height.numpy(), want.height)
  assert got.box_dirs.dtype == torch.int32


def test_random_heightfield_from_jax_draws():
  keys = _keys(3)
  want = _jax_gen(jterr.gen_random_heightfield, keys)
  heights = _t(jax.vmap(lambda k: jax.random.uniform(
      k, (128, 128), minval=0.0, maxval=0.1))(keys))
  got = tterr.random_heightfield_state(heights)
  _assert_terrain_equal(got, want)
  assert got.height.shape == (E, 256, 256)
  assert (got.height[:, 118:138, 118:138] == 0).all()     # the flat centre


def test_sparse_and_heightfield_from_jax_draws():
  """random_blocks_sparse_and_heightfield: the pillars, the subgoals and
  the raw directions (split(key, 4)[0], folded in 7) and the heightfield
  (split(key, 4)[2])."""
  keys = _keys(4)
  want = _jax_gen(jterr.TERRAIN_GENERATORS[
      "random_blocks_sparse_and_heightfield"], keys)
  split = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
  heights = _t(jax.vmap(lambda k: jax.random.uniform(
      k, (128, 128), minval=0.0, maxval=0.1))(split[:, 2]))
  dirs = _t(jax.vmap(lambda k: jax.random.randint(
      jax.random.fold_in(k, 7), (52,), 0, 20))(split[:, 0]))
  got = tterr.blocks_sparse_state(_t(want.boxes[:, :50, :2]),
                                  _t(want.subgoals), dirs, heights)
  _assert_terrain_equal(got, want)


def test_hill_from_jax_draws():
  keys = _keys(5)
  want = _jax_gen(jterr.gen_hill, keys)

  def draws(k):
    ks = jax.random.split(k, 3)
    return (jax.random.uniform(ks[0], (40, 2), minval=-11.0, maxval=11.0),
            jax.random.uniform(ks[1], (40,), minval=1.6, maxval=4.0),
            jax.random.uniform(ks[2], (40,), minval=0.3, maxval=1.0))

  got = tterr.hill_state(*map(_t, jax.vmap(draws)(keys)))
  _assert_terrain_equal(got, want, grid_atol=1e-6)
  assert float(got.height.max()) > 0.3


def test_flat_challenge_generators_from_jax_draws():
  """stairs, multi_stairs, random_blocks and random_chair_desk, bit-equal
  on the JAX draws; chair_desk's own draws keep 1.1 m apart."""
  _assert_terrain_equal(tterr.stairs_state(E, "cpu"),
                        _jax_gen(jterr.gen_stairs, _keys(6)))

  keys = _keys(7, 8)

  def ms_draws(k):
    k1, k2, k3 = jax.random.split(k, 3)
    return (jax.random.randint(k1, (), 1, 6),
            jax.random.uniform(k2, (5,), minval=-4.0, maxval=4.0),
            jax.random.uniform(k3, (5,), minval=-0.01, maxval=0.01))

  want = _jax_gen(jterr.gen_multi_stairs, keys)
  num, noise, h_noise = map(_t, jax.vmap(ms_draws)(keys))
  _assert_terrain_equal(tterr.multi_stairs_state(num, noise, h_noise), want,
                        box_atol=1e-8)
  assert len(set(num.tolist())) > 1

  keys = _keys(8)

  def rb_draws(k):
    k1, k2, k3 = jax.random.split(k, 3)
    return (jax.random.uniform(k1, (20, 2), minval=jnp.array([0.0, -0.5]),
                               maxval=jnp.array([5.0, 0.5])),
            jax.random.uniform(k2, (20,), minval=0.1, maxval=0.2),
            jax.random.uniform(k3, (20,), minval=0.0375, maxval=0.075))

  want = _jax_gen(jterr.gen_random_blocks, keys)
  _assert_terrain_equal(
      tterr.random_blocks_state(*map(_t, jax.vmap(rb_draws)(keys))), want,
      box_atol=1e-8)

  want = _jax_gen(jterr.gen_chair_desk, _keys(9))
  _assert_terrain_equal(tterr.chair_desk_state(_t(want.boxes[:, :80, :2])),
                        want)
  own = tterr.gen_chair_desk(torch.Generator().manual_seed(0), 2, "cpu")
  c = own.boxes[:, :80, :2]
  assert float((torch.cdist(c, c) + torch.eye(80) * 10).min()) >= 1.1 - 1e-5


def test_fixed_grids_and_assets_match_jax():
  """mount / random_mount and triangle_mesh: the port's asset copies are
  byte-equal to the JAX package's, and the grids bit-equal."""
  for name in ("mount_hf.npz", "terrain9735_hf.npz"):
    assert filecmp.cmp(os.path.join(ROOT, "vision4leg_tpu", "assets", name),
                       os.path.join(ROOT, "vision4leg_torch", "assets", name),
                       shallow=False), name
  for name in ("mount", "random_mount", "triangle_mesh"):
    want = _jax_gen(jterr.TERRAIN_GENERATORS[name], _keys(10, 2))
    got = tterr.TERRAIN_GENERATORS[name](torch.Generator(), 2, "cpu")
    _assert_terrain_equal(got, want)
  assert tterr.INIT_POSITION["triangle_mesh"] == (0, 0, 0.45)


def test_missing_asset_raises(monkeypatch, tmp_path):
  monkeypatch.setattr(tterr, "ASSETS", str(tmp_path))
  with pytest.raises(FileNotFoundError, match="no stand-in"):
    tterr.gen_mount(torch.Generator(), 1, "cpu")


def _compare_rays(got, want, label):
  """Depths per ray: all but a counted share within RAY_TOL, none beyond
  one march step; returns the count beyond RAY_TOL."""
  diff = np.abs(np.where(np.isfinite(want), want, 1e3)
                - np.where(np.isfinite(got), got, 1e3))
  off = diff > RAY_TOL
  assert off.mean() <= RAY_SHARE, (label, int(off.sum()), diff.max())
  assert diff.max() <= STEP * 1.01, (label, diff.max())
  print(f"{label}: {int(off.sum())} of {off.size} rays beyond {RAY_TOL} m, "
        f"max {diff.max():.3g} m")
  return int(off.sum())


def test_march_and_nonflat_render_match_jax():
  """The march alone and a full non-flat render (64 x 64) on two envs: the
  heightfield corridor (random bumps, the 16 nearest pillars and the
  fences, subgoals shown) and the real mount (its slopes; the corridor's
  boxes made invalid), one JAX compile for both."""
  ts = jax.tree.map(lambda x: np.array(x[:2]), _jax_gen(
      jterr.TERRAIN_GENERATORS["random_blocks_sparse_and_heightfield"],
      _keys(4)))
  mount = _jax_gen(jterr.TERRAIN_GENERATORS["mount"], _keys(10, 2))
  for f in ("height", "hf_cell", "hf_origin", "hf_zoff"):
    getattr(ts, f)[1] = getattr(mount, f)[1]
  ts.boxes[1, :, 7] = 0.0
  pos = np.array([[1.5, 0.2, 0.3], [1.0, 1.0, 1.75]], np.float32)
  quat = np.asarray(jmaths.rpy_to_quat(jnp.asarray(
      [[0.05, -0.5, 0.2], [0.0, -0.3, 1.2]])))

  def jboth(t, p, q):
    h_fn, _ = jterr.heightfield_fns(t)
    rot = jmaths.quat_to_mat(q)
    eye, dirs = jcam.camera_rays(p, rot)
    return (jcam._ray_heightfield_t(eye, dirs, h_fn, far_t=10.5),
            jcam.render_depth(p, rot, t, h_fn, False, show_subgoals=True,
                              max_boxes=16, far_t=20.0))

  jt, jdepth = map(np.asarray, jax.jit(jax.vmap(jboth))(
      jax.tree.map(jnp.asarray, ts), jnp.asarray(pos), jnp.asarray(quat)))
  terrain = convert.terrain(ts)
  rot = tmaths.quat_to_mat(torch.tensor(quat))
  eye, dirs = tcam.camera_rays(torch.tensor(pos), rot)
  tt = tcam._ray_heightfield_t(eye, dirs, tterr.heightfield_fns(terrain)[0],
                               far_t=10.5).numpy()
  tdepth = tcam.render_depth(torch.tensor(pos), rot, terrain,
                             show_subgoals=True, max_boxes=16, flat=False,
                             far_t=20.0).numpy()
  assert np.isfinite(jt).mean() > 0.5                   # the ground is seen
  np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(jt))
  _compare_rays(tt, jt, "march")
  assert tdepth.shape == jdepth.shape == (2, 64, 64)
  for e in range(2):
    assert np.ptp(jdepth[e][jdepth[e] < 20]) > 1.0     # a varied image
  _compare_rays(tdepth, jdepth, "render")


class _NearBoxes:
  NEAR_BOXES = 8


def test_pruned_boxes_break_ties_as_jax():
  """multi_stairs: the base xy inside more than NEAR_BOXES slabs (surface
  distance 0 to each); the port keeps the JAX set, lower index first."""
  keys = _keys(13, 32)
  boxes = _jax_gen(jterr.gen_multi_stairs, keys).boxes
  b = np.asarray(boxes)
  # each env's base x where the most valid slabs contain it
  xs = np.linspace(0.0, 40.0, 801, dtype=np.float32)
  count = ((np.abs(xs[None, :, None] - b[:, None, :, 0]) <= b[:, None, :, 3])
           & (b[:, None, :, 7] > 0.5)).sum(-1)
  xy = np.stack([xs[count.argmax(1)], np.linspace(-3, 3, 32)], -1).astype(
      np.float32)
  want = np.asarray(jax.jit(jax.vmap(
      lambda b, p: jenv_mod.A1GymEnv._pruned_boxes(_NearBoxes(), b, p)))(
          jnp.asarray(boxes), jnp.asarray(xy)))
  tb = torch.tensor(np.asarray(boxes))
  got = tenv_mod.A1GymEnv._pruned_boxes(_NearBoxes(), tb, torch.tensor(xy))
  inside = ((np.abs(xy[:, None, 0] - np.asarray(boxes)[..., 0])
             <= np.asarray(boxes)[..., 3])
            & (np.asarray(boxes)[..., 7] > 0.5)).sum(-1)
  assert (inside > 8).sum() >= 4, inside
  np.testing.assert_array_equal(got.numpy(), want)
