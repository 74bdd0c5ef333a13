"""The port's own samplers against the JAX package's distributions, on
the CPU.

Every env parity test replays the JAX draws into the port's env; this file
holds the samplers the port really runs (`A1GymEnv.draw_for_reset`,
`draw_step`, `dynamics_rando.sample_dynamics`, the terrain draws,
`wrappers.draw_dir_angle`, `camera.preprocess_depth`'s blind spots) to the
distributions of the JAX env's own reset and step.

Per config, N envs: the port draws from a seeded torch.Generator; the JAX
env resets N envs (jit of vmap over fixed keys; its standing settle cut
and its camera off but where the step's frame head needs it: neither
draws) and, where the config draws in its step, steps them once (four
times for random_dir's redraw) with its physics window replaced by the
identity (the step's draws come before and after it); the blind spots
are painted by each package's `preprocess_depth` on a zero image.
Each randomized quantity is compared two ways:
- support: every port sample lies inside the bounds the JAX code draws
  from (`BOUNDS`, with the file and line), and an integer draw takes the
  same set of values in both packages;
- shape: a two-sample Kolmogorov-Smirnov statistic below KS_CRIT, the
  asymptotic critical value at alpha = 0.001 for N against N samples
  (a quantity with several values an env, all of them, but N counted:
  its values within an env need not be independent).
The seeds are fixed, so the result is deterministic.
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import camera as jcam
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_tpu.robots import a1 as ja1
from vision4leg_torch.envs import camera as tcam
from vision4leg_torch.envs.get_env import get_env as torch_get_env

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 512
KS_CRIT = 1.95 * math.sqrt(2.0 / N)      # alpha = 0.001, N against N
HALF_PI = math.pi / 2

CONFIGS = {
    # the main path
    "thin-goal": ("config/rl/static/locotransformer/thin-goal.json", {}),
    # the MMDR moving run's config, each step's frame head switched on
    "mmdr-moving": (
        "config/rl/moving/frame_extract4_random_delay/thin-goal.json",
        {"reset_frame_idx_each_step": True}),
    # spheres with random_dir (chip_smoke.py's phases 25-26)
    "spheres-random-dir": (
        "config/rl/static/locotransformer/thin-goal.json",
        {"terrain_type": "random_sphere_with_subgoal", "random_dir": True,
         "dir_update_interval": 5}),
}
DIR_STEPS = 4     # reset count 1: the 4th step's count 5 redraws

# (low, high) of each quantity as the JAX code draws it; integers
# inclusive at both ends
BOUNDS = {
    # vision4leg_tpu/envs/dynamics_rando.py:30-53
    "kp": (50.0, 70.0), "kd": (0.4, 0.8), "strength": (0.8, 1.2),
    "motor_friction": (0.0, 0.05), "joint_friction": (0.0, 0.05),
    "latency": (0.0, 0.04), "lateral_friction": (0.5, 1.25),
    "base_mass": (0.8, 1.2), "leg_mass": (0.8, 1.2),
    "base_inertia": (0.5, 1.5), "leg_inertia": (0.5, 1.5),
    # envs/env.py:298-302, random_init_range 1
    "jitter_x": (-1.0, 1.0), "jitter_y": (-1.0, 1.0),
    # envs/terrain.py:285 (pillars), :320-322 (subgoals), :641-642 (spheres)
    "pillar_x": (2.5, 28.5), "pillar_y": (-3.0, 3.0),
    "pillar_min_gap": (1.0, math.inf),
    "subgoal_x": (2.0, 30.0), "subgoal_y": (-2.2, 2.2),
    "sphere_x": (2.0, 16.0), "sphere_y": (-3.0, 3.0),
    # envs/terrain.py:327-328 (reset), :716 (the flip's redraw)
    "reset_dirs": (0, 19), "step_dirs": (0, 19),
    # envs/env.py:322-323 (frame k: k fe + [0, fe)), :552 (head)
    "frame_0": (0, 3), "frame_1": (4, 7), "frame_2": (8, 11),
    "frame_3": (12, 15), "frame_head": (1, 3),
    # envs/camera.py:275-276: 3 <= num < 30 spots, (row, col) in [0, 64)
    "blind_num": (3, 29), "blind_painted": (1, 29),
    "blind_row": (0, 63), "blind_col": (0, 63),
    # envs/env.py:334-336 (reset), :543-544 (redraw)
    "reset_dir_angle": (-HALF_PI, HALF_PI),
    "step_dir_angle": (-HALF_PI, HALF_PI),
}
INTEGER = {"reset_dirs", "step_dirs", "frame_0", "frame_1", "frame_2",
           "frame_3", "frame_head", "blind_num", "blind_painted",
           "blind_row", "blind_col"}
# quantities each config draws (blind_num: the port's draw alone, the
# JAX number is seen through the painted pixels)
COMMON = ("kp", "kd", "strength", "motor_friction", "joint_friction",
          "latency", "lateral_friction", "base_mass", "leg_mass",
          "base_inertia", "leg_inertia", "jitter_x", "jitter_y",
          "subgoal_x", "subgoal_y", "blind_painted", "blind_row",
          "blind_col")
QUANTITIES = {
    "thin-goal": COMMON + ("pillar_x", "pillar_y", "pillar_min_gap"),
    "mmdr-moving": COMMON + ("pillar_x", "pillar_y", "pillar_min_gap",
                             "reset_dirs", "step_dirs", "frame_0",
                             "frame_1", "frame_2", "frame_3",
                             "frame_head"),
    "spheres-random-dir": COMMON + ("sphere_x", "sphere_y",
                                    "reset_dir_angle", "step_dir_angle"),
}
CASES = [(c, q) for c in CONFIGS for q in QUANTITIES[c]]


def _params(name):
  path, overrides = CONFIGS[name]
  with open(os.path.join(ROOT, path)) as f:
    params = json.load(f)
  params["env"]["env_build"].update(overrides)
  return params


def _dyn(d):
  """The dynamics quantities of (E, ...) arrays of a DynamicsParams."""
  a = lambda x: np.asarray(x, np.float64)
  return {"kp": a(d.kp)[:, 0], "kd": a(d.kd)[:, 0],
          "strength": a(d.strength_ratios),
          "motor_friction": a(d.motor_friction),
          "joint_friction": a(d.joint_friction),
          "latency": a(d.control_latency),
          "lateral_friction": a(d.lateral_friction),
          "base_mass": a(d.mass_scale)[:, 0],
          "leg_mass": a(d.mass_scale)[:, 1],
          "base_inertia": a(d.inertia_scale)[:, 0],
          "leg_inertia": a(d.inertia_scale)[:, 1]}


def _terrain(t, n_pillars=50):
  """The terrain quantities of (E, ...) arrays of a TerrainState, and the
  boxes' and spheres' constant columns (sizes, heights, fences)."""
  boxes = np.asarray(t.boxes, np.float64)
  sub = np.asarray(t.subgoals, np.float64)
  out = {"subgoal_x": sub[..., 0], "subgoal_y": sub[..., 1]}
  const = {"box_constants": np.round(boxes[:, :, 2:], 6),
           "fences": np.round(boxes[:, n_pillars:], 6)}
  if boxes.shape[1] >= n_pillars:
    xy = boxes[:, :n_pillars, :2]
    out["pillar_x"], out["pillar_y"] = xy[..., 0], xy[..., 1]
    d = np.linalg.norm(xy[:, :, None] - xy[:, None], axis=-1)
    d[:, np.arange(n_pillars), np.arange(n_pillars)] = np.inf
    out["pillar_min_gap"] = d.min(axis=(1, 2))
    dirs = np.asarray(t.box_dirs)
    out["reset_dirs"] = dirs[:, :n_pillars]
    const["fence_dirs"] = dirs[:, n_pillars:]
  sph = np.asarray(t.obstacle_spheres, np.float64)
  if sph.shape[1]:
    out["sphere_x"], out["sphere_y"] = sph[..., 0], sph[..., 1]
    const["sphere_constants"] = np.round(sph[..., 2:], 6)
  return out, const


def _painted(depth):
  """Per env: the painted pixels' count, rows and columns of an
  image that `preprocess_depth` made from zeros (painted = depth 10)."""
  hit = np.asarray(depth) > 1.0
  rows, cols = np.nonzero(hit)[1:]
  return {"blind_painted": hit.sum(axis=(1, 2)), "blind_row": rows,
          "blind_col": cols}


def _port_draws(name):
  params = _params(name)
  env, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  gen = torch.Generator().manual_seed(19)
  draws, frame_draws = env.draw_for_reset(N, gen)
  step = env.draw_step(N, draws.terrain.boxes.shape[1], gen)
  out = _dyn(draws.dyn)
  jitter = draws.init_jitter.double().numpy()
  out.update(jitter_x=jitter[:, 0], jitter_y=jitter[:, 1])
  terrain, const = _terrain(draws.terrain)
  out.update(terrain)
  frame_idx, _ = env._frame_idx(N, frame_draws)
  for k in range(4):
    out[f"frame_{k}"] = frame_idx[:, k].numpy()
  if step.frame_head is not None:
    out["frame_head"] = step.frame_head.numpy()
  if step.move_dirs is not None:
    out["step_dirs"] = step.move_dirs[:, :50].numpy()
  if draws.dir_angle is not None:
    out["reset_dir_angle"] = draws.dir_angle.double().numpy()
    out["step_dir_angle"] = step.dir_angle.double().numpy()
  out["blind_num"] = torch.cat([draws.blind.num, step.blind.num]).numpy()
  zero = torch.zeros(N, tcam.IMG_SIZE, tcam.IMG_SIZE)
  out.update(_painted(tcam.preprocess_depth(zero, draws.blind.num,
                                            draws.blind.idx)))
  return out, const


def _jax_draws(name):
  params = _params(name)
  env, _ = jax_get_env(params["env_name"], params["env"])
  # the standing settle places the robot and the camera renders: neither
  # draws (the frame heads are drawn only with the camera on)
  env.cfg = dataclasses.replace(
      env.cfg, settle_steps=1,
      get_image=env.cfg.get_image and env.cfg.reset_frame_idx_each_step)
  keys = jax.random.split(jax.random.PRNGKey(19), N)
  states, _ = jax.jit(jax.vmap(env.reset))(keys)
  out = _dyn(states.dyn)
  jitter = np.asarray(states.robot.phys.pos[:, :2] - env._init_pos[:2],
                      np.float64)
  out.update(jitter_x=jitter[:, 0], jitter_y=jitter[:, 1])
  terrain, const = _terrain(states.terrain)
  out.update(terrain)
  frame_idx = np.asarray(states.frame_idx)
  for k in range(4):
    out[f"frame_{k}"] = frame_idx[:, k]
  out["reset_dir_angle"] = np.asarray(states.dir_angle, np.float64)
  depth = jax.vmap(lambda k: jcam.preprocess_depth(
      jnp.zeros((jcam.IMG_SIZE, jcam.IMG_SIZE)), k))(
          jax.random.split(jax.random.PRNGKey(20), N))
  out.update(_painted(depth))

  if not (env.cfg.moving or env.cfg.random_dir or env.cfg.get_image):
    return out, const
  # the step's draws, its physics window the identity
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(ja1, "robot_step", lambda model, rs, *a, **kw: (rs, None))
    step = jax.jit(jax.vmap(env.step))
    act = jnp.zeros((N, env.cfg.action_dim))
    after, *_ = step(states, act)
    if env.cfg.random_dir:
      for _ in range(DIR_STEPS - 1):
        after, *_ = step(after, act)
  out["frame_head"] = np.asarray(after.frame_idx)[:, 0]
  # the first step's counter (0) flips: a box whose direction is >= 4
  # takes the redraw (envs/terrain.py:714-717)
  reset_dirs = np.asarray(states.terrain.box_dirs)[:, :50]
  out["step_dirs"] = np.asarray(after.terrain.box_dirs)[:, :50][
      reset_dirs >= 4]
  out["step_dir_angle"] = np.asarray(after.dir_angle, np.float64)
  return out, const


_CACHE = {}


def _draws(config):
  """(port quantities, port constants), (JAX ...), computed once a
  config."""
  if config not in _CACHE:
    _CACHE[config] = (_port_draws(config), _jax_draws(config))
  return _CACHE[config]


def ks_statistic(a, b) -> float:
  """The two-sample Kolmogorov-Smirnov statistic: the largest distance
  between the two empirical distribution functions."""
  a, b = np.sort(np.ravel(a)), np.sort(np.ravel(b))
  x = np.concatenate([a, b])
  fa = np.searchsorted(a, x, side="right") / a.size
  fb = np.searchsorted(b, x, side="right") / b.size
  return float(np.max(np.abs(fa - fb)))


# the uniform integer draws: both packages take every value of the range
COVERED = INTEGER - {"blind_painted"}


@pytest.mark.parametrize("config,quantity", CASES + [
    (c, "blind_num") for c in CONFIGS])
def test_port_draws_lie_in_the_jax_bounds(config, quantity):
  (port, _), (jx, _) = _draws(config)
  x = np.asarray(port[quantity], np.float64)
  lo, hi = BOUNDS[quantity]
  assert x.size and lo <= x.min() and x.max() <= hi, (
      quantity, x.min(), x.max(), (lo, hi))
  if quantity in INTEGER:
    assert np.array_equal(x, np.round(x))
  if quantity in COVERED:
    values = set(np.unique(x).astype(int).tolist())
    assert values == set(range(int(lo), int(hi) + 1)), (quantity, values)
  if quantity in jx:
    y = np.asarray(jx[quantity], np.float64)
    assert lo <= y.min() and y.max() <= hi, (quantity, y.min(), y.max())
    if quantity in COVERED:
      assert set(np.unique(y).astype(int).tolist()) == values


@pytest.mark.parametrize("config,quantity", CASES)
def test_port_draws_match_the_jax_distribution(config, quantity):
  (port, _), (jx, _) = _draws(config)
  d = ks_statistic(port[quantity], jx[quantity])
  assert d <= KS_CRIT, (quantity, d, KS_CRIT)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_constant_parts_of_the_draws_match(config):
  """What the draws leave fixed: the boxes' sizes and heights, the
  fences and their still direction, the spheres' radius and height."""
  (_, pc), (_, jc) = _draws(config)
  assert set(pc) == set(jc)
  for k in pc:
    a, b = pc[k], jc[k]
    assert a.shape == b.shape, k
    rows = lambda z: {tuple(r) for r in z.reshape(-1, z.shape[-1]).tolist()}
    assert rows(a) == rows(b), k


def test_the_ks_gate_refuses_a_shifted_bound():
  """The shape gate's power: kp drawn in [50, 75] instead of [50, 70]
  (one bound off by a quarter of the range) fails it at N envs."""
  (port, _), (jx, _) = _draws("thin-goal")
  shifted = 50.0 + (port["kp"] - 50.0) * 1.25
  assert ks_statistic(shifted, jx["kp"]) > KS_CRIT
