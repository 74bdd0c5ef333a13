"""Parity of the port's MMDR options and moving obstacles with the JAX
env on the CPU, at 4 envs over a reset and 5 steps.

Two configs: config/rl/moving/frame_extract4_random_delay/thin-wide.json
(a random frame delay per env and slot, moving boxes among the wide slabs
and pillars) and config/rl/static/frame_extract4_interpolation/
thin-goal.json with `reset_frame_idx_each_step` turned on in the test's
copy of its env_build (interpolated frames, and the head of the frame
indices redrawn every step).

The torch env replays the JAX env's draws as tests/test_torch_env.py
does: terrain, dynamics and start jitter from the JAX reset; the blind
spots, the frame delays, the moving directions and the per-step head
recomputed from the JAX states' keys (reset: split(key, 7) gives k_frame
at [3], k_interp at [4]; step: split(state.key, 3) gives k_move at [1],
k_frame at [2]).  The standing template is the JAX env's.

Tolerances: those of tests/test_torch_env.py (proprio 1e-5 at reset and
6e-3 after steps, depth image 1e-3, reward 2e-3, done exact).  The frame
indices, interpolation delays, moving directions and boxes are held
exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import _np_tree, _reset_blind, _step_blind
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_torch import convert
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs.get_env import get_env as torch_get_env

ROOT = os.path.join(os.path.dirname(__file__), "..", "config", "rl")
CONFIGS = {
    "moving-thin-wide": ("moving/frame_extract4_random_delay/thin-wide.json",
                         {}),
    "interp-each-step": ("static/frame_extract4_interpolation/thin-goal.json",
                         {"reset_frame_idx_each_step": True}),
}
E = 4
N_STEPS = 5


class MmdrReplayEnv(tenv_mod.A1GymEnv):
  """The torch env with its draws replaced by the JAX draws."""
  reset_draws = None
  frame_draws = None
  step_draws = ()

  def draw_reset(self, n_env, gen):
    return self.reset_draws

  def draw_frame_delays(self, n_env, gen):
    return self.frame_draws

  def draw_step(self, n_env, n_boxes, gen):
    return self.step_draws.pop(0)


def _ints(xs):
  return torch.tensor(np.stack([np.asarray(x) for x in xs]))


def _frame_draws(cfg, keys):
  fe = cfg.frame_extract
  ks = [jax.random.split(k, 7) for k in keys]
  offset = (_ints(jax.random.randint(k[3], (4,), 0, fe) for k in ks)
            if cfg.reset_frame_idx and not cfg.fixed_delay_observation
            else None)
  interp = (_ints(jax.random.randint(k[4], (), 0, fe) for k in ks)
            if cfg.interpolation else None)
  return tenv_mod.FrameDraws(offset, interp)


def _step_draws(cfg, state_keys, n_boxes):
  ks = [jax.random.split(k, 3) for k in state_keys]
  move = (_ints(jax.random.randint(k[1], (n_boxes,), 0, 20) for k in ks)
          if cfg.moving else None)
  head = (_ints(jax.random.randint(k[2], (), 1, cfg.frame_extract)
                for k in ks) if cfg.reset_frame_idx_each_step else None)
  return tenv_mod.StepDraws(tenv_mod.BlindSpots(*_step_blind(state_keys)),
                            move, head)


def _mmdr_fields(state):
  return {"frame_idx": np.asarray(state.frame_idx),
          "interp_delay": np.asarray(state.interp_delay),
          "box_dirs": np.asarray(state.terrain.box_dirs),
          "boxes": np.asarray(state.terrain.boxes)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def rollout(request):
  """Reset + N_STEPS steps of both envs on the same actions."""
  path, extra = CONFIGS[request.param]
  with open(os.path.join(ROOT, path)) as f:
    params = json.load(f)
  params["env"]["env_build"].update(extra)
  jenv, _ = jax_get_env(params["env_name"], params["env"])
  tenv, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  renv = MmdrReplayEnv(tenv.cfg, device="cpu")
  renv._template = convert.robot_state(_np_tree(jenv.settled_template()))
  cfg = renv.cfg

  keys = jax.random.split(jax.random.PRNGKey(4), E)
  jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
  js = _np_tree(jstate)
  init = np.asarray(tterr.INIT_POSITION[cfg.terrain_type], np.float32)
  renv.reset_draws = tenv_mod.ResetDraws(
      terrain=convert.terrain(js.terrain), dyn=convert.dynamics(js.dyn),
      init_jitter=torch.tensor(js.robot.phys.pos[:, :2] - init[:2]),
      blind=tenv_mod.BlindSpots(*_reset_blind(keys)))
  renv.frame_draws = _frame_draws(cfg, keys)
  gen = torch.Generator().manual_seed(0)
  tstate, tobs = renv.reset(E, gen)
  fields = [(_mmdr_fields(js), _mmdr_fields(tstate))]
  n_boxes = tstate.terrain.boxes.shape[1]

  rng = np.random.default_rng(1)
  lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
  jstep = jax.jit(jenv.step_batch)
  steps = []
  for _ in range(N_STEPS):
    act = (lo + (hi - lo) * rng.uniform(size=(E, 6))).astype(np.float32)
    renv.step_draws = [_step_draws(cfg, jstate.key, n_boxes)]
    jstate, jo, jr, jd, _ = jstep(jstate, jnp.asarray(act))
    tstate, to, tr, td, _ = renv.step_batch(tstate, torch.tensor(act), gen)
    steps.append(((np.asarray(jo), np.asarray(jr), np.asarray(jd)),
                  (to.numpy(), tr.numpy(), td.numpy())))
    fields.append((_mmdr_fields(_np_tree(jstate)), _mmdr_fields(tstate)))
  return request.param, cfg, (np.asarray(jobs), tobs.numpy()), steps, fields


def test_reset_obs_matches_jax(rollout):
  _, cfg, (jobs, tobs), _, _ = rollout
  p = cfg.proprio_dim
  assert tobs.shape == jobs.shape == (E, p + 4 * 64 * 64)
  np.testing.assert_allclose(tobs[:, :p], jobs[:, :p], atol=1e-5)
  np.testing.assert_allclose(tobs[:, p:], jobs[:, p:], atol=1e-3)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_matches_jax(rollout, step):
  _, cfg, _, steps, _ = rollout
  p = cfg.proprio_dim
  (jo, jr, jd), (to, tr, td) = steps[step]
  np.testing.assert_allclose(to[:, :p], jo[:, :p], atol=6e-3)
  np.testing.assert_allclose(to[:, p:], jo[:, p:], atol=1e-3)
  assert np.ptp(to[:, p:].reshape(E, 4, 64, 64)[:, 0]) > 0.1
  np.testing.assert_allclose(tr, jr, atol=2e-3)
  np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("step", range(N_STEPS + 1))
def test_mmdr_state_matches_jax(rollout, step):
  """frame_idx, interp_delay, box_dirs and boxes, exact, after the reset
  (step 0) and after each step."""
  _, _, _, _, fields = rollout
  jf, tf = fields[step]
  for k, v in jf.items():
    np.testing.assert_array_equal(tf[k], v, err_msg=k)


def test_mmdr_options_act(rollout):
  """The options change what they should over the run: with a random
  delay the slots lie in [k fe, (k + 1) fe) and differ between envs, and
  boxes move; with the per-step head the indices change and the
  interpolation delays differ between envs."""
  name, cfg, _, _, fields = rollout
  fe = cfg.frame_extract
  first, last = fields[0][1], fields[-1][1]
  if name == "moving-thin-wide":
    k = np.arange(4) * fe
    assert ((first["frame_idx"] >= k) & (first["frame_idx"] < k + fe)).all()
    assert len({tuple(r) for r in first["frame_idx"]}) > 1
    moved = np.abs(last["boxes"] - first["boxes"]).max(-1) > 0
    assert moved[:, :tterr.NUM_SPARSE_BLOCKS].any()
    assert not moved[:, tterr.NUM_SPARSE_BLOCKS:].any()
  else:
    assert not np.array_equal(first["frame_idx"], last["frame_idx"])
    assert len(set(first["interp_delay"].tolist())) > 1
    assert (last["frame_idx"] < cfg.num_stored_frames).all()
