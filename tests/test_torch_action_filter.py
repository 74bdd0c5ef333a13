"""The port's Butterworth action filter (vision4leg_torch.robots.
action_filter) and its wiring in the env's step, against the JAX package
on the CPU.

  * the coefficients equal the JAX module's (both scipy in float64, cast
    to Python floats), at the control rate of the shipped 0.0025 s x 16
    envs and of the plane env below;
  * three IIR steps from the steady state of a standing pose, on inputs
    drawn with numpy, float32: 1e-6 (a few float32 roundings of values of
    O(1));
  * one env step on the plane with the filter on (4 envs, no camera, the
    JAX settled template injected, settle cut to 20 substeps) against the
    JAX env's step_batch: the filtered command and the filter's histories
    1e-6, joint angles and positions 3e-5 and observations 6e-3, rewards
    2e-3, as tests/test_torch_env.py holds a window step; the filtered
    command differs from the unfiltered one, so the check saw the filter.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import env as jenv_mod
from vision4leg_tpu.robots import action_filter as jfilter
from vision4leg_torch import convert
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.robots import a1_params as P
from vision4leg_torch.robots import action_filter as tfilter

E = 4
CFG = dict(terrain_type="plane", time_step_s=0.0025, num_action_repeat=4,
           diagonal_act=True, clip_num=(0.05, 0.5, 0.5) * 4, settle_steps=20,
           enable_action_filter=True)


@pytest.mark.parametrize("rate", [1.0 / (0.0025 * 16), 1.0 / (0.0025 * 4)])
def test_coefficients_match_jax(rate):
  assert tfilter.make_coeffs(rate) == jfilter.make_coeffs(rate)


def test_three_iir_steps_match_jax():
  rng = np.random.default_rng(0)
  coeffs = tfilter.make_coeffs(1.0 / (0.0025 * 16))
  init = P.INIT_MOTOR_ANGLES.astype(np.float32)
  xs = (init + rng.normal(scale=0.3, size=(3, E, 12))).astype(np.float32)
  jstate = jax.vmap(lambda _: jfilter.init_state(12, jnp.asarray(init)))(
      jnp.arange(E))
  tstate = tfilter.init_state(torch.tensor(init).expand(E, 12))
  japply = jax.jit(jax.vmap(lambda s, x: jfilter.apply(coeffs, s, x)))
  for x in xs:
    jstate, jy = japply(jstate, jnp.asarray(x))
    tstate, ty = tfilter.apply(coeffs, tstate, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(tstate.xhist.numpy(), np.asarray(jstate.xhist),
                               atol=1e-6)
    np.testing.assert_allclose(tstate.yhist.numpy(), np.asarray(jstate.yhist),
                               atol=1e-6)
  # a low-pass: the output lags the jumps of the input
  assert float(torch.abs(ty - torch.tensor(xs[-1])).max()) > 0.05


class ReplayEnv(tenv_mod.A1GymEnv):
  reset_draws = None

  def draw_reset(self, n_env, gen):
    return self.reset_draws


def test_env_step_with_the_filter_matches_jax():
  jenv = jenv_mod.A1GymEnv(jenv_mod.EnvConfig(**CFG))
  renv = ReplayEnv(tenv_mod.EnvConfig(**CFG), device="cpu")
  renv._template = convert.robot_state(
      jax.tree.map(np.asarray, jenv.settled_template()))
  keys = jax.random.split(jax.random.PRNGKey(5), E)
  jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
  js = jax.tree.map(np.asarray, jstate)
  renv.reset_draws = tenv_mod.ResetDraws(
      terrain=convert.terrain(js.terrain), dyn=convert.dynamics(js.dyn),
      init_jitter=torch.zeros(E, 2), blind=None)
  gen = torch.Generator().manual_seed(0)
  tstate, tobs = renv.reset(E, gen)
  np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-5)
  fs = convert.filter_state(js.filter_state)
  for f in ("xhist", "yhist"):
    assert torch.equal(getattr(tstate.filter_state, f), getattr(fs, f)), f

  rng = np.random.default_rng(1)
  lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
  act = (lo + (hi - lo) * rng.uniform(size=(E, 6))).astype(np.float32)
  j2, jo, jr, jd, _ = jax.jit(jenv.step_batch)(jstate, jnp.asarray(act))
  t2, to, tr, td, _ = renv.step_batch(tstate, torch.tensor(act), gen)
  j2 = jax.tree.map(np.asarray, j2)

  np.testing.assert_allclose(t2.last_action.numpy(), j2.last_action,
                             atol=1e-6)
  for f in ("xhist", "yhist"):
    np.testing.assert_allclose(getattr(t2.filter_state, f).numpy(),
                               getattr(j2.filter_state, f), atol=1e-6)
  unfiltered = renv._expand_action(torch.tensor(act))
  assert float(torch.abs(t2.last_action - unfiltered).max()) > 1e-3
  np.testing.assert_allclose(t2.robot.phys.pos.numpy(), j2.robot.phys.pos,
                             atol=3e-5)
  np.testing.assert_allclose(t2.robot.phys.joint_q.numpy(),
                             j2.robot.phys.joint_q, atol=3e-5)
  np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=6e-3)
  np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-3)
  np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_filter_state_survives_a_reset_scatter():
  """The filter's histories ride in EnvState: a partial reset puts the
  standing pose back in the reset envs' histories only."""
  from vision4leg_torch.collector import rollout as troll
  env = tenv_mod.A1GymEnv(
      tenv_mod.EnvConfig(**dict(CFG, settle_steps=5)), device="cpu")
  gen = torch.Generator().manual_seed(3)
  state, _ = env.reset(E, gen)
  act = env.action_high.expand(E, 6)
  state, *_ = env.step_batch(state, act, gen)
  fresh, _ = env.reset(1, gen)
  idx = torch.tensor([2])
  merged = troll._scatter(state, fresh, idx)
  stand = torch.tensor(P.INIT_MOTOR_ANGLES, dtype=torch.float32)
  np.testing.assert_allclose(merged.filter_state.yhist[2].numpy(),
                             stand.expand(2, 12).numpy())
  assert torch.equal(merged.filter_state.yhist[0], state.filter_state.yhist[0])
  assert not torch.allclose(merged.filter_state.yhist[0], stand.expand(2, 12))
  assert dataclasses.is_dataclass(merged.filter_state)
