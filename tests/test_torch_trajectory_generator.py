"""The port's trajectory-generator wrapper (envs/trajectory_generator.py)
against the JAX package's, on the CPU: the cases of tests/test_wrappers.py
(a generator without the interface refused, a zero signal transparent,
the open-loop trot's phase and limits), and the wrapped env's reset and
steps against the JAX wrapper's on the same residual actions.

The env is the JAX test's: flat plane, 12 raw motor angles, 16 substeps of
2.5 ms, no camera and no randomization, so that a reset draws nothing;
the port's env takes the JAX env's settled standing template (the settle
is chaotic between engines, tests/test_torch_env.py).  Tolerances as
tests/test_torch_env.py's: observations 6e-3 (velocity-derived IMU rates;
joint angles agree to 3e-5), rewards 2e-3, the phase tail and the motor
commands 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import env as jenv_mod
from vision4leg_tpu.envs import trajectory_generator as jtg
from vision4leg_torch import convert
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import trajectory_generator as ttg
from vision4leg_torch.robots import a1_params as P

E = 3
STEPS = 3
ENV_KW = dict(motor_control_mode="POSITION", time_step_s=0.0025,
              num_action_repeat=16, diagonal_act=False)


@pytest.fixture(scope="module")
def envs():
  jenv = jenv_mod.A1GymEnv(jenv_mod.EnvConfig(**ENV_KW))
  tenv = tenv_mod.A1GymEnv(tenv_mod.EnvConfig(**ENV_KW), device="cpu")
  tenv._template = convert.robot_state(
      jax.tree.map(np.asarray, jenv.settled_template()))
  return jenv, tenv


def test_tg_wrapper_rejects_bad_generator(envs):
  _, tenv = envs
  with pytest.raises(ValueError, match="interface"):
    ttg.TrajectoryGeneratorWrapper(tenv, object())
  diag = tenv_mod.A1GymEnv(tenv_mod.EnvConfig(**dict(ENV_KW,
                                                     diagonal_act=True)),
                           device="cpu")
  with pytest.raises(ValueError, match="12 motor angles"):
    ttg.TrajectoryGeneratorWrapper(diag, ttg.OpenloopGaitGenerator())


def test_tg_zero_signal_is_transparent(envs):
  """Zero amplitudes and a zero residual: the wrapped env steps the bare
  env's standing pose exactly, and the observation gains exactly the
  (cos, sin) phase tail."""
  _, tenv = envs
  tg = ttg.OpenloopGaitGenerator(swing_amplitude=0.0,
                                 extension_amplitude=0.0)
  wrapped = ttg.TrajectoryGeneratorWrapper(tenv, tg)
  assert wrapped.obs_dim == tenv.obs_dim + 2
  carry, obs_w = wrapped.reset(E, torch.Generator().manual_seed(3))
  state_b, obs_b = tenv.reset(E, torch.Generator().manual_seed(3))
  assert torch.equal(obs_w[:, :-2], obs_b)
  init12 = torch.tensor(P.INIT_MOTOR_ANGLES, dtype=torch.float32).expand(
      E, 12)
  gw, gb = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
  for _ in range(STEPS):
    carry, obs_w, rew_w, done_w, _ = wrapped.step_batch(
        carry, torch.zeros(E, 12), gw)
    state_b, obs_b, rew_b, done_b, _ = tenv.step_batch(state_b, init12, gb)
    assert torch.equal(obs_w[:, :-2], obs_b)
    assert torch.equal(rew_w, rew_b) and torch.equal(done_w, done_b)


def test_tg_openloop_trot_phases_and_limits():
  """The port's generator against the JAX one per env on the same phases
  and residuals (phase advance 2 pi f dt, motor angles, the observation
  tail), and the trot's properties: the standing pose at phase 0, FR/RL
  swinging forward at a quarter cycle with FL mirroring, joint limits
  under huge residuals."""
  jgen = jtg.OpenloopGaitGenerator(frequency_hz=1.25, control_dt=0.04)
  tgen = ttg.OpenloopGaitGenerator(frequency_hz=1.25, control_dt=0.04)
  rng = np.random.default_rng(0)
  phases = np.concatenate([[0.0, np.pi / 2, 2 * np.pi - 1e-3],
                           rng.uniform(0, 2 * np.pi, 5)]).astype(np.float32)
  resid = rng.normal(0, 0.3, (len(phases), 12)).astype(np.float32)
  resid[-1] = 100.0
  resid[-2] = -100.0
  st, motor = tgen.get_action(ttg.TGState(torch.tensor(phases)),
                              torch.zeros(len(phases)), torch.tensor(resid))
  obs = tgen.get_observation(st, torch.zeros(len(phases), 1))
  for i, ph in enumerate(phases):
    jst, jmotor = jgen.get_action(jtg.TGState(phase=jnp.asarray(ph)),
                                  jnp.zeros(()), jnp.asarray(resid[i]))
    np.testing.assert_allclose(motor[i].numpy(), np.asarray(jmotor),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(st.phase[i]), float(jst.phase),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        obs[i, 1:].numpy(),
        np.asarray(jgen.get_observation(jst, jnp.zeros(0))), atol=1e-6)
  st0, motor0 = tgen.get_action(tgen.reset(1, "cpu"), torch.zeros(1),
                                torch.zeros(1, 12))
  np.testing.assert_allclose(float(st0.phase[0]), 2 * np.pi * 1.25 * 0.04,
                             rtol=1e-6)
  np.testing.assert_allclose(motor0[0].numpy(), P.INIT_MOTOR_ANGLES,
                             atol=1e-6)
  thigh = motor[1].numpy().reshape(4, 3)[:, 1] - resid[1].reshape(4, 3)[
      :, 1] - 0.9
  assert thigh[0] > 0.0 and thigh[3] > 0.0
  np.testing.assert_allclose(thigh[1], -thigh[0], atol=1e-6)
  assert np.all(motor[-1].numpy() <= P.JOINT_UPPER + 1e-6)
  assert np.all(motor[-2].numpy() >= P.JOINT_LOWER - 1e-6)


def test_tg_wrapper_matches_jax(envs):
  """Reset and STEPS steps of the wrapped env on the same residuals,
  batched in the port, vmapped in JAX."""
  jenv, tenv = envs
  jw = jtg.TrajectoryGeneratorWrapper(jenv, jtg.OpenloopGaitGenerator())
  tw = ttg.TrajectoryGeneratorWrapper(tenv, ttg.OpenloopGaitGenerator())
  assert tw.obs_dim == jw.obs_dim
  keys = jax.random.split(jax.random.PRNGKey(5), E)
  jcarry, jobs = jax.jit(jax.vmap(jw.reset))(keys)
  tcarry, tobs = tw.reset(E, torch.Generator().manual_seed(0))
  np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=6e-3)
  jstep = jax.jit(jax.vmap(jw.step))
  rng = np.random.default_rng(1)
  gen = torch.Generator().manual_seed(0)
  for _ in range(STEPS):
    act = rng.normal(0, 0.1, (E, 12)).astype(np.float32)
    jcarry, jobs, jrew, jdone, _ = jstep(jcarry, jnp.asarray(act))
    tcarry, tobs, trew, tdone, _ = tw.step_batch(tcarry, torch.tensor(act),
                                                 gen)
    np.testing.assert_allclose(tcarry.tg.phase.numpy(),
                               np.asarray(jcarry[1].phase), atol=1e-6)
    np.testing.assert_allclose(tobs[:, -2:].numpy(),
                               np.asarray(jobs)[:, -2:], atol=1e-6)
    np.testing.assert_allclose(tcarry.env.last_action.numpy(),
                               np.asarray(jcarry[0].last_action), atol=1e-6)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=6e-3)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=2e-3)
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
