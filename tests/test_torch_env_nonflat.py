"""Parity of the port's non-flat A1MoveGround step (the per-env engine
batched over the envs, each env's heightfield in the contact model and
the camera) with the JAX env's vmapped per-env step, on the CPU, at 2
envs.

The torch env replays the JAX env's randomness as tests/test_torch_env.py
does: terrain (heightfield included), dynamics and start jitter from the
JAX reset, blind spots from the JAX state's keys.  Both envs stand the
same settled template (the settle is chaotic between implementations,
ROADMAP section 3): the port's own, cut to 100 substeps, handed to the
JAX env in place of its settle.

The first of the N_STEPS = 3 steps is held in float32 at the tolerances
below.  On the second, a contact onset on the bumps parts the two float32
runs by up to 2.3e-4 rad in one joint angle (the observation's delayed
motor reads still agree), as float32 windows part on flat ground (ROADMAP
section 3); the physics of the second and third steps, each from the JAX
state before it, is held in float64 on both sides instead, at 1e-9 m and
rad (velocities 1e-7).

Tolerances, those of tests/test_torch_env.py: joint angles and positions
3e-5 (the reset's ground height goes through the JAX package's hat-weight
einsum and the port's gather, which agree to ~1e-7), velocity-derived
observations 6e-3, rewards 2e-3, depth images 1e-3 in normalized units on
all but at most 0.5 % of the pixels (a grazing ray can part by one march
step; tests/test_torch_heightfield.py).

Of the random heightfield: its flat centre lies at -(max + min) / 2, about
-0.05 m, so the standing robot starts below the 0.2 m height_fall line and
every thin-heightfield episode ends on its first step, in the JAX env as
in the port (ROADMAP section 3).  The steps go on from there all the same.

The mountain (config/rl/challenge/locotransformer/mountain.json) is held
on its reset's placement (the template's height above the mount at each
env's jittered start) and proprio observation and one step, with the
camera off on both sides: its heightfield march is the one of the
thin-heightfield env and of tests/test_torch_heightfield.py, and one JAX
compile fewer keeps this file within its time.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import env as jenv_mod
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_tpu.physics import engine as jengine
from vision4leg_tpu.robots import a1 as ja1
from vision4leg_torch import convert
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs.get_env import get_env as torch_get_env
from vision4leg_torch.ops import physics_kernel

ROOT = os.path.join(os.path.dirname(__file__), "..", "config")
HEIGHTFIELD = "rl/static/locotransformer/thin-heightfield"
MOUNTAIN = "rl/challenge/locotransformer/mountain"
E = 2
N_STEPS = 3
N_F32 = 1      # steps held in float32; the later steps' physics in float64
PROPRIO = 84
DEPTH_TOL, DEPTH_SHARE = 1e-3, 0.005
SETTLE = 100   # substeps of the template's settle (both envs stand on it)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  """Small eager ops: with the suite's workers sharing the cores, torch's
  intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _params(name, **build):
  with open(os.path.join(ROOT, name + ".json")) as f:
    params = json.load(f)
  params["env"]["env_build"].update(build)
  return params


def _np_tree(x):
  return jax.tree.map(np.asarray, x)


def _blind_from_key(key):
  """The blind spots preprocess_depth draws from `k_blind`."""
  k1, k2 = jax.random.split(key)
  return (np.asarray(jax.random.randint(k1, (), 3, 30)),
          np.asarray(jax.random.randint(k2, (30, 2), 0, 64)))


def _blinds(keys):
  out = [_blind_from_key(k) for k in keys]
  return tenv_mod.BlindSpots(torch.tensor(np.stack([o[0] for o in out])),
                             torch.tensor(np.stack([o[1] for o in out])))


def _reset_blind(keys):
  """env.reset(key): k_state = split(key, 7)[6]; _capture_frame splits it."""
  return _blinds([jax.random.split(jax.random.split(k, 7)[6])[1]
                  for k in keys])


def _step_blind(state_keys):
  """step: _step_pre splits the state key in 3 (keeps [0]); the capture
  splits that again and uses [1]."""
  return _blinds([jax.random.split(jax.random.split(k, 3)[0])[1]
                  for k in state_keys])


class ReplayEnv(tenv_mod.A1GymEnv):
  """The torch env with its draws replaced by queued JAX draws."""
  reset_draws = None
  blinds = ()

  def draw_reset(self, n_env, gen):
    return self.reset_draws

  def draw_blind_spots(self, n_env, gen):
    return self.blinds.pop(0)


def _envs(params, monkeypatch):
  """(JAX env, torch replay env) of a config, both on the port's settled
  standing template."""
  tenv, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  renv = ReplayEnv(dataclasses.replace(tenv.cfg, settle_steps=SETTLE),
                   device="cpu")
  tmpl = renv.settled_template()
  jphys = jengine.PhysState(**{
      f: jnp.asarray(getattr(tmpl.phys, f).numpy())
      for f in ("pos", "quat", "joint_q", "ang", "lin", "joint_qd")})

  def template(self):
    self._template = ja1.init_robot_state(self.model, jphys)
    return self._template

  monkeypatch.setattr(jenv_mod.A1GymEnv, "settled_template", template)
  jenv, _ = jax_get_env(params["env_name"], params["env"])
  return jenv, renv


def _reset(jenv, renv, keys):
  jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
  js = _np_tree(jstate)
  init = np.asarray(tterr.INIT_POSITION[renv.cfg.terrain_type], np.float32)
  renv.reset_draws = tenv_mod.ResetDraws(
      terrain=convert.terrain(js.terrain), dyn=convert.dynamics(js.dyn),
      init_jitter=torch.tensor(js.robot.phys.pos[:, :2] - init[:2]),
      blind=_reset_blind(keys) if renv.cfg.get_image else None)
  tstate, tobs = renv.reset(E, torch.Generator().manual_seed(0))
  return jstate, np.asarray(jobs), tstate, tobs.numpy()


def _counting_window(monkeypatch):
  calls = []
  window = physics_kernel.robot_window

  def counted(*args, **kw):
    calls.append(1)
    return window(*args, **kw)

  monkeypatch.setattr(physics_kernel, "robot_window", counted)
  return calls


@pytest.fixture(scope="module")
def heightfield_rollout():
  """Reset + N_STEPS steps of both thin-heightfield envs on the same
  actions; the physics window's calls counted over the torch steps."""
  with pytest.MonkeyPatch.context() as mp:
    jenv, renv = _envs(_params(HEIGHTFIELD), mp)
    keys = jax.random.split(jax.random.PRNGKey(4), E)
    jstate, jobs, tstate, tobs = _reset(jenv, renv, keys)
    calls = _counting_window(mp)
    rng = np.random.default_rng(1)
    lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
    jstep = jax.jit(jenv.step_batch)
    gen = torch.Generator().manual_seed(0)
    steps, held, befores = [], None, []
    for i in range(N_STEPS):
      act = (lo + (hi - lo) * rng.uniform(size=(E, 6))).astype(np.float32)
      renv.blinds = [_step_blind(jstate.key)]
      befores.append((_np_tree(jstate), act))
      jstate, jo, jr, jd, _ = jstep(jstate, jnp.asarray(act))
      tstate, to, tr, td, _ = renv.step_batch(tstate, torch.tensor(act), gen)
      steps.append(((np.asarray(jo), np.asarray(jr), np.asarray(jd)),
                    (to.numpy(), tr.numpy(), td.numpy())))
      if i == N_F32 - 1:
        held = (_np_tree(jstate), tstate)
    return ((jobs, tobs), steps, (held, (_np_tree(jstate), tstate)),
            len(calls), renv, (jenv, befores))


def _assert_depth_close(got, want):
  diff = np.abs(got - want)
  assert (diff > DEPTH_TOL).mean() <= DEPTH_SHARE, (
      int((diff > DEPTH_TOL).sum()), diff.max())


def test_heightfield_reset_matches_jax(heightfield_rollout):
  (jobs, tobs), _, _, _, _, _ = heightfield_rollout
  assert tobs.shape == jobs.shape == (E, PROPRIO + 4 * 64 * 64)
  np.testing.assert_allclose(tobs[:, :PROPRIO], jobs[:, :PROPRIO], atol=1e-5)
  _assert_depth_close(tobs[:, PROPRIO:], jobs[:, PROPRIO:])


@pytest.mark.parametrize("step", range(N_F32))
def test_heightfield_step_matches_jax(heightfield_rollout, step):
  _, steps, _, _, _, _ = heightfield_rollout
  (jo, jr, jd), (to, tr, td) = steps[step]
  motor = slice(PROPRIO - 36, PROPRIO)           # HSW(MotorAngle)
  np.testing.assert_allclose(to[:, motor], jo[:, motor], atol=3e-5)
  np.testing.assert_allclose(to[:, :PROPRIO], jo[:, :PROPRIO], atol=6e-3)
  depth_t = to[:, PROPRIO:].reshape(E, 4, 64, 64)
  depth_j = jo[:, PROPRIO:].reshape(E, 4, 64, 64)
  _assert_depth_close(depth_t, depth_j)
  assert np.ptp(depth_t[:, 0]) > 0.1           # frames are not constant
  np.testing.assert_allclose(tr, jr, atol=2e-3)
  np.testing.assert_array_equal(td, jd)


def test_heightfield_final_state_matches_jax(heightfield_rollout):
  """The state after the float32-held steps; after all N_STEPS the parts
  that do not go through the physics."""
  _, _, ((hj, ht), (js, ts)), _, _, _ = heightfield_rollout
  np.testing.assert_allclose(ht.robot.phys.pos.numpy(), hj.robot.phys.pos,
                             atol=3e-5)
  np.testing.assert_allclose(ht.robot.phys.joint_q.numpy(),
                             hj.robot.phys.joint_q, atol=3e-5)
  assert torch.isfinite(ts.robot.phys.joint_q).all()
  np.testing.assert_array_equal(ts.robot.last_robot_action.numpy(),
                                js.robot.last_robot_action)
  np.testing.assert_array_equal(ts.step_counter.numpy(), js.step_counter)
  # the heightfield rides along in the state, unchanged
  np.testing.assert_array_equal(ts.terrain.height.numpy(), js.terrain.height)


def test_nonflat_steps_never_reach_the_window(heightfield_rollout):
  """The non-flat steps called physics_kernel.robot_window no time, and
  the env's window entry raises rather than step on a plane."""
  _, _, (_, (_, ts)), calls, renv, _ = heightfield_rollout
  assert calls == 0 and not renv.kernel_capable
  with pytest.raises(RuntimeError, match="models flat ground"):
    renv._robot_window(renv.model, ts.robot, ts.last_action, ts.dyn,
                       ts.terrain.boxes[:, :8], ts.terrain.obstacle_spheres,
                       ts.dyn.lateral_friction, ts.dyn.lateral_friction, 16)


def _double(x):
  """A torch dataclass tree (model, states) in float64."""
  if isinstance(x, torch.Tensor):
    return x.double() if x.is_floating_point() else x
  if dataclasses.is_dataclass(x):
    return dataclasses.replace(x, **{f.name: _double(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})
  return x


@pytest.fixture(scope="module")
def jax_windows_f64(heightfield_rollout):
  """The JAX package's physics of the float64-held steps, from the JAX
  states before them, in float64 (one compile: the steps' envs side by
  side)."""
  _, _, _, _, _, (jenv, befores) = heightfield_rollout
  steps = range(N_F32, N_STEPS)
  cat = lambda *xs: np.concatenate(xs)
  js = jax.tree.map(cat, *[befores[i][0] for i in steps])
  act12 = np.asarray(jax.vmap(jenv._expand_action)(
      jnp.asarray(cat(*[befores[i][1] for i in steps]))))
  with jax.enable_x64(True):
    f64 = lambda t: jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else
        jnp.asarray(x), t)
    jmodel = f64(jenv.model)

    def jwindow(rs, dyn, terrain, a):
      cfn = jenv._contact_fn(terrain, dyn, base_xy=rs.phys.pos[:2])
      return ja1.robot_step(jmodel, rs, a, dyn, cfn, action_repeat=16)[0]

    jrs = _np_tree(jax.jit(jax.vmap(jwindow))(
        f64(js.robot), f64(js.dyn), f64(js.terrain), f64(act12)))
  return {i: (jax.tree.map(lambda x: x[k * E:(k + 1) * E], jrs),
              act12[k * E:(k + 1) * E]) for k, i in enumerate(steps)}


@pytest.mark.parametrize("step", range(N_F32, N_STEPS))
def test_heightfield_window_matches_jax_in_float64(heightfield_rollout,
                                                   jax_windows_f64, step):
  """A step's physics (16 substeps of the per-env engine on the
  heightfield, boxes pruned at the base xy) from the JAX state before it,
  both sides in float64: the float32 runs part there (a contact onset on
  the bumps), float64 ones agree."""
  _, _, _, _, renv, (_, befores) = heightfield_rollout
  js = befores[step][0]
  jrs, act12 = jax_windows_f64[step]
  rs = _double(convert.robot_state(js.robot))
  dyn = _double(convert.dynamics(js.dyn))
  terrain = _double(convert.terrain(js.terrain))
  cfn = renv._contact_fn(terrain, dyn, rs.phys.pos[:, :2])
  trs, _ = tenv_mod.a1.robot_step(_double(renv.model), rs,
                                  torch.tensor(act12).double(), dyn, cfn, 16)
  assert trs.phys.joint_q.dtype == torch.float64
  for f in ("pos", "quat", "joint_q"):
    np.testing.assert_allclose(getattr(trs.phys, f).numpy(),
                               getattr(jrs.phys, f), atol=1e-9, err_msg=f)
  for f in ("lin", "ang", "joint_qd"):
    np.testing.assert_allclose(getattr(trs.phys, f).numpy(),
                               getattr(jrs.phys, f), atol=1e-7, err_msg=f)


def test_mountain_reset_and_step_match_jax(monkeypatch):
  params = _params(MOUNTAIN, get_image=False)
  jenv, renv = _envs(params, monkeypatch)
  keys = jax.random.split(jax.random.PRNGKey(6), E)
  jstate, jobs, tstate, tobs = _reset(jenv, renv, keys)
  js = _np_tree(jstate)
  # the template's height above the mount at each env's jittered start
  pos = tstate.robot.phys.pos
  h, _ = tterr.heightfield_fns(tstate.terrain)
  above = pos[:, 2] - h(pos[:, None, :2])[:, 0]
  np.testing.assert_allclose(above.numpy(),
                             renv.settled_template().phys.pos[2].item(),
                             atol=1e-6)
  assert float(pos[:, 2].min()) > 1.0                   # on the mount
  np.testing.assert_allclose(pos.numpy(), js.robot.phys.pos, atol=3e-5)
  assert tobs.shape == jobs.shape == (E, 6 + PROPRIO)
  np.testing.assert_allclose(tobs, jobs, atol=1e-5)
  np.testing.assert_allclose(tobs[:, 3:6], [[4.0, 11.5, 3.5]] * E)  # goal

  act = np.asarray(jenv.action_low + jenv.action_high) / 2
  act = np.tile(act, (E, 1)).astype(np.float32)
  jstate, jo, jr, jd, _ = jax.jit(jenv.step_batch)(jstate, jnp.asarray(act))
  tstate, to, tr, td, _ = renv.step_batch(
      tstate, torch.tensor(act), torch.Generator().manual_seed(0))
  to, jo = to.numpy(), np.asarray(jo)
  motor = slice(6 + PROPRIO - 36, 6 + PROPRIO)
  np.testing.assert_allclose(to[:, motor], jo[:, motor], atol=3e-5)
  np.testing.assert_allclose(to, jo, atol=6e-3)
  np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-3)
  np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
  np.testing.assert_allclose(tstate.robot.phys.pos.numpy(),
                             np.asarray(jstate.robot.phys.pos), atol=3e-5)


def test_mpc_env_builds_a_heightfield_config():
  """The MPC env on a heightfield steps through the per-env engine
  (tests/test_torch_mpc_nonflat.py holds it against JAX); its window
  entry still raises."""
  params = _params("mpc/locotransformer/thin-heightfield")
  env, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  assert not env.kernel_capable
  with pytest.raises(RuntimeError, match="models flat ground"):
    env._robot_window()
