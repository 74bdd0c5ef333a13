"""Parity of the port's last flat-terrain options with the JAX env on the
CPU: the `random_sphere_with_subgoal` terrain (its generator, the
nearest-sphere pruning, the camera on obstacle spheres), `random_dir`
with `dir_update_interval` and `rotate_sensor`.

The env case is thin-goal's config with the sphere terrain, random_dir
(interval 2) and rotate_sensor turned on together and the displacement
sensor on (thin-goal turns it off), at 2 envs: reset + 3
steps against the JAX env's `step_batch` on the same actions, the port
replaying the JAX draws (terrain, dynamics, jitter, the reset's
direction, each step's redraw candidate, the camera's blind spots) and
the JAX settled template, as tests/test_torch_env.py does.  Tolerances
are that file's: joint angles 3e-5, the proprio observation 6e-3 (IMU
rates), depth 1e-3 in normalized units, rewards 2e-3; the direction
prefix and the task's target_vel_dir 1e-6 (a cos / sin of the same
float32 angle); the terrain generator exactly; render_depth alone 1e-4.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.envs import camera as jcam
from vision4leg_tpu.envs import env as jenv_mod
from vision4leg_tpu.envs import terrain as jterr
from vision4leg_tpu.envs import wrappers as jwrap
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_tpu.physics import maths as jmaths
from vision4leg_torch import convert
from vision4leg_torch.envs import camera as tcam
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs import wrappers as twrap
from vision4leg_torch.envs.get_env import get_env as torch_get_env
from vision4leg_torch.physics import maths as tmaths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "rl", "static", "locotransformer",
                      "thin-goal.json")
OPTIONS = dict(terrain_type="random_sphere_with_subgoal", random_dir=True,
               dir_update_interval=2, rotate_sensor=True,
               no_displacement=False)
E = 2
N_STEPS = 3
# 2 (cos, sin) + 3 x 7 displacement and rotation + 12 IMU + 36 last
# action + 36 motor angles: the JAX formula (env.py:117-127)
PROPRIO = 2 + 21 + 12 + 36 + 36


def _np_tree(x):
  return jax.tree.map(np.asarray, x)


def _blind_from_key(key):
  """The blind spots preprocess_depth draws from `k_blind`."""
  k1, k2 = jax.random.split(key)
  return (np.asarray(jax.random.randint(k1, (), 3, 30)),
          np.asarray(jax.random.randint(k2, (30, 2), 0, 64)))


def _stack(out):
  return tenv_mod.BlindSpots(torch.tensor(np.stack([o[0] for o in out])),
                             torch.tensor(np.stack([o[1] for o in out])))


def _reset_blind(keys):
  """reset(key): k_state = split(key, 7)[6]; _capture_frame splits it."""
  return _stack([_blind_from_key(jax.random.split(
      jax.random.split(k, 7)[6])[1]) for k in keys])


def _step_draws(state_keys):
  """A step with a RandoDir interval: _step_pre splits the state key in
  3 and keeps [0]; the redraw splits that and draws the candidate angle
  from [1]; the capture splits the kept [0] again and draws the blind
  spots from [1]."""
  angles, blinds = [], []
  for k in state_keys:
    key, k_dir = jax.random.split(jax.random.split(k, 3)[0])
    angles.append(np.asarray(jax.random.uniform(
        k_dir, (), minval=-jnp.pi / 2, maxval=jnp.pi / 2)))
    blinds.append(_blind_from_key(jax.random.split(key)[1]))
  return _stack(blinds), torch.tensor(np.stack(angles))


class ReplayEnv(tenv_mod.A1GymEnv):
  """The torch env with its draws replaced by the JAX env's."""
  reset_draws = None
  step_draws = None

  def draw_reset(self, n_env, gen):
    return self.reset_draws

  def draw_step(self, n_env, n_boxes, gen):
    return self.step_draws


def _params():
  with open(CONFIG) as f:
    params = json.load(f)
  params["env"]["env_build"].update(OPTIONS)
  return params


@pytest.fixture(scope="module")
def rollout():
  """Reset + N_STEPS steps of both envs on the same actions."""
  params = _params()
  jenv, _ = jax_get_env(params["env_name"], params["env"])
  tenv, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  renv = ReplayEnv(tenv.cfg, device="cpu")
  renv._template = convert.robot_state(_np_tree(jenv.settled_template()))

  keys = jax.random.split(jax.random.PRNGKey(4), E)
  jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
  js = _np_tree(jstate)
  init = np.asarray(tterr.INIT_POSITION[tenv.cfg.terrain_type], np.float32)
  renv.reset_draws = tenv_mod.ResetDraws(
      terrain=convert.terrain(js.terrain), dyn=convert.dynamics(js.dyn),
      init_jitter=torch.tensor(js.robot.phys.pos[:, :2] - init[:2]),
      blind=_reset_blind(keys), dir_angle=torch.tensor(js.dir_angle))
  gen = torch.Generator().manual_seed(0)
  tstate, tobs = renv.reset(E, gen)
  reset = (np.asarray(jobs), tobs.numpy(), js, tstate)

  rng = np.random.default_rng(0)
  lo, hi = np.asarray(jenv.action_low), np.asarray(jenv.action_high)
  jstep = jax.jit(jenv.step_batch)
  steps = []
  for _ in range(N_STEPS):
    act = (lo + (hi - lo) * rng.uniform(size=(E, 6))).astype(np.float32)
    blind, angle = _step_draws(jstate.key)
    renv.step_draws = tenv_mod.StepDraws(blind, None, None, angle)
    jstate, jo, jr, jd, _ = jstep(jstate, jnp.asarray(act))
    tstate, to, tr, td, _ = renv.step_batch(tstate, torch.tensor(act), gen)
    steps.append(((np.asarray(jo), np.asarray(jr), np.asarray(jd),
                   _np_tree(jstate)), (to.numpy(), tr.numpy(), td.numpy(),
                                       tstate)))
  return reset, steps


def test_reset_matches_jax(rollout):
  (jobs, tobs, js, ts), _ = rollout
  assert tobs.shape == jobs.shape == (E, PROPRIO + 4 * 64 * 64)
  np.testing.assert_allclose(tobs[:, :PROPRIO], jobs[:, :PROPRIO], atol=1e-5)
  np.testing.assert_allclose(tobs[:, PROPRIO:], jobs[:, PROPRIO:], atol=1e-3)
  # the direction prefix and the task's reward direction of the drawn angle
  np.testing.assert_allclose(tobs[:, :2], jobs[:, :2], atol=1e-6)
  np.testing.assert_allclose(ts.task.target_vel_dir.numpy(),
                             js.task.target_vel_dir, atol=1e-6)
  np.testing.assert_array_equal(ts.dir_count.numpy(), js.dir_count)
  np.testing.assert_allclose(ts.last_base_quat.numpy(), js.last_base_quat,
                             atol=1e-6)
  assert ts.disp_hist.shape == js.disp_hist.shape == (E, 3, 7)
  # the terrain carries the generator's 50 spheres
  assert ts.terrain.obstacle_spheres.shape == (E, 50, 5)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_matches_jax(rollout, step):
  _, steps = rollout
  (jo, jr, jd, js), (to, tr, td, ts) = steps[step]
  motor = slice(PROPRIO - 36, PROPRIO)
  np.testing.assert_allclose(to[:, motor], jo[:, motor], atol=3e-5)
  np.testing.assert_allclose(to[:, :PROPRIO], jo[:, :PROPRIO], atol=6e-3)
  np.testing.assert_allclose(to[:, :2], jo[:, :2], atol=1e-6)
  # the rotate sensor's newest reading: displacement and quaternion delta
  np.testing.assert_allclose(ts.disp_hist.numpy(), js.disp_hist, atol=3e-5)
  assert np.abs(js.disp_hist[:, 0, 3:]).max() > 1e-5
  depth_t = to[:, PROPRIO:].reshape(E, 4, 64, 64)
  depth_j = jo[:, PROPRIO:].reshape(E, 4, 64, 64)
  np.testing.assert_allclose(depth_t, depth_j, atol=1e-3)
  np.testing.assert_allclose(tr, jr, atol=2e-3)
  np.testing.assert_array_equal(td, jd)
  np.testing.assert_array_equal(ts.dir_count.numpy(), js.dir_count)
  np.testing.assert_allclose(ts.dir_angle.numpy(), js.dir_angle, atol=0)
  np.testing.assert_allclose(ts.task.target_vel_dir.numpy(),
                             js.task.target_vel_dir, atol=1e-6)
  np.testing.assert_allclose(ts.robot.phys.joint_q.numpy(),
                             js.robot.phys.joint_q, atol=3e-5)


def test_direction_redraws_on_the_schedule(rollout):
  """The reset's observation is count 1; with interval 2 the steps that
  take the count to 2 and 4 redraw (steps 0 and 2), step 1 keeps the
  angle; the JAX env agrees."""
  (_, _, js0, _), steps = rollout
  angles = [js0.dir_angle] + [s[0][3].dir_angle for s in steps]
  counts = [s[1][3].dir_count.numpy() for s in steps]
  np.testing.assert_array_equal(np.stack(counts), [[2, 2], [3, 3], [4, 4]])
  assert (angles[1] != angles[0]).all()
  np.testing.assert_array_equal(angles[2], angles[1])
  assert (angles[3] != angles[2]).all()


def test_generator_on_the_jax_draws():
  """spheres_state on the JAX generator's own draws gives its terrain
  exactly."""
  keys = jax.random.split(jax.random.PRNGKey(2), 3)
  jt = _np_tree(jax.jit(jax.vmap(jterr.gen_spheres_with_subgoal))(keys))
  centers, subgoals = [], []
  for k in keys:
    kq, ks = jax.random.split(k)
    centers.append(np.asarray(jax.random.uniform(
        kq, (50, 2), minval=jnp.array([2.0, -3.0]),
        maxval=jnp.array([16.0, 3.0]))))
    subgoals.append(np.asarray(jax.random.uniform(
        ks, (50, 2), minval=jnp.array([2.0, -2.2]),
        maxval=jnp.array([30.0, 2.2]))))
  tt = tterr.spheres_state(torch.tensor(np.stack(centers)),
                           torch.tensor(np.stack(subgoals)))
  for f in ("obstacle_spheres", "subgoals", "boxes", "box_dirs", "goal_pos",
            "height", "hf_cell", "hf_origin", "hf_zoff"):
    np.testing.assert_array_equal(getattr(tt, f).numpy(), getattr(jt, f),
                                  err_msg=f)
  assert tterr.INIT_POSITION["random_sphere_with_subgoal"] == (0, 0, 0.32)
  assert "random_sphere_with_subgoal" in tterr.FLAT_TERRAINS
  # the port's own draws: 50 valid spheres of r 0.2 at z 0.2 in the box
  own = tterr.TERRAIN_GENERATORS["random_sphere_with_subgoal"](
      torch.Generator().manual_seed(0), 4, "cpu")
  q = own.obstacle_spheres
  assert q.shape == (4, 50, 5) and (q[..., 2:] == torch.tensor(
      [0.2, 0.2, 1.0])).all()
  assert (q[..., 0] >= 2).all() and (q[..., 0] <= 16).all()
  assert (q[..., 1].abs() <= 3).all()


class _Near:
  NEAR_BOXES = 8


def test_pruned_spheres_break_ties_as_jax():
  """Spheres at equal surface distances from the base (rings of the same
  radius, invalid ones among them): the port keeps JAX's set in JAX's
  order, the lower index first among ties."""
  rng = np.random.default_rng(3)
  n_env, q = 16, 20
  base = rng.uniform(-1, 1, (n_env, 2)).astype(np.float32)
  # angles on a quarter-turn lattice and radii from 3 values: exact ties
  ang = rng.integers(0, 4, (n_env, q)) * (np.pi / 2)
  dist = rng.choice([1.0, 2.0, 3.0], (n_env, q))
  xy = base[:, None] + np.stack([np.cos(ang), np.sin(ang)], -1) * dist[
      ..., None]
  spheres = np.concatenate([
      xy, np.full((n_env, q, 1), 0.2), np.full((n_env, q, 1), 0.2),
      (rng.uniform(size=(n_env, q, 1)) > 0.2)], -1).astype(np.float32)
  want = np.asarray(jax.jit(jax.vmap(
      lambda s, p: jenv_mod.A1GymEnv._pruned_spheres(_Near(), s, p)))(
          jnp.asarray(spheres), jnp.asarray(base)))
  got = tenv_mod.A1GymEnv._pruned_spheres(_Near(), torch.tensor(spheres),
                                          torch.tensor(base))
  np.testing.assert_array_equal(got.numpy(), want)
  # ties happened among the kept ones
  d = np.round(np.linalg.norm(want[..., :2] - base[:, None], axis=-1), 4)
  assert max(len(r) - len(set(r)) for r in d.tolist()) >= 2


def test_render_depth_with_obstacle_spheres_matches_jax():
  """render_depth alone on random trunk poses among the JAX generator's
  spheres, subgoals shown (the frustum prune to MAX_RENDER_SPHERES)."""
  rng = np.random.default_rng(6)
  n = 3
  jt = jax.vmap(jterr.gen_spheres_with_subgoal)(
      jax.random.split(jax.random.PRNGKey(5), n))
  pos = np.stack([rng.uniform(0, 6, n), rng.uniform(-1, 1, n),
                  rng.uniform(0.2, 0.35, n)], -1).astype(np.float32)
  rpy = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
  quat = np.asarray(jmaths.rpy_to_quat(jnp.asarray(rpy)))
  h_fn, _ = jterr.flat_height_fn(None)
  jdepth = jax.jit(jax.vmap(
      lambda p, q, t: jcam.render_depth(
          p, jmaths.quat_to_mat(q), t, h_fn, True, show_subgoals=True,
          far_t=10.5)))(jnp.asarray(pos), jnp.asarray(quat), jt)
  tdepth = tcam.render_depth(
      torch.tensor(pos), tmaths.quat_to_mat(torch.tensor(quat)),
      convert.terrain(_np_tree(jt)), show_subgoals=True)
  jd, td = np.asarray(jdepth), tdepth.numpy()
  np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
  # the obstacle spheres are drawn: without them the image differs
  no_q = convert.terrain(_np_tree(jt)).replace(
      obstacle_spheres=torch.zeros(n, 0, 5))
  bare = tcam.render_depth(torch.tensor(pos),
                           tmaths.quat_to_mat(torch.tensor(quat)), no_q,
                           show_subgoals=True).numpy()
  assert (np.abs(bare - td) > 1e-3).mean() > 0.005


def test_rando_dir_wrappers_as_jax():
  """tests/test_wrappers.py::test_rando_dir on the port's wrappers, and
  the redraw schedule against the JAX functions on the same angles."""
  gen = torch.Generator().manual_seed(0)
  st, vec = twrap.rando_dir_reset(gen, 5, "cpu")
  np.testing.assert_allclose(torch.linalg.norm(vec, dim=-1).numpy(), 1.0,
                             atol=1e-6)
  assert (st.angle.abs() <= np.pi / 2).all()
  assert (st.step_count == 0).all()
  # no interval: the direction stays
  st2, vec2 = twrap.rando_dir_step(st, gen, None)
  assert torch.equal(vec2, vec) and (st2.step_count == 1).all()
  # with interval 2 the JAX function and the port redraw on the same
  # counts, given the same candidate angles
  jst = jwrap.RandoDirState(angle=jnp.asarray(st.angle[0].item()),
                            step_count=jnp.zeros((), jnp.int32))
  tst = twrap.RandoDirState(st.angle[:1], st.step_count[:1])
  for i in range(5):
    k = jax.random.fold_in(jax.random.PRNGKey(2), i)
    cand = jax.random.uniform(k, (), minval=-jnp.pi / 2, maxval=jnp.pi / 2)
    jst, jv = jwrap.rando_dir_step(jst, k, 2)
    tst, tv = twrap.rando_dir_advance(tst, torch.tensor([float(cand)]), 2)
    assert float(tst.angle[0]) == float(jst.angle)
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv), atol=1e-6)
    assert int(tst.step_count[0]) == int(jst.step_count)


def test_config_widths_match_jax():
  """proprio_dim and disp_channels by the JAX formula for every mix of
  the options."""
  for rd in (False, True):
    for rs in (False, True):
      for nd in (False, True):
        kw = dict(random_dir=rd, rotate_sensor=rs, no_displacement=nd,
                  goal=True, add_last_action_input=True)
        t, j = tenv_mod.EnvConfig(**kw), jenv_mod.EnvConfig(**kw)
        assert (t.proprio_dim, t.disp_channels) == (j.proprio_dim,
                                                    j.disp_channels), kw


@pytest.mark.parametrize("options", [
    dict(random_dir=True),
    dict(random_dir=True, rotate_sensor=True, no_displacement=False)])
def test_params_from_flax_at_the_new_proprio_widths(options):
  """The LocoTransformer converted by params_from_flax at the proprio
  widths these options give thin-goal's layout (84 + 2 = 86; 84 + 2 +
  3 x 7 = 107): the same pi_v as the flax module, at
  tests/test_torch_models.py's tolerance (2e-5, rtol 1e-4)."""
  from vision4leg_tpu.models.actor_critic import \
      LocoTransformerActorCritic as FlaxAC
  from vision4leg_torch.convert import params_from_flax
  from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
  with open(CONFIG) as f:
    build = json.load(f)["env"]["env_build"]
  build.update(options, terrain_type="plane")
  keep = {f for f in tenv_mod.EnvConfig.__dataclass_fields__}
  cfg = tenv_mod.EnvConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                              for k, v in build.items() if k in keep})
  state = cfg.proprio_dim
  assert state == {1: 86, 3: 107}[len(options)]
  assert state == jenv_mod.EnvConfig(**{
      k: getattr(cfg, k) for k in keep}).proprio_dim
  widths = dict(action_dim=6, state_input_shape=state,
                visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32, 32),
                transformer_params=((1, 64),), append_hidden_shapes=(32, 32),
                token_dim=32)
  obs_dim = state + 4 * 64 * 64
  flax_net = FlaxAC(**widths)
  params = flax_net.init(jax.random.PRNGKey(1), jnp.zeros((1, obs_dim)))
  net = LocoTransformerActorCritic(**widths)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                      strict=True)
  rng = np.random.default_rng(1)
  obs = rng.normal(size=(3, obs_dim)).astype(np.float32)
  ref = flax_net.apply(params, jnp.asarray(obs), method=flax_net.pi_v)
  with torch.no_grad():
    got = net.pi_v(torch.tensor(obs))
  ref_l = jax.tree.leaves(ref)
  got_l = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
  assert len(ref_l) == len(got_l)
  for r, g in zip(ref_l, got_l):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                               rtol=1e-4)
