"""The sim2sim starter's pieces, the agent's separate eval env and the
curriculum cap, against the JAX package on the CPU.

  * `sim2sim_eval_params` of the port's starter against the JAX starter's
    function, on every shipped Nature-CNN config; the eval env it gives
    builds with the same EnvConfig as the JAX package's (the MPC env
    refuses the MMDR options the transform sets, which the JAX MPC env
    ignores);
  * an agent eval on a separate env (the plane, camera off, a different
    alive reward, so its returns tell which env ran) with the training
    collector's normalizer, against the JAX agent's eval on the same
    envs, weights (convert.params_from_flax) and normalizer: returns
    2e-3 and step counts exactly, as tests/test_torch_agent_eval.py holds
    them; the normalizer the eval reads is the training collector's
    object;
  * `curriculum_episode_length` at a few step counts and the agent's
    per-epoch cap against the JAX functions, exactly (both in float32
    then truncated), and train() feeds the cap to each epoch.
"""
import dataclasses
import glob
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starter.ppo_nature_cnn_sim2sim import \
    sim2sim_eval_params as jax_sim2sim
from vision4leg_tpu.algo.agent import PPOAgent as JaxAgent
from vision4leg_tpu.algo.ppo import PPOConfig as JaxPPOConfig
from vision4leg_tpu.data import normalizer as jnorm
from vision4leg_tpu.envs import env as jenv_mod
from vision4leg_tpu.envs import wrappers as jwrappers
from vision4leg_tpu.envs.get_env import \
    env_config_from_build_params as jax_env_config
from vision4leg_tpu.models.actor_critic import StateActorCritic as FlaxAC
from vision4leg_torch import convert
from vision4leg_torch.algo.agent import PPOAgent
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.data import normalizer as tnorm
from vision4leg_torch.envs import env as tenv_mod
from vision4leg_torch.envs import wrappers as twrappers
from vision4leg_torch.models.actor_critic import StateActorCritic
from vision4leg_torch.starter import common
from vision4leg_torch.starter.ppo_nature_cnn_sim2sim import \
    sim2sim_eval_params

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config")
NATURE = sorted(
    os.path.relpath(p, ROOT)[:-5]
    for p in glob.glob(os.path.join(ROOT, "**", "*.json"), recursive=True)
    if any(d in p for d in ("baseline", "frame_extract4"))
    and "state-only" not in p)
E = 2
HORIZON = 3
STATE = 57       # plane, no goal: HSW(BaseDisplacement) + IMU + MotorAngle
PLANE = dict(terrain_type="plane", time_step_s=0.0025, num_action_repeat=4,
             diagonal_act=True, clip_num=(0.05, 0.5, 0.5) * 4,
             settle_steps=20)


def _params(name):
  with open(os.path.join(ROOT, name + ".json")) as f:
    return json.load(f)


def test_every_nature_config_is_covered():
  assert len(NATURE) == 54
  assert sum(n.startswith("mpc") for n in NATURE) == 10


@pytest.mark.parametrize("name", NATURE)
def test_sim2sim_eval_params_match_jax(name):
  params = _params(name)
  ours = sim2sim_eval_params(json.loads(json.dumps(params["env"])))
  theirs = jax_sim2sim(json.loads(json.dumps(params["env"])))
  assert ours == theirs
  assert ours["horizon"] == 2000
  assert ours["env_build"]["reset_frame_idx_each_step"] is True
  eval_params = dict(params, env=ours)
  if params["env_name"] == "A1MoveGroundMPC":
    with pytest.raises(NotImplementedError, match="accepts and ignores"):
      common.eval_env_of(eval_params, lambda p: p, "cpu")
    return
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # random_shape is ignored
    env, horizon = common.eval_env_of(params, sim2sim_eval_params, "cpu")
  assert horizon == 2000
  want = dataclasses.asdict(jax_env_config(ours["env_build"]))
  assert dataclasses.asdict(env.cfg) == want


def test_eval_env_of_leaves_the_training_params_alone():
  params = _params("rl/static/frame_extract4_random_delay/thin-goal")
  before = json.dumps(params)
  env, horizon = common.eval_env_of(params, sim2sim_eval_params, "cpu")
  assert horizon == 2000 and json.dumps(params) == before
  assert env.cfg.reset_frame_idx_each_step and env.cfg.frame_extract == 4
  assert common.eval_env_of(params, None) == (None, None)


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
  """The JAX agent and the port's on the plane (curriculum on) with an
  eval env of another alive reward, the same weights and normalizer."""
  jcfg = jenv_mod.EnvConfig(**PLANE, curriculum=True)
  jenv = jenv_mod.A1GymEnv(jcfg)
  jeval = jenv_mod.A1GymEnv(dataclasses.replace(jcfg, alive_reward=0.5,
                                                curriculum=False))
  net = FlaxAC(action_dim=6, hidden_shapes=(32, 32),
               append_hidden_shapes=(16,))
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    jagent = JaxAgent(
        env=jenv, ac_module=net,
        cfg=JaxPPOConfig(epoch_frames=2 * E, max_episode_frames=999),
        num_envs=E, seed=0, logger=None,
        save_dir=str(tmp_path_factory.mktemp("jax_agent")),
        num_eval_envs=E, eval_env=jeval, eval_horizon=HORIZON)
  template = convert.robot_state(
      jax.tree.map(np.asarray, jenv.settled_template()))
  tenv = tenv_mod.A1GymEnv(tenv_mod.EnvConfig(**PLANE, curriculum=True),
                           device="cpu")
  teval = tenv_mod.A1GymEnv(tenv_mod.EnvConfig(**PLANE, alive_reward=0.5),
                            device="cpu")
  tenv._template = teval._template = template
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    tagent = PPOAgent(
        env=tenv, ac_module=StateActorCritic(
            action_dim=6, state_input_shape=STATE, hidden_shapes=(32, 32),
            append_hidden_shapes=(16,)),
        cfg=PPOConfig(epoch_frames=2 * E, num_epochs=1), num_envs=E,
        seed=0, logger=_NullLogger(), eval_interval=100,
        save_dir=str(tmp_path_factory.mktemp("torch_agent")),
        num_eval_envs=E, eval_env=teval, eval_horizon=HORIZON, device="cpu")
  tagent.module.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, jagent.train_state.params)))
  return jagent, tagent


class _NullLogger:
  def add_epoch_info(self, *a, **k):
    pass

  def log(self, *a, **k):
    pass


def test_eval_on_a_separate_env_matches_jax(agents, monkeypatch):
  jagent, tagent = agents
  rng = np.random.default_rng(4)
  nrm = jnorm.NormalizerState(
      mean=jnp.asarray(rng.normal(0, 0.1, STATE).astype(np.float32)),
      var=jnp.asarray(rng.uniform(0.5, 2.0, STATE).astype(np.float32)),
      count=jnp.asarray(100.0))
  jret, jsteps = jagent._eval(jagent.train_state.params, nrm,
                              jax.random.PRNGKey(1))
  tagent.collector_state = tagent.collector_state.replace(
      normalizer=tnorm.NormalizerState(*(torch.tensor(np.asarray(x)) for x in
                                         (nrm.mean, nrm.var, nrm.count))))
  seen = []
  filt = tnorm.filt_with_img_tail

  def recording(nstate, raw, proprio_dim):
    seen.append((nstate, proprio_dim))
    return filt(nstate, raw, proprio_dim)

  monkeypatch.setattr(tnorm, "filt_with_img_tail", recording)
  tret, tsteps = tagent.evaluate()
  np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=2e-3)
  np.testing.assert_array_equal(tsteps.numpy(), np.asarray(jsteps))
  assert len(seen) == HORIZON
  for nstate, proprio_dim in seen:
    assert nstate is tagent.collector_state.normalizer
    assert proprio_dim == tagent.eval_env.cfg.proprio_dim
  # the eval env's alive reward of 0.5 dominates its returns (the
  # training env's is 0.1): the eval ran on the eval env
  assert (tret > 0.5 * HORIZON - 0.3).all()


@pytest.mark.parametrize("steps", [0, 1, 31_250, 200_000, 600_000,
                                   1_250_000, 5_000_000])
def test_curriculum_episode_length_matches_jax(steps):
  got = twrappers.curriculum_episode_length(steps)
  want = jwrappers.curriculum_episode_length(jnp.asarray(steps))
  assert got.dtype == torch.int32 and int(got) == int(want)


def test_agent_curriculum_cap_matches_jax(agents, monkeypatch):
  jagent, tagent = agents
  caps = []
  for frames in (0, 2 * 31_250, 2 * 600_000, 2 * 1_300_000):
    jagent.total_frames = tagent.total_frames = frames
    want = int(jagent._curriculum_episode_cap())
    assert tagent._curriculum_episode_cap() == want
    caps.append(want)
  assert caps[0] == 1000 and caps[-1] == 2000 and caps[1] < caps[2]
  # train() hands each epoch its cap
  tagent.total_frames = 2 * 600_000
  fed = []
  monkeypatch.setattr(tagent, "train_epoch", lambda max_ep=None: (
      fed.append(max_ep), {})[1])
  tagent.train()
  assert fed == [caps[2]]
