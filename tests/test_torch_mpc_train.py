"""PPO training of the port on A1MoveGroundMPC, proprio and vision-only,
against the JAX package on the CPU (its eval:
tests/test_torch_mpc_eval.py).

* One PPO update epoch on a trajectory collected from the port's MPC env
  (action_dim 2; 3 envs with batch_size 2, so that a minibatch is one
  whole time row of 3 samples, the rule that makes the MPC config's
  batch_size 512 a minibatch of 1024 at 1024 envs) against the JAX
  learner, both in float64: the parameters at 1e-9, the update's metrics
  at 1e-8 relative (tests/test_torch_ppo.py says why float32 is not
  compared).
* Train epochs on the proprio form, whose checkpoint restores bit for
  bit and resumes to the same next epoch; one on the vision-only form,
  with its zero-size proprio normalizer (tests/test_train_loop.py::
  test_vision_only_epoch_zero_proprio).
* The starters' pieces on the four MPC configs of this family, and the
  random_blocks_sparse terrain of the thin.json configs.

The MPC config is cut to policy_freq 2 and a settle of 20 substeps.
"""
import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.algo.ppo import PPOConfig as JPPOConfig
from vision4leg_tpu.algo.ppo import PPOLearner as JPPOLearner
from vision4leg_tpu.collector.rollout import Transition as JTransition
from vision4leg_tpu.envs import terrain as jterr
from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_torch.algo.agent import PPOAgent, _flatten
from vision4leg_torch.algo.on_policy_base import minibatches
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner
from vision4leg_torch.collector import rollout as troll
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.envs import mpc_env as tmpc_env
from vision4leg_torch.envs import terrain as tterr
from vision4leg_torch.envs.get_env import get_env as torch_get_env
from vision4leg_torch.models.actor_critic import (
    LocoTransformerActorCritic, VisionOnlyTransformerActorCritic)
from vision4leg_torch.starter import common
from vision4leg_torch.starter import ppo_locotransformer as starter
from vision4leg_torch.starter import \
    ppo_locotransformer_vision_only as vo_starter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "proprio": "config/mpc/locotransformer/thin-goal.json",
    "vision_only": "config/mpc_vision_only/locotransformer/thin-goal.json",
}
PROPRIO = 6
WIDTHS = dict(action_dim=2, visual_input_shape=(4, 64, 64),
              encoder_hidden_shapes=(16,),
              transformer_params=((1, 32), (1, 32)),
              append_hidden_shapes=(16,), token_dim=16)
MODELS = {"proprio": (LocoTransformerActorCritic, PROPRIO),
          "vision_only": (VisionOnlyTransformerActorCritic, 0)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  """The port's CPU path here is many small eager ops; with the suite's
  workers sharing the cores, torch's intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _params(path, policy_freq=2):
  with open(os.path.join(ROOT, path)) as f:
    params = json.load(f)
  params["env"]["env_build"]["policy_freq"] = policy_freq
  return params


def _cpu_env(form, settle_steps=20, policy_freq=2):
  params = _params(CONFIGS[form], policy_freq)
  env, meta = torch_get_env(params["env_name"], params["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=settle_steps)
  return env, meta, params


# ---------------------------------------------------------------------------
# one PPO update epoch against the JAX learner, float64
# ---------------------------------------------------------------------------

UPD_T, UPD_E = 4, 3
UPD_CFG = dict(plr=3e-4, vlr=4e-4, clip_para=0.2, entropy_coeff=0.005,
               discount=0.99, tau=0.95, batch_size=2,
               epoch_frames=UPD_T * UPD_E, opt_epochs=2, num_epochs=4,
               shuffle=True)


@pytest.fixture(scope="module")
def update_pair():
  """A (T, E) = (4, 3) trajectory collected by the port's collector on
  the proprio MPC env with the flax weights converted; then one update
  epoch of the JAX learner and of the port's, float64."""
  torch_cls, proprio = MODELS["proprio"]
  env, meta, _ = _cpu_env("proprio")
  flax_net = FlaxAC(state_input_shape=proprio, **WIDTHS)
  with jax.enable_x64(True):
    params = flax_net.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, env.obs_dim)))
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
  net = torch_cls(state_input_shape=proprio, **WIDTHS)
  net.load_state_dict(params_from_flax(params))
  gen = torch.Generator().manual_seed(4)
  cs = troll.init_collector(env, UPD_E, gen)
  rollout = troll.make_rollout_fn(
      env, net.pi_v, net.v, horizon=UPD_T, max_episode_frames=999,
      discount=0.99, proprio_dim=proprio, obs_norm=meta["obs_norm"],
      action_low=env.action_low, action_high=env.action_high)
  _, traj, last_v = rollout(cs)
  traj = {k: v.double().numpy() if v.dtype != torch.bool else v.numpy()
          for k, v in traj._asdict().items()}
  last_v = last_v.double().numpy()

  key = jax.random.PRNGKey(9)
  perms = np.stack([np.asarray(jax.random.permutation(k, UPD_T))
                    for k in jax.random.split(key, UPD_CFG["opt_epochs"])])
  with jax.enable_x64(True):
    learner = JPPOLearner(
        JPPOConfig(**UPD_CFG),
        lambda p, x: flax_net.apply(p, x, method=flax_net.pi),
        lambda p, x: flax_net.apply(p, x, method=flax_net.v), params)
    ts, jm = jax.jit(learner.update_per_epoch)(
        learner.init_state(params),
        JTransition(**{k: jnp.asarray(v) for k, v in traj.items()}),
        jnp.asarray(last_v), key)
    jparams = params_from_flax(jax.tree.map(np.asarray, ts.params))
    jm = {k: float(v) for k, v in jm.items()}

  net64 = torch_cls(state_input_shape=proprio, **WIDTHS).double()
  net64.load_state_dict(params_from_flax(params))
  tl = PPOLearner(PPOConfig(**UPD_CFG), lambda m, x: m.pi(x),
                  lambda m, x: m.v(x), net64)
  _, tm = tl.update_per_epoch(
      tl.init_state(net64),
      Transition(**{k: torch.tensor(v) for k, v in traj.items()}),
      torch.tensor(last_v), perms=perms)
  return (params_from_flax(params), jparams, jm, net64.state_dict(),
          {k: float(v) for k, v in tm.items()}, traj)


def test_update_on_an_mpc_trajectory_matches_jax(update_pair):
  init, jparams, jm, tparams, tm, traj = update_pair
  assert traj["acts"].shape == (UPD_T, UPD_E, 2)
  assert minibatches(PPOConfig(**UPD_CFG), UPD_T, UPD_E) == (1, UPD_T)
  assert set(tparams) == set(jparams)
  for name, ref in jparams.items():
    np.testing.assert_allclose(tparams[name].numpy(), ref.numpy(),
                               atol=1e-9, rtol=0, err_msg=name)
  assert all(not torch.equal(init[n], tparams[n]) for n in init)
  # the metrics are means over the minibatches, whose parameters part by
  # up to the 1e-9 above; a log-prob moves by (a - mean) / std**2, up to
  # ~10x a policy mean, and the ratio with it: 1e-8 relative
  assert set(tm) == set(jm)
  for k, v in jm.items():
    np.testing.assert_allclose(tm[k], v, atol=1e-9, rtol=1e-8, err_msg=k)


def test_minibatch_rows_follow_the_env_count():
  """The MPC config's batch_size 512: minibatches of 1024 at 1024 envs,
  of 512 at 512 or 128 envs."""
  cfg = common.ppo_config(_params(CONFIGS["proprio"], 20))
  assert (cfg.batch_size, cfg.opt_epochs, cfg.epoch_frames) == (512, 3, 8192)
  assert minibatches(cfg, 8, 1024) == (1, 8)
  assert minibatches(cfg, 16, 512) == (1, 16)
  assert minibatches(cfg, 64, 128) == (4, 16)


# ---------------------------------------------------------------------------
# train epochs, checkpoint and resume
# ---------------------------------------------------------------------------

class _NullLogger:
  def __init__(self):
    self.rows = []

  def add_epoch_info(self, epoch, frames, seconds, infos):
    self.rows.append(infos)

  def log(self, *a, **k):
    pass


def _train_agent(form, save_dir, seed=0):
  env, meta, _ = _cpu_env(form)
  torch_cls, proprio = MODELS[form]
  cfg = PPOConfig(plr=1e-3, vlr=1e-3, opt_epochs=2, batch_size=4,
                  epoch_frames=12, max_episode_frames=3, num_epochs=2)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    return PPOAgent(
        env=env, ac_module=torch_cls(state_input_shape=proprio, **WIDTHS),
        cfg=cfg, num_envs=3, seed=seed, logger=_NullLogger(),
        save_dir=str(save_dir), obs_norm=meta["obs_norm"], eval_interval=1,
        save_interval=1, num_eval_envs=2, eval_horizon=2,
        fused_attention=True, fused_update=True, device="cpu")


def _state(agent):
  ts = agent.train_state
  out = {f"module.{k}": v for k, v in agent.module.state_dict().items()}
  for side in ("pf_opt", "vf_opt"):
    st = getattr(ts, side)
    out.update({f"{side}.mu.{i}": x for i, x in enumerate(st.mu)})
    out.update({f"{side}.nu.{i}": x for i, x in enumerate(st.nu)})
    out[f"{side}.count"] = torch.tensor(st.count)
  out.update(_flatten(agent.collector_state, "cs", {}))
  out["gen.collect"] = agent.collector_state.gen.get_state()
  out["gen.update"] = agent.update_gen.get_state()
  out["gen.eval"] = agent.eval_gen.get_state()
  return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  """Two epochs of train() on the proprio MPC env (3 envs, 4 steps an
  epoch with an episode cap of 3, so that the rollout bootstraps and
  resets envs; an eval of 2 envs x 2 steps and a checkpoint after each),
  then a second agent restored from the checkpoint, and both trained one
  epoch more."""
  save_dir = tmp_path_factory.mktemp("mpc_proprio")
  agent = _train_agent("proprio", save_dir)
  settles = agent.env.settle_windows
  init = {k: v.clone() for k, v in agent.module.state_dict().items()}
  agent.train()
  settles = agent.env.settle_windows - settles
  other = _train_agent("proprio", save_dir, seed=1)
  assert other.restore_checkpoint() == 2
  restored = (_state(agent), _state(other))
  resumed = []
  for a in (agent, other):
    a.train_epoch()
    resumed.append(_state(a))
  return agent, init, settles, restored, resumed


def test_train_epoch_on_the_mpc_env(trained):
  agent, init, settles, _, _ = trained
  assert len(agent.logger.rows) == 2
  infos = agent.logger.rows[-1]
  assert all(np.isfinite(v) for v in infos.values()), infos
  for k in ("Training/policy_loss", "Training/vf_loss",
            "Eval_Rewards_Average"):
    assert k in infos
  assert infos["diagnostics/nonfinite_obs"] == 0
  assert all(not torch.equal(v, init[k])
             for k, v in agent.module.state_dict().items())
  cs = agent.collector_state
  assert isinstance(cs.env_states, tmpc_env.MpcEnvState)
  assert cs.env_states.controller.qp_warm.kinv.shape == (3, 120, 120)
  # each epoch's rollout reaches the episode cap once and its eval resets
  # its envs once: a settle launch each (more where an env fell)
  assert settles >= 4
  assert cs.normalizer.mean.shape == (PROPRIO,)


def test_checkpoint_restores_and_resumes_bit_for_bit(trained):
  _, _, _, (a, b), (ra, rb) = trained
  assert set(a) == set(b)
  assert any(k.startswith("cs.env_states.controller.qp_warm") for k in a)
  for k in a:
    assert torch.equal(a[k], b[k]), k
  for k in ra:
    assert torch.equal(ra[k], rb[k]), k


def test_vision_only_epoch_zero_proprio(tmp_path):
  """tests/test_train_loop.py::test_vision_only_epoch_zero_proprio on the
  port: the vision-only env's proprio normalizer is zero-size, and one
  epoch gives its drift max the value 0 and a finite loss."""
  agent = _train_agent("vision_only", tmp_path)
  assert agent.env.cfg.proprio_dim == 0
  metrics = {k: float(v) for k, v in agent.train_epoch().items()}
  assert metrics["diagnostics/obs_norm_var_max"] == 0.0
  assert np.isfinite(metrics["Training/policy_loss"])
  assert np.isfinite(metrics["Training/vf_loss"])
  cs = agent.collector_state
  assert cs.normalizer.mean.shape == (0,)
  assert cs.raw_obs.shape == (3, 4 * 64 * 64)


# ---------------------------------------------------------------------------
# the starters' pieces and the thin.json terrain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [
    "config/mpc/locotransformer/thin.json",
    "config/mpc/locotransformer/thin-goal.json",
    "config/mpc_vision_only/locotransformer/thin.json",
    "config/mpc_vision_only/locotransformer/thin-goal.json"])
def test_starter_pieces_read_the_mpc_configs(path):
  with open(os.path.join(ROOT, path)) as f:
    params = json.load(f)
  env, meta = torch_get_env(params["env_name"], params["env"], device="cpu")
  vision_only = "vision_only" in path
  assert isinstance(env, tmpc_env.A1MPCGymEnv)
  assert env.cfg.vision_only == vision_only
  assert env.cfg.terrain_type == ("random_blocks_sparse" if path.endswith(
      "thin.json") else "random_blocks_sparse_with_subgoal")
  proprio = 0 if vision_only else PROPRIO
  assert env.cfg.proprio_dim == proprio
  assert env.obs_dim == proprio + 4 * 64 * 64 and meta["obs_norm"]
  build = vo_starter.build_module if vision_only else starter.build_module
  net = build(env, params)
  assert isinstance(net, VisionOnlyTransformerActorCritic if vision_only
                    else LocoTransformerActorCritic)
  assert net.logstd.shape == (2,)
  assert [layer.ff1.out_features for layer in net.pf_layers] == [256, 256]
  assert net.pf_mlp.layers[0].in_features == (64 if vision_only else 128)
  cfg = common.ppo_config(params)
  assert (cfg.batch_size, cfg.opt_epochs, cfg.epoch_frames) == (512, 3, 8192)
  assert common.num_eval_envs(params) == 8


def test_random_blocks_sparse_resets_as_jax():
  """The thin.json terrain: the JAX generator's box count, fence, subgoal
  and goal shapes, render cap and init position; an MPC reset on it."""
  name = "random_blocks_sparse"
  ref = jterr.TERRAIN_GENERATORS[name](jax.random.PRNGKey(0))
  got = tterr.TERRAIN_GENERATORS[name](torch.Generator().manual_seed(0), 2,
                                       "cpu")
  assert got.boxes.shape == (2,) + ref.boxes.shape == (2, 52, 8)
  np.testing.assert_allclose(got.boxes[0, -2:].numpy(),
                             np.asarray(ref.boxes[-2:]), rtol=1e-6)
  assert got.subgoals.shape == (2,) + ref.subgoals.shape
  assert got.goal_pos.shape == (2,) + ref.goal_pos.shape
  assert got.obstacle_spheres.shape[1] == 0
  assert tterr.RENDER_BOX_CAPS[name] == jterr.RENDER_BOX_CAPS[name]
  assert tterr.INIT_POSITION[name] == jterr.INIT_POSITION[name]
  assert name in jterr.FLAT_TERRAINS

  params = _params("config/mpc/locotransformer/thin.json")
  env, _ = torch_get_env(params["env_name"], params["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=20)
  state, obs = env.reset(2, torch.Generator().manual_seed(1))
  assert state.terrain.boxes.shape == (2, 52, 8)
  start = state.last_base_pos
  init = torch.tensor(jterr.INIT_POSITION[name])
  r = env.cfg.random_init_range
  assert (torch.abs(start[:, :2] - init[:2]) <= r + 0.05).all()
  assert torch.isfinite(obs).all() and obs.shape == (2, env.obs_dim)
