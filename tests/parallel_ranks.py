"""Rank functions of tests/test_torch_parallel.py, in a module of their
own that imports no JAX: each spawned rank imports it by name
(`parallel.mesh.run_ranks` pickles a function by its import path)."""
import dataclasses
import json
import os.path as osp
import warnings

import numpy as np
import torch

from vision4leg_torch.algo.agent import PPOAgent, _flatten
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.data import normalizer as norm
from vision4leg_torch.envs.env import A1GymEnv
from vision4leg_torch.envs.get_env import env_config_from_build_params
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
from vision4leg_torch.parallel import mesh as mesh_lib

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "config/rl/static/locotransformer/thin-goal.json")
NUM_ENVS = 4
HORIZON = 4
# widths of tests/test_torch_ppo.py's update parity
WIDTHS = dict(action_dim=6, visual_input_shape=(4, 64, 64),
              encoder_hidden_shapes=(32,),
              transformer_params=((1, 64), (1, 64)),
              append_hidden_shapes=(32,), token_dim=32)


def sharded_update(mesh, flax_params, traj, last_value, perms, raw,
                   cfg_kw):
  """One PPO update_per_epoch on this rank's envs of a float32
  trajectory (T, E, ...) from flax weights, and the normalizer's merge of
  this rank's rows of `raw` (E, D): (state_dict, metrics, normalizer)."""
  sl = mesh.env_slice(traj["rewards"].shape[1])
  net = LocoTransformerActorCritic(state_input_shape=40, **WIDTHS)
  net.load_state_dict(params_from_flax(flax_params))
  learner = PPOLearner(PPOConfig(**cfg_kw), lambda m, x: m.pi(x),
                       lambda m, x: m.v(x), net, mesh)
  ttraj = Transition(**{k: torch.from_numpy(v[:, sl].copy())
                        for k, v in traj.items()})
  _, metrics = learner.update_per_epoch(
      learner.init_state(net), ttraj, torch.from_numpy(last_value[sl]),
      perms=perms)
  nstate = norm.update(norm.init_normalizer(raw.shape[1]),
                       torch.from_numpy(raw[mesh.env_slice(raw.shape[0])]),
                       mesh)
  return ({k: v.numpy() for k, v in net.state_dict().items()},
          {k: float(v) for k, v in metrics.items()},
          (nstate.mean.numpy(), nstate.var.numpy(), float(nstate.count)))


def _thin_goal_env():
  with open(CONFIG) as f:
    params = json.load(f)
  cfg = dataclasses.replace(
      env_config_from_build_params(params["env"]["env_build"]),
      settle_steps=20)
  return A1GymEnv(cfg, device="cpu")


def _agent(mesh, save_dir, seed=0):
  env = _thin_goal_env()
  net = LocoTransformerActorCritic(state_input_shape=env.cfg.proprio_dim,
                                   **WIDTHS)
  # episodes of 3 steps in a 4-step rollout: partial resets happen
  cfg = PPOConfig(plr=1e-3, vlr=1e-3, opt_epochs=2, batch_size=8,
                  epoch_frames=HORIZON * NUM_ENVS, max_episode_frames=3,
                  num_epochs=2)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    return PPOAgent(env=env, ac_module=net, cfg=cfg, num_envs=NUM_ENVS,
                    seed=seed, logger=None, save_dir=save_dir,
                    obs_norm=True, mesh=mesh, device="cpu")


def _global(mesh, x, dim):
  """x's global tensor: the ranks' parts concatenated along `dim`."""
  if mesh is None:
    return x
  parts = mesh.all_gather(x)
  return torch.cat(list(parts), dim=dim)


def epoch(mesh, save_dir, traj_in=None):
  """A rank's (or, with mesh None, the unranked agent's) thin-goal epoch:
  the initial collector, a 4-step rollout with partial resets, then the
  learner in float64 on `traj_in` ((Transition fields, last value) of the
  global batch, numpy; the rank's envs taken) or on the rollout's own
  trajectory; then, from a fresh agent, a float32 train_epoch and a
  checkpoint restored into a third agent.  Tensors come back global
  (gathered over the ranks) where they are per env."""
  agent = _agent(mesh, save_dir)
  flat = _flatten(agent.collector_state, "cs", {})
  out = {"init": mesh_lib.gather_collector_state(mesh, flat) if mesh
         else flat}
  cs, traj, last_v = agent.rollout(agent.collector_state)
  out["traj"] = {k: _global(mesh, v, 1) for k, v in traj._asdict().items()}
  out["last_v"] = _global(mesh, last_v, 0)
  out["normalizer"] = (cs.normalizer.mean, cs.normalizer.var,
                       cs.normalizer.count)
  if traj_in is not None:
    fields, last = traj_in
    sl = mesh.env_slice(NUM_ENVS) if mesh else slice(None)
    traj = Transition(**{k: torch.from_numpy(v[:, sl].copy())
                         for k, v in fields.items()})
    last_v = torch.from_numpy(last[sl].copy())
  agent.module.double()
  ts = agent.learner.init_state(agent.module)
  tr64 = Transition(*(x.double() if x.is_floating_point() else x
                      for x in traj))
  ts, metrics = agent.learner.update_per_epoch(ts, tr64, last_v.double(),
                                               gen=agent.update_gen)
  out["params64"] = {k: v.clone() for k, v in
                     agent.module.state_dict().items()}
  out["metrics64"] = {k: float(v) for k, v in metrics.items()}

  agent = _agent(mesh, save_dir)
  metrics = agent.train_epoch()
  out["epoch_metrics"] = {k: float(v) for k, v in metrics.items()}
  out["params"] = {k: v.clone() for k, v in agent.module.state_dict().items()}
  out["finished"] = float(agent.collector_state.finished_count)
  agent.save_checkpoint(epoch=0)
  other = _agent(mesh, save_dir, seed=7)
  assert other.restore_checkpoint() == 1
  mine = _flatten(agent.collector_state, "cs", {})
  theirs = _flatten(other.collector_state, "cs", {})
  out["restored_equal"] = all(torch.equal(mine[k], theirs[k]) for k in mine
                              if "finished" not in k)
  out["restored_finished"] = float(other.collector_state.finished_count)
  return out


MPC_CONFIG = osp.join(ROOT, "config/mpc/locotransformer/thin-goal.json")


def mpc_rollout(mesh, save_dir):
  """The MPC env (policy_freq 2, the settle cut to 20 steps) at 4 envs: the
  initial collector and a 2-step rollout, gathered over the ranks."""
  from vision4leg_torch.envs.get_env import get_env
  with open(MPC_CONFIG) as f:
    params = json.load(f)
  params["env"]["env_build"]["policy_freq"] = 2
  env, _ = get_env(params["env_name"], params["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=20)
  net = LocoTransformerActorCritic(
      action_dim=env.cfg.action_dim, state_input_shape=env.cfg.proprio_dim,
      encoder_hidden_shapes=(16,), transformer_params=((1, 32),),
      append_hidden_shapes=(16,), token_dim=16)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    agent = PPOAgent(env=env, ac_module=net,
                     cfg=PPOConfig(epoch_frames=2 * NUM_ENVS, batch_size=8),
                     num_envs=NUM_ENVS, seed=0, logger=None,
                     save_dir=save_dir, mesh=mesh, device="cpu")
  flat = _flatten(agent.collector_state, "cs", {})
  init = mesh_lib.gather_collector_state(mesh, flat) if mesh else flat
  _, traj, _ = agent.rollout(agent.collector_state)
  return init, {k: _global(mesh, v, 1) for k, v in traj._asdict().items()}
