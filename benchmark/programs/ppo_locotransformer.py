"""PPO on the LocoTransformer actor-critic, as the program's starter
`starter/ppo_locotransformer.py` builds it: the env of the configuration
(`get_env`), the starter's model (`locotransformer_kwargs`), its PPO
settings (`ppo_config`) and a `PPOAgent` on one device with the fused
layer on in collection and update as the configuration states; no
logger, no checkpoint, no eval (their intervals lie past any window)."""
from __future__ import annotations

import os
import tempfile

import torch

from harness.check import Capture  # noqa: F401  (the PPO capture)


def build_agent(cell, seed: int, device):
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.envs.get_env import get_env
  from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
  from vision4leg_torch.parallel import mesh as mesh_lib
  from vision4leg_torch.starter.common import (locotransformer_kwargs,
                                               ppo_config)
  params = cell.params
  env, meta = get_env(params["env_name"], params["env"], device=device)
  module = LocoTransformerActorCritic(**locotransformer_kwargs(env, params))
  fused = params["precision"]["fused_layer"]
  save_dir = tempfile.mkdtemp(prefix="v4l_bench_")
  agent = PPOAgent(
      env=env, ac_module=module, cfg=ppo_config(params),
      num_envs=cell.num_envs, seed=seed, logger=None, save_dir=save_dir,
      eval_interval=2 ** 62, save_interval=2 ** 62,
      obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"], fused_attention=fused,
      fused_update=fused, mesh=mesh_lib.Mesh(device=torch.device(device)),
      device=device)
  os.rmdir(save_dir)
  return agent


def env_class():
  from vision4leg_torch.envs.env import A1GymEnv
  return A1GymEnv


def fault_targets() -> dict:
  from vision4leg_torch.algo.on_policy_base import MaskedAdam
  from vision4leg_torch.algo.ppo import PPOLearner
  from vision4leg_torch.data import normalizer
  from vision4leg_torch.envs.env import A1GymEnv
  from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
  return {"optimizer": MaskedAdam, "learner": PPOLearner,
          "normalizer": normalizer, "env": A1GymEnv,
          "model": LocoTransformerActorCritic}
