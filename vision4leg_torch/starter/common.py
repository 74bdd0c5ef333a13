"""Shared experiment wiring for the port's starter scripts (torch mirror of
starter/common.py): parse args + JSON config, build env / network /
collector / PPO, call train().  Runs on the card."""
from __future__ import annotations

import copy
import os
import os.path as osp
import random

import numpy as np
import torch

from vision4leg_torch.algo.agent import PPOAgent
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.parallel import mesh as mesh_lib
from vision4leg_torch.utils.args import get_args, get_params
from vision4leg_torch.utils.logger import PPO_COLUMNS, Logger


def _flag(name: str) -> bool:
  return os.environ.get(name, "") not in ("", "0")


def ppo_config(params: dict, num_epochs=None) -> PPOConfig:
  """The PPOConfig of a reference JSON config (starter/common.py:78-93)."""
  gs = params["general_setting"]
  ppo = params["ppo"]
  return PPOConfig(
      plr=ppo["plr"], vlr=ppo["vlr"], clip_para=ppo.get("clip_para", 0.2),
      opt_epochs=ppo.get("opt_epochs", 10),
      clipped_value_loss=ppo.get("clipped_value_loss", False),
      entropy_coeff=ppo.get("entropy_coeff", 0.001),
      discount=gs.get("discount", 0.99),
      tau=ppo.get("tau", 0.95),
      gae=gs.get("gae", True),
      shuffle=ppo.get("shuffle", True),
      batch_size=gs.get("batch_size", 1024),
      num_epochs=num_epochs or gs.get("num_epochs", 1500),
      epoch_frames=params["collector"].get("epoch_frames", 16384),
      max_episode_frames=params["collector"].get("max_episode_frames", 999),
      time_limit_filter=params["replay_buffer"].get("time_limit_filter",
                                                    True),
  )


def num_eval_envs(params: dict) -> int:
  """The reference evaluates eval_episodes (=2) episodes per eval pass; the
  JAX package runs max(8, eval_episodes) envs for a less noisy best-model
  choice, and V4L_STRICT_EVAL=1 restores the reference's count."""
  episodes = params["collector"].get("eval_episodes", 2)
  return episodes if _flag("V4L_STRICT_EVAL") else max(8, episodes)


def locotransformer_kwargs(env, params: dict) -> dict:
  """The LocoTransformer actor-critics' arguments from a JSON config (4
  depth frames; rgbd is rejected by the env)."""
  enc = params.get("encoder", {})
  net = params.get("net", {})
  return dict(
      action_dim=env.cfg.action_dim,
      state_input_shape=env.cfg.proprio_dim,
      visual_input_shape=(4, 64, 64),
      encoder_hidden_shapes=tuple(enc.get("hidden_shapes", (256, 256))),
      transformer_params=tuple(
          tuple(p) for p in net.get("transformer_params",
                                    ((1, 256), (1, 256)))),
      append_hidden_shapes=tuple(net.get("append_hidden_shapes",
                                         (256, 256))),
      max_pool=net.get("max_pool", False),
      **params.get("policy", {}))


def nature_kwargs(env, params: dict) -> dict:
  """The Nature-CNN actor-critics' arguments from a JSON config (4 depth
  frames; rgbd is rejected by the env)."""
  enc = params.get("encoder", {})
  net = params.get("net", {})
  return dict(
      action_dim=env.cfg.action_dim,
      state_input_shape=env.cfg.proprio_dim,
      visual_input_shape=(4, 64, 64),
      encoder_hidden_shapes=tuple(enc.get("hidden_shapes", (256, 256))),
      visual_dim=enc.get("visual_dim", 256),
      append_hidden_shapes=tuple(net.get("append_hidden_shapes",
                                         (256, 256))),
      **params.get("policy", {}))


def eval_env_of(params: dict, eval_params_transform, device=None):
  """(eval env, its horizon) built on `device` from the transformed copy
  of params["env"] (starter/common.py:54-59), or (None, None) without a
  transform."""
  if eval_params_transform is None:
    return None, None
  eval_env_params = eval_params_transform(copy.deepcopy(params["env"]))
  eval_env, eval_meta = get_env(params["env_name"], eval_env_params,
                                device=device)
  return eval_env, eval_meta["horizon"]


def choose_world(num_envs: int, log=print) -> int:
  """The ranks a run starts: one per visible card when there are several
  and num_envs divides among them, else one (logged), as the JAX starter
  shards its env axis over every local device (starter/common.py:95-108);
  V4L_MESH=0 opts out."""
  n = torch.cuda.device_count()
  if n <= 1 or os.environ.get("V4L_MESH", "1") == "0":
    return 1
  if num_envs % n:
    log(f"V4L_MESH skipped: num_envs={num_envs} not divisible by {n} "
        f"devices")
    return 1
  return n


def run_experiment(build_module, eval_params_transform=None):
  """build_module(env, params) -> uninitialized torch actor-critic.

  eval_params_transform(env_params) -> env_params: when given, evaluation
  runs on a separate env built from the transformed copy of
  params["env"] (sim-to-sim transfer, reference
  ppo_nature_cnn_sim2sim.py:43-60), with the training env's obs
  normalizer, as in the reference.  V4L_BF16_COLLECT=1 runs the
  collection forward in bfloat16 (the PPO update stays float32).
  V4L_FUSED_ATTN=1 runs the collection forward through the fused layer
  kernel, and with V4L_FUSED_UPDATE=1 also the update and eval (off by
  default, as in the JAX starter).  On a
  host with several cards the run starts one rank per card (NCCL) and
  shards the envs over them (`choose_world`); both callables are then
  pickled by their import path.  Returns the agent (None under ranks)."""
  args = get_args()
  num_envs = args.num_envs or max(args.vec_env_nums, 1)
  world = choose_world(num_envs)
  if world == 1:
    return train_run(None, args, build_module, eval_params_transform)
  print(f"env axis sharded over {world} ranks, one a card (NCCL); at "
        f"1024 envs the ranks train no faster than one card (the update's "
        f"minibatches do not shrink with ranks: PERF.md section 7); "
        f"V4L_MESH=0 keeps one card", flush=True)
  mesh_lib.run_ranks(train_run, world, (args, build_module,
                                        eval_params_transform),
                     backend="nccl", timeout_s=None)
  return None


def train_run(mesh, args, build_module, eval_params_transform=None):
  """One training run of the parsed starter `args` on this process's card
  (`mesh`'s under ranks: rank 0 logs and writes the run's files).
  Returns the agent, or None on a rank."""
  params = get_params(args.config)
  device = None if mesh is None else mesh.device
  env, meta = get_env(params["env_name"], params["env"], device=device)
  eval_env, eval_horizon = eval_env_of(params, eval_params_transform,
                                       device)
  num_envs = args.num_envs or max(args.vec_env_nums, 1)

  random.seed(args.seed)
  np.random.seed(args.seed)

  experiment_name = (osp.split(osp.splitext(args.config)[0])[-1]
                     if args.id is None else args.id)
  work_dir = osp.join(args.log_dir, experiment_name, params["env_name"],
                      str(args.seed))
  logger = None
  if mesh is None or mesh.rank == 0:
    # --resume wins over --overwrite: never delete the checkpoint to resume
    logger = Logger(experiment_name, params["env_name"], args.seed, params,
                    args.log_dir, args.overwrite and not args.resume,
                    leading_columns=PPO_COLUMNS)
    work_dir = logger.work_dir
    if mesh is not None:
      logger.log(f"env axis sharded over {mesh.world} ranks "
                 f"({num_envs // mesh.world} envs each, {mesh.backend})")

  inference_dtype = None
  if _flag("V4L_BF16_COLLECT"):
    inference_dtype = torch.bfloat16
    if logger is not None:
      logger.log("bfloat16 collection forward enabled (V4L_BF16_COLLECT)")

  gs = params["general_setting"]
  agent = PPOAgent(
      env=env, ac_module=build_module(env, params),
      cfg=ppo_config(params, args.num_epochs), num_envs=num_envs,
      seed=args.seed, logger=logger,
      save_dir=osp.join(work_dir, "model"),
      eval_interval=gs.get("eval_interval", 10),
      save_interval=gs.get("save_interval", 100),
      num_eval_envs=num_eval_envs(params),
      obs_norm=meta["obs_norm"],
      env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"],
      inference_dtype=inference_dtype,
      eval_env=eval_env, eval_horizon=eval_horizon,
      fused_attention=_flag("V4L_FUSED_ATTN"),
      mesh=mesh, device=device,
  )
  agent.train(resume=args.resume, stop_epoch=args.stop_epoch)
  if mesh is None:
    return agent
  if logger is not None and logger.tf_writer is not None:
    logger.tf_writer.close()      # the rank's process exits next
  return None
