"""Shared policy-replay machinery of the port's viewer scripts (torch
mirror of starter/viewer_common.py; reference starter/*_viewer.py).

Each viewer loads a run's params.json, obs normalizer and `model_pf`
snapshot, rebuilds the policy of the starter that trained the run and
rolls it deterministically (action tanh(mean), the normalizer frozen),
headless: the depth stream can be written to an mp4.  A run of this
port has `model_pf_{snap}.pt`; a run of the JAX package (`runs/`) has
`model_pf_{snap}.flax`, read without JAX (`utils/flax_msgpack.py`).  The
episodes run as one batch of envs through `step_batch`, on the card
unless `--device cpu` is given.

  python -m vision4leg_torch.starter.locotransformer_viewer \
      --config <run>/params.json --log_dir <dir> --id <id> --seed 0 \
      [--snap best] [--episodes 2] [--video out.mp4] [--device cpu]
"""
from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict, Tuple

import numpy as np
import torch

from vision4leg_torch import resolve_device
from vision4leg_torch.data import normalizer as norm
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.utils import flax_msgpack
from vision4leg_torch.utils.args import get_params


def load_policy_bundle(work_dir: str, snap: str = "best", device="cpu"
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  norm.NormalizerState]:
  """(state_dict, normalizer state) of a training run's snapshot: the
  port's `model/model_pf_{snap}.pt`, else the JAX package's
  `model/model_pf_{snap}.flax` through `flax_msgpack.load_jax_run`."""
  model_dir = osp.join(work_dir, "model")
  pt = osp.join(model_dir, f"model_pf_{snap}.pt")
  if osp.exists(pt):
    sd = torch.load(pt, map_location="cpu", weights_only=True)
    return sd, flax_msgpack.read_normalizer(
        osp.join(model_dir, f"_obs_normalizer_{snap}.npz"), device)
  if osp.exists(osp.join(model_dir, f"model_pf_{snap}.flax")):
    return flax_msgpack.load_jax_run(work_dir, snap, device)
  raise FileNotFoundError(f"no model_pf_{snap}.pt or .flax in {model_dir}")


def build_policy(env, params, build_module, state_dict):
  """build_module(env, params) with `state_dict` loaded (strictly), on
  the env's device, in eval mode."""
  module = build_module(env, params)
  module.load_state_dict(state_dict, strict=True)
  return module.to(env.device).eval()


@torch.no_grad()
def run_episodes(env, module, nstate, obs_norm: bool, n_env: int,
                 horizon: int, gen: torch.Generator, record: bool = False):
  """n_env deterministic episodes of `horizon` steps as one batch: action
  tanh(mean) of the policy on the observation normalized by the frozen
  `nstate` (proprio head only), mapped into the env's bounds.  Returns a
  dict of per-env tensors: `returns` and `steps` up to each env's first
  done, `fell` (1 where an episode ended), the final base `pos`,
  `subgoals` hit (where the task has subgoals), and with `record` the
  depth stream `frames` (horizon, n_env, 64, 64) on the CPU."""
  low, high = env.action_low, env.action_high
  states, raw = env.reset(n_env, gen)
  zeros = lambda: torch.zeros(n_env, device=env.device)
  ret, done_seen, steps = zeros(), zeros(), zeros()
  frames = []
  for _ in range(horizon):
    obs = (norm.filt_with_img_tail(nstate, raw, env.cfg.proprio_dim)
           if obs_norm else raw)
    mean, _, _ = module.pi(obs)
    act = low + (torch.tanh(mean) + 1.0) * 0.5 * (high - low)
    states, raw, rew, done, _ = env.step_batch(states, act, gen)
    # selected, not multiplied: a fallen robot stepped on can diverge to
    # NaN, and 0 * NaN would end its return as NaN (`PPOAgent.evaluate`)
    ret = ret + torch.where(done_seen > 0, 0.0, rew)
    steps = steps + (1.0 - done_seen)
    done_seen = torch.maximum(done_seen, done.float())
    if record:
      frames.append(states.frames[:, 0].cpu())
  out = dict(returns=ret, steps=steps, fell=done_seen,
             pos=states.robot.phys.pos,
             subgoals=torch.sum(1.0 - states.task.subgoal_trackers, dim=-1))
  if record:
    out["frames"] = torch.stack(frames)
  return out


def write_depth_video(path: str, frames) -> None:
  """Grayscale 64 x 64 mp4 at 25 fps of frames (N, 64, 64), scaled by
  their overall minimum and maximum (the JAX viewers' encoding)."""
  import cv2
  frames = np.asarray(frames, dtype=np.float32)
  lo, hi = frames.min(), frames.max()
  vid = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                        (64, 64), isColor=False)
  if not vid.isOpened():
    raise RuntimeError(f"cv2 could not open {path} for writing")
  for f in frames:
    vid.write(((f - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8))
  vid.release()


def viewer_args(argv=None, episodes: int = 2):
  """The JAX viewers' flags, and --device (the card unless "cpu")."""
  p = argparse.ArgumentParser()
  p.add_argument("--config", type=str, required=True)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--log_dir", type=str, default="./log")
  p.add_argument("--id", type=str, required=True)
  p.add_argument("--snap", type=str, default="best")
  p.add_argument("--episodes", type=int, default=episodes)
  p.add_argument("--video", type=str, default=None)
  p.add_argument("--device", type=str, default=None,
                 help="cpu to run without a card (default: the card)")
  return p.parse_args(argv)


def load_run(args, build_module):
  """(env, meta, params, module, normalizer state) of the run that the
  viewer flags name: work dir log_dir/id/env_name/seed."""
  device = resolve_device(args.device)
  params = get_params(args.config)
  env, meta = get_env(params["env_name"], params["env"], device=device)
  work_dir = osp.join(args.log_dir, args.id, params["env_name"],
                      str(args.seed))
  sd, nstate = load_policy_bundle(work_dir, args.snap, device)
  return env, meta, params, build_policy(env, params, build_module,
                                         sd), nstate


def run_viewer(build_module, argv=None, horizon=None):
  """The viewer CLI: `args.episodes` episodes of the run's policy over
  max_episode_frames steps (or `horizon`), each env's return and final
  position printed; with --video the depth stream of every episode, one
  after another, to an mp4.  Returns the episodes' dict
  (`run_episodes`)."""
  args = viewer_args(argv)
  env, meta, params, module, nstate = load_run(args, build_module)
  if horizon is None:
    horizon = params["collector"].get("max_episode_frames", 999)
  gen = torch.Generator(device=env.device).manual_seed(args.seed * 1000)
  record = bool(args.video) and env.cfg.get_image
  out = run_episodes(env, module, nstate, meta["obs_norm"], args.episodes,
                     horizon, gen, record=record)
  rets = out["returns"].cpu().numpy()
  pos = out["pos"].cpu().numpy()
  for ep in range(args.episodes):
    print(f"episode {ep}: return {rets[ep]:.2f} final pos "
          f"{pos[ep].round(2)}")
  print(f"mean return: {rets.mean():.2f}")
  if record:
    frames = out["frames"].transpose(0, 1).reshape(-1, 64, 64)
    write_depth_video(args.video, frames.numpy())
    print(f"wrote {args.video}")
  return out
