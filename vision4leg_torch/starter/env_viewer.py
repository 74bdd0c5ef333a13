"""Random-action environment smoke viewer on the card (torch mirror of
starter/env_viewer.py; reference starter/env_viewer.py:54-88 and the
speed probe of env_builder.py:542-556): uniform random actions within the
env's bounds, the reward statistics, the rate in env-steps/s and,
optionally, the depth stream of env 0 to an mp4.

  python -m vision4leg_torch.starter.env_viewer \
      --config config/rl/static/locotransformer/thin-goal.json \
      [--steps 200] [--num_envs 1] [--video out.mp4] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vision4leg_torch import resolve_device
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.starter.viewer_common import write_depth_video
from vision4leg_torch.utils.args import get_params


def roll(env, n_env: int, steps: int, gen: torch.Generator,
         record: bool = False):
  """`steps` steps of n_env envs under uniform random actions (episodes
  that end are stepped on, as the JAX viewer's scan does).  Returns
  (rewards (steps, n_env), dones, base positions (steps, n_env, 3), env
  0's depth frames or None, seconds of the steps)."""
  low, high = env.action_low, env.action_high
  states, _ = env.reset(n_env, gen)
  rews, dones, pos, frames = [], [], [], []
  sync = (torch.cuda.synchronize if env.device.type == "cuda"
          else (lambda: None))
  sync()
  t0 = time.perf_counter()
  for _ in range(steps):
    a = low + (high - low) * torch.rand(n_env, low.shape[0], generator=gen,
                                        device=env.device)
    states, _, rew, done, _ = env.step_batch(states, a, gen)
    rews.append(rew)
    dones.append(done)
    pos.append(states.robot.phys.pos)
    if record:
      frames.append(states.frames[0, 0])
  sync()
  dt = time.perf_counter() - t0
  stack = lambda xs: torch.stack(xs).cpu().numpy()
  return (stack(rews), stack(dones), stack(pos),
          stack(frames) if record else None, dt)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--config", type=str, required=True)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--steps", type=int, default=200)
  p.add_argument("--num_envs", type=int, default=1)
  p.add_argument("--video", type=str, default=None,
                 help="write env 0's depth camera stream to an mp4")
  p.add_argument("--device", type=str, default=None,
                 help="cpu to run without a card (default: the card)")
  args = p.parse_args(argv)

  params = get_params(args.config)
  env, _ = get_env(params["env_name"], params["env"],
                   device=resolve_device(args.device))
  gen = torch.Generator(device=env.device).manual_seed(args.seed)
  record = bool(args.video) and env.cfg.get_image
  rews, dones, pos, frames, dt = roll(env, args.num_envs, args.steps, gen,
                                      record)
  rate = args.steps * args.num_envs / dt
  print(f"env-steps/sec: {rate:.1f} ({args.steps} steps x "
        f"{args.num_envs} envs in {dt:.3f}s on {env.device})")
  print(f"reward mean {rews.mean():.4f} min {rews.min():.4f} "
        f"max {rews.max():.4f}")
  print(f"episode done fraction: {dones.mean():.3f}")
  print(f"final base position: {np.asarray(pos[-1, 0]).round(3)}")
  if record:
    write_depth_video(args.video, frames)
    print(f"wrote {args.video}")
  return dict(env_steps_per_s=rate, rewards=rews, dones=dones)


if __name__ == "__main__":
  main()
