"""Sweep a trained snapshot over randomized environments and report its
success statistics, on the card (torch mirror of
starter/total_randomize_statistics.py; reference
starter/total_randomize_statistics.py).  Success is an episode that no
fall ended within the horizon; on subgoal terrains the subgoals collected
are reported too.  The snapshot is the port's .pt or the JAX package's
.flax (viewer_common.load_policy_bundle).

  python -m vision4leg_torch.starter.total_randomize_statistics \
      --config <run>/params.json --log_dir <dir> --id <id> \
      [--episodes 16] [--device cpu]
"""
from __future__ import annotations

import torch

from vision4leg_torch.starter.locotransformer_viewer import \
    build_module_for_config
from vision4leg_torch.starter.viewer_common import (load_run, run_episodes,
                                                    viewer_args)


def statistics(out, has_subgoals: bool) -> dict:
  """The sweep's numbers from `run_episodes`' output."""
  ret = out["returns"].double()
  stats = {"episodes": int(ret.numel()),
           "success_rate": float(1.0 - out["fell"].double().mean()),
           "return_mean": float(ret.mean()),
           "return_std": float(ret.std(unbiased=False)),
           "episode_length_mean": float(out["steps"].double().mean()),
           "forward_distance_mean": float(out["pos"][:, 0].double().mean())}
  if has_subgoals:
    stats["subgoals_mean"] = float(out["subgoals"].double().mean())
  return stats


def main(argv=None, horizon=None):
  """The CLI; `horizon` (default: the config's max_episode_frames) cuts
  the episodes.  Returns the statistics."""
  args = viewer_args(argv, episodes=16)
  env, meta, params, module, nstate = load_run(
      args, lambda e, p: build_module_for_config(e, p, args.config))
  if horizon is None:
    horizon = params["collector"].get("max_episode_frames", 999)
  gen = torch.Generator(device=env.device).manual_seed(args.seed)
  out = run_episodes(env, module, nstate, meta["obs_norm"], args.episodes,
                     horizon, gen)
  s = statistics(out, env.cfg.subgoal_reward is not None)
  print(f"episodes: {s['episodes']} of {horizon} steps on {env.device}")
  print(f"success rate (no fall): {s['success_rate']:.3f}")
  print(f"return: mean {s['return_mean']:.2f} std {s['return_std']:.2f}")
  print(f"episode length: mean {s['episode_length_mean']:.1f}")
  print(f"forward distance: mean {s['forward_distance_mean']:.2f} m")
  if "subgoals_mean" in s:
    print(f"subgoals hit: mean {s['subgoals_mean']:.2f}")
  return s


if __name__ == "__main__":
  main()
