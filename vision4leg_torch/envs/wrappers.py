"""Env-wrapper equivalents that live above A1GymEnv (torch mirror of
vision4leg_tpu.envs.wrappers).

Ported: CurriculumWrapperEnv's episode length (curriculum_wrapper_env.py
:27-92), ramped 1000 -> 2000 over 10M steps on a cubic schedule; the
agent feeds it to the collector as the episode cap of each epoch.  The
JAX module's RandoDirWrapper and NormRet / RewardShift pieces are not
ported: the env refuses random_dir and get_env refuses rew_norm.
"""
from __future__ import annotations

import torch


def curriculum_episode_length(total_steps,
                              episode_length_start: int = 1000,
                              episode_length_end: int = 2000,
                              curriculum_steps: int = 10_000_000,
                              num_parallel_envs: int = 8) -> torch.Tensor:
  """Cubic ramp of the episode length (curriculum_wrapper_env.py:31-66),
  in float32 then truncated to int32, as the JAX function computes it."""
  steps = torch.as_tensor(total_steps).to(torch.float32)
  frac = torch.clamp(steps * num_parallel_envs / curriculum_steps, 0.0, 1.0)
  ramp = frac * frac * frac
  return (episode_length_start
          + ramp * (episode_length_end - episode_length_start)).to(
              torch.int32)
