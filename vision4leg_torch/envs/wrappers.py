"""Env-wrapper equivalents that live above A1GymEnv (torch mirror of
vision4leg_tpu.envs.wrappers).

Ported: CurriculumWrapperEnv's episode length (curriculum_wrapper_env.py
:27-92), ramped 1000 -> 2000 over 10M steps on a cubic schedule, which the
agent feeds to the collector as the episode cap of each epoch; and
RandoDirWrapper (env_builder.py:110-156): a random target direction in
[-pi/2, pi/2] per env, its (cos, sin) prefixed to the observation and
used as the task's target_vel_dir, redrawn every `dir_update_interval`
observations (the env keeps it in its state, `envs/env.py`).  The JAX
module's NormRet / RewardShift pieces are not ported: get_env refuses
rew_norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


@dataclasses.dataclass
class RandoDirState:
  angle: torch.Tensor        # (E,)
  step_count: torch.Tensor   # (E,) int32


def draw_dir_angle(gen: torch.Generator, n_env: int, device) -> torch.Tensor:
  """(E,) angles uniform in [-pi/2, pi/2)."""
  u = torch.rand(n_env, generator=gen, device=device)
  return u * math.pi - math.pi / 2


def dir_vector(angle) -> torch.Tensor:
  """(E,) angles -> (E, 2) unit vectors (cos, sin)."""
  return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def rando_dir_reset(gen: torch.Generator, n_env: int, device
                    ) -> Tuple[RandoDirState, torch.Tensor]:
  """A new random target direction per env (env_builder.py:145-156):
  the state and the (cos, sin) vector (E, 2)."""
  angle = draw_dir_angle(gen, n_env, device)
  return (RandoDirState(angle, torch.zeros(n_env, dtype=torch.int32,
                                           device=angle.device)),
          dir_vector(angle))


def rando_dir_advance(state: RandoDirState, new_angle,
                      dir_update_interval: Optional[int]
                      ) -> Tuple[RandoDirState, torch.Tensor]:
  """One observation: the count goes up by one and, with an interval,
  the envs whose count it divides take new_angle (E,).  Returns the state
  and the (cos, sin) vector to prefix to the observation and to use as
  the task's target_vel_dir."""
  count = state.step_count + 1
  angle = state.angle
  if dir_update_interval is not None:
    redraw = (count % dir_update_interval) == 0
    angle = torch.where(redraw, new_angle, angle)
  return RandoDirState(angle, count), dir_vector(angle)


def rando_dir_step(state: RandoDirState, gen: torch.Generator,
                   dir_update_interval: Optional[int]
                   ) -> Tuple[RandoDirState, torch.Tensor]:
  """`rando_dir_advance` with the candidate angles drawn from gen (only
  with an interval)."""
  new_angle = (draw_dir_angle(gen, state.angle.shape[0], state.angle.device)
               if dir_update_interval is not None else None)
  return rando_dir_advance(state, new_angle, dir_update_interval)
