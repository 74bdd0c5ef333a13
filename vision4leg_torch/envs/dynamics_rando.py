"""Per-episode dynamics randomization (torch mirror of
vision4leg_tpu.envs.dynamics_rando; reference
controllable_env_randomizer_config.py:9-26): mass [0.8, 1.2] and inertia
[0.5, 1.5] ratios (one draw for the base, one for all legs), motor
strength [0.8, 1.2] per motor, motor friction [0, 0.05], joint friction
[0, 0.05], latency [0, 0.04] s (pinned to 0.04 with
fixed_delay_observation), lateral friction [0.5, 1.25], kp [50, 70], kd
[0.4, 0.8]."""
from __future__ import annotations

import torch

from vision4leg_torch.physics.model import Model
from vision4leg_torch.robots.a1 import DynamicsParams, default_dynamics


def sample_dynamics(model: Model, gen: torch.Generator, n_env: int,
                    fixed_delay_observation: bool = False) -> DynamicsParams:
  dev = model.device
  nb = model.nbody
  u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(
      (n_env,) + shape, generator=gen, device=dev)
  mass = u((2,), 0.8, 1.2)
  inertia = u((2,), 0.5, 1.5)
  expand = lambda r: torch.cat([r[:, :1], r[:, 1:2].expand(n_env, nb - 1)],
                               dim=1)
  latency = (torch.full((n_env,), 0.04, device=dev)
             if fixed_delay_observation else u((), 0.0, 0.04))
  return DynamicsParams(
      kp=u((1,), 50.0, 70.0).expand(n_env, 12).contiguous(),
      kd=u((1,), 0.4, 0.8).expand(n_env, 12).contiguous(),
      strength_ratios=u((12,), 0.8, 1.2),
      motor_friction=u((), 0.0, 0.05), joint_friction=u((), 0.0, 0.05),
      control_latency=latency, lateral_friction=u((), 0.5, 1.25),
      mass_scale=expand(mass), inertia_scale=expand(inertia))


def maybe_sample(model: Model, gen: torch.Generator, n_env: int,
                 enabled: bool, fixed_delay_observation: bool = False
                 ) -> DynamicsParams:
  if enabled:
    return sample_dynamics(model, gen, n_env, fixed_delay_observation)
  return default_dynamics(model, (n_env,))
