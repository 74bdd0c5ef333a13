"""Trajectory-generator wrapper: a built-in gait signal under the policy
(torch mirror of vision4leg_tpu.envs.trajectory_generator).

Reference: `vision4leg/envs/env_wrappers/trajectory_generator_wrapper_env.py`
(TrajectoryGeneratorWrapperEnv, :23-92): the generator transforms the
policy's action (`get_action(state, time_since_reset, action)`) and may
extend the observation (`get_observation(state, obs)`); the wrapper
validates that interface at construction and raises ValueError otherwise
(:41-46).

Batched as the port's envs are: the generator's state holds one phase
per env, the wrapper's state pairs it with the env's state batch (so the
collector's partial resets scatter both), and `reset(n_env, gen)` /
`step_batch(states, actions, gen)` are the env's, with the phase's (cos,
sin) appended to every observation as the JAX generator appends it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from vision4leg_torch.robots import a1_params as P


@dataclasses.dataclass
class TGState:
  """Open-loop generator state: gait phase in [0, 2 pi), one per env."""
  phase: torch.Tensor  # (E,) float32


@dataclasses.dataclass
class TGEnvState:
  """The wrapped env's state batch and the generator's."""
  env: Any
  tg: TGState


class OpenloopGaitGenerator:
  """Open-loop sinusoidal trot around the standing pose, the policy's
  action a residual on top (PMTG-style): each step the phase advances by
  2 pi frequency_hz control_dt, and the policy sees (cos, sin) of it."""

  extra_obs_dim = 2

  def __init__(self, frequency_hz: float = 1.25,
               swing_amplitude: float = 0.2,
               extension_amplitude: float = 0.4,
               control_dt: float = 0.025):
    self.frequency_hz = frequency_hz
    self.swing_amplitude = swing_amplitude
    self.extension_amplitude = extension_amplitude
    self.control_dt = control_dt
    # trot: diagonal pairs (FR, RL) in phase, (FL, RR) in antiphase, leg
    # order FR FL RR RL (a1.py MOTOR_NAMES)
    self._leg_phase_offset = (0.0, math.pi, math.pi, 0.0)

  def reset(self, n_env: int, device) -> TGState:
    return TGState(phase=torch.zeros(n_env, device=device))

  def get_action(self, tg_state: TGState, time_since_reset, action):
    """(state, t (E,), policy residual (E, 12)) -> (state', motor angles
    (E, 12)), clipped to the joint limits."""
    del time_since_reset  # the phase is integrated in the state
    dev = action.device
    offset = torch.tensor(self._leg_phase_offset, dtype=torch.float32,
                          device=dev)
    sin = torch.sin(tg_state.phase[:, None] + offset)           # (E, 4)
    swing = self.swing_amplitude * sin                            # thigh
    # the knee flexes only in the swing half of the cycle (sin > 0)
    lift = self.extension_amplitude * torch.clamp(sin, min=0.0)
    open_loop = torch.stack([torch.zeros_like(sin), swing, lift],
                            dim=-1).reshape(-1, 12)               # hip,up,low
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    motor = t(P.INIT_MOTOR_ANGLES) + open_loop + action
    motor = torch.minimum(torch.maximum(motor, t(P.JOINT_LOWER)),
                          t(P.JOINT_UPPER))
    phase = torch.remainder(
        tg_state.phase + 2.0 * math.pi * self.frequency_hz * self.control_dt,
        2.0 * math.pi)
    return TGState(phase=phase), motor

  def get_observation(self, tg_state: TGState, obs):
    return torch.cat([obs, torch.cos(tg_state.phase)[:, None],
                      torch.sin(tg_state.phase)[:, None]], dim=-1)


class TrajectoryGeneratorWrapper:
  """A batched env (`A1GymEnv`) under a trajectory generator: the
  generator is validated at construction, reset with the envs, applied to
  every action before the env sees it and given every observation.

  The generator emits 12 motor angles, so the env must take them
  (diagonal_act off); the JAX wrapper hands them to a diagonal env, which
  then reads the first six and drops the rest, and the port refuses that.
  The policy's action is the residual: `action_low` / `action_high` are
  the env's bounds less the standing pose, the residuals that reach the
  env's action box from it (the collector's NormAct maps into them)."""

  def __init__(self, env, trajectory_generator):
    if (not hasattr(trajectory_generator, "get_action")
        or not hasattr(trajectory_generator, "get_observation")):
      raise ValueError(
          "The controller does not have the necessary interface(s) "
          "implemented.")
    if env.cfg.action_dim != 12:
      raise ValueError(
          f"the trajectory generator emits 12 motor angles; this env takes "
          f"{env.cfg.action_dim} (diagonal_act)")
    self.env = env
    self.tg = trajectory_generator
    init = torch.tensor(P.INIT_MOTOR_ANGLES, dtype=torch.float32,
                        device=env.device)
    self.action_low = env.action_low - init
    self.action_high = env.action_high - init

  @property
  def cfg(self):
    return self.env.cfg

  @property
  def device(self):
    return self.env.device

  @property
  def obs_dim(self) -> int:
    return self.env.obs_dim + getattr(self.tg, "extra_obs_dim", 0)

  def reset(self, n_env: int, gen: torch.Generator):
    return self.reset_from(n_env, self.draw_for_reset(n_env, gen))

  def draw_for_reset(self, n_env: int, gen: torch.Generator):
    return self.env.draw_for_reset(n_env, gen)

  def reset_from(self, n_env: int, draws):
    tg_state = self.tg.reset(n_env, self.env.device)
    env_states, obs = self.env.reset_from(n_env, draws)
    return (TGEnvState(env=env_states, tg=tg_state),
            self.tg.get_observation(tg_state, obs))

  def step_batch(self, states: TGEnvState, actions, gen: torch.Generator):
    return self.step_from(states, actions,
                          self.draw_for_step(actions.shape[0], states, gen))

  def draw_for_step(self, n_env: int, states: TGEnvState,
                    gen: torch.Generator):
    return self.env.draw_for_step(n_env, states.env, gen)

  def step_from(self, states: TGEnvState, actions, draws):
    cfg = self.env.cfg
    time_since_reset = (states.env.step_counter.float() * cfg.time_step_s
                        * cfg.num_action_repeat)
    tg_state, motor = self.tg.get_action(states.tg, time_since_reset,
                                         actions)
    env_states, obs, rew, done, info = self.env.step_from(states.env, motor,
                                                         draws)
    return (TGEnvState(env=env_states, tg=tg_state),
            self.tg.get_observation(tg_state, obs), rew, done, info)
