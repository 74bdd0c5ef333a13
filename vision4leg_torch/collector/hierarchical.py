"""Hierarchical rollout (torch mirror of vision4leg_tpu.collector.
hierarchical): a high-level policy commands a heading angle that a frozen
low-level locomotion policy executes.

Reference: torchrl/collector/on_policy_hierarchical.py:
  * the high-level policy explores a 1-dim action a; angle = a * pi/2
    (:28-31);
  * the low level observes [cos(angle), sin(angle), proprio], the proprio
    head of the (normalized) observation (nets.py:768-780), the
    RandoDirWrapper layout (env_builder.py:110-156);
  * the low level acts deterministically, tanh(mean) (:38);
  * the buffer keeps the high-level (obs, acts, values, log-probs, mean,
    std) (:56-67), so PPO trains the high level against the env reward.

The two-level act path plugs into `make_rollout_fn` through its `act_fn`
hook; GAE, the minibatches and the PPO update never see the low level.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from vision4leg_torch.collector import rollout as rollout_lib


def make_hierarchical_act_fn(apply_high_pi: Callable,
                             apply_low_pi: Callable, proprio_dim: int,
                             action_low, action_high):
  """act(obs, gen, noise=None) -> (high_act, logp, env_act, mean, std).

  apply_high_pi(obs) -> (mean, std, logstd), a 1-dim action;
  apply_low_pi(low_obs) -> (mean, std, logstd), the motor action (the
  frozen low level's module is closed over).  The high level's Gaussian
  noise is drawn from `gen`, or given as `noise` (mean's shape)."""

  def act(obs, gen, noise=None):
    mean, std, _ = apply_high_pi(obs)
    if noise is None:
      noise = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                          device=mean.device)
    high_act = mean + std * noise
    logp = torch.sum(-0.5 * noise ** 2 - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), dim=-1, keepdim=True)
    angle = high_act * math.pi * 0.5
    low_obs = torch.cat([torch.cos(angle), torch.sin(angle),
                         obs[..., :proprio_dim]], dim=-1)
    low_mean, _, _ = apply_low_pi(low_obs)
    env_act = torch.tanh(low_mean)
    env_act = action_low + (env_act + 1.0) * 0.5 * (action_high - action_low)
    return high_act, logp, env_act, mean, std

  return act


def make_hierarchical_rollout_fn(env, apply_high_pi: Callable,
                                 apply_v: Callable, apply_low_pi: Callable,
                                 horizon: int, max_episode_frames: int,
                                 discount: float, proprio_dim: int,
                                 obs_norm: bool = True,
                                 env_time_limit: int = 1000):
  """`make_rollout_fn` with the two-level action path: trains the high
  level (apply_v is its value); the low level stays frozen."""
  act_fn = make_hierarchical_act_fn(apply_high_pi, apply_low_pi,
                                    proprio_dim, env.action_low,
                                    env.action_high)
  return rollout_lib.make_rollout_fn(
      env, None, apply_v, horizon, max_episode_frames, discount,
      proprio_dim, obs_norm=obs_norm, action_low=env.action_low,
      action_high=env.action_high, env_time_limit=env_time_limit,
      act_fn=act_fn)
