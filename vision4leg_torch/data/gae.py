"""GAE and discounted returns over (T, E) tensors (torch mirror of
vision4leg_tpu.data.gae), as reverse loops over T.

Reference math: torchrl/replay_buffers/on_policy.py:17-71, including the
`time_limit_filter` semantics (the advantage is zeroed *at* time-limit
steps after accumulation, so returns equal values there and the recursion
restarts across the truncation boundary).
"""
from __future__ import annotations

from typing import Tuple

import torch


def gae(rewards, values, terminals, time_limits, last_value, gamma: float,
        tau: float, time_limit_filter: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Generalized advantage estimation.

  rewards/values/terminals/time_limits: (T, E) float; last_value: (E,)
  (already zeroed for terminal tails by the collector).  Returns (advs,
  estimate_returns), each (T, E).
  """
  T = rewards.shape[0]
  values_tp1 = torch.cat([values[1:], last_value[None]], dim=0)
  A = torch.zeros_like(last_value)
  advs, rets = [None] * T, [None] * T
  for t in reversed(range(T)):
    delta = (rewards[t] + (1.0 - terminals[t]) * gamma * values_tp1[t]
             - values[t])
    A = delta + (1.0 - terminals[t]) * gamma * tau * A
    if time_limit_filter:
      A = A * (1.0 - time_limits[t])
    advs[t], rets[t] = A, A + values[t]
  return torch.stack(advs), torch.stack(rets)


def discounted_returns(rewards, values, terminals, time_limits, last_value,
                       gamma: float, time_limit_filter: bool = True):
  """discount_reward path (on_policy.py:47-71), for gae=False configs."""
  T = rewards.shape[0]
  R = last_value
  advs, rets = [None] * T, [None] * T
  for t in reversed(range(T)):
    r, v, term, tl = rewards[t], values[t], terminals[t], time_limits[t]
    if time_limit_filter:
      R = (r + (1.0 - term) * gamma * R * (1.0 - tl)) + tl * v
    else:
      R = r + (1.0 - term) * gamma * R
    advs[t], rets[t] = R - v, R
  return torch.stack(advs), torch.stack(rets)
