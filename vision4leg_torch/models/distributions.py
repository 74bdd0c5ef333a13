"""TanhNormal utilities (torch mirror of vision4leg_tpu.models.
distributions; reference torchrl/policies/distribution.py:5-80, the
RLKIT-style squashed Gaussian with the pre-tanh log-prob).

The Gaussian draw comes from `gen` (a generator on the mean's device), or
is given as `noise` (standard normal, the mean's shape)."""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2 * math.pi)


def standard_normal(mean, gen=None, noise=None):
  if noise is not None:
    return noise
  return torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                     device=mean.device)


def sample(mean, std, gen=None, noise=None):
  """rsample with the pre-tanh value: (action, pre_tanh)."""
  z = mean + std * standard_normal(mean, gen, noise)
  return torch.tanh(z), z


def log_prob(mean, std, action, pre_tanh):
  """log pi(a): the Normal log-prob of pre_tanh minus the tanh Jacobian,
  N(z) - log(1 - tanh(z)^2 + 1e-6) per action dim."""
  normal_lp = (-0.5 * ((pre_tanh - mean) / std) ** 2 - torch.log(std)
               - 0.5 * _LOG_2PI)
  return normal_lp - torch.log(1.0 - action ** 2 + 1e-6)


def sample_with_log_prob(mean, std, gen=None, noise=None):
  """(action, pre_tanh, log-prob summed over action dims (B, 1))."""
  action, z = sample(mean, std, gen, noise)
  lp = torch.sum(log_prob(mean, std, action, z), dim=-1, keepdim=True)
  return action, z, lp
