"""Discrete action policies (torch mirror of vision4leg_tpu.models.
discrete_policies; reference torchrl/policies/discrete_policies.py:
epsilon-greedy, Boltzmann, bootstrapped heads).

Each draw comes from `gen` (a generator on the q-values' device) or is
given pre-drawn, as the JAX package's keys would draw it."""
from __future__ import annotations

import torch


def epsilon_greedy(q_values, epsilon: float, gen=None, draws=None):
  """argmax with probability 1 - epsilon, else a uniform action.
  draws = (random actions (...,) int, uniforms (...,) in [0, 1))."""
  greedy = torch.argmax(q_values, dim=-1)
  if draws is None:
    rand = torch.randint(0, q_values.shape[-1], greedy.shape, generator=gen,
                         device=q_values.device)
    u = torch.rand(greedy.shape, generator=gen, device=q_values.device)
  else:
    rand, u = draws
  return torch.where(u < epsilon, rand.to(greedy.dtype), greedy)


def boltzmann(q_values, temperature: float = 1.0, gen=None, gumbel=None):
  """A categorical draw over softmax(q / T), as the argmax of the logits
  plus standard Gumbel noise (jax.random.categorical's method);
  `gumbel` is that noise, q's shape."""
  if gumbel is None:
    u = torch.rand(q_values.shape, generator=gen, dtype=q_values.dtype,
                   device=q_values.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
  return torch.argmax(q_values / temperature + gumbel, dim=-1)


def bootstrapped_head(q_heads, head_idx=None, gen=None):
  """Greedy w.r.t. one head of q_heads (..., K, A): `head_idx`, or one
  drawn uniformly."""
  if head_idx is None:
    head_idx = int(torch.randint(0, q_heads.shape[-2], (), generator=gen,
                                 device=q_heads.device))
  return torch.argmax(q_heads[..., int(head_idx), :], dim=-1)


def eval_greedy(q_values):
  return torch.argmax(q_values, dim=-1)
