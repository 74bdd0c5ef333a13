"""Weight initializers of the reference (torchrl/networks/init.py) and of
flax's defaults where the JAX package keeps them; every one takes an
explicit torch.Generator."""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def fanin_uniform_(layer: nn.Linear, gen: torch.Generator,
                   bias: float = 0.1):
  """basic_init: U(+-1/sqrt(weight.size(0))) — the reference takes the
  bound from size()[0], the OUTPUT width of a torch Linear — bias 0.1."""
  bound = 1.0 / math.sqrt(layer.weight.shape[0])
  nn.init.uniform_(layer.weight, -bound, bound, generator=gen)
  nn.init.constant_(layer.bias, bias)


@torch.no_grad()
def uniform_small_(layer: nn.Linear, gen: torch.Generator,
                   param: float = 3e-3):
  """uniform_init of output layers: U(+-3e-3) weight and bias."""
  nn.init.uniform_(layer.weight, -param, param, generator=gen)
  nn.init.uniform_(layer.bias, -param, param, generator=gen)


@torch.no_grad()
def orthogonal_(layer: nn.Module, gen: torch.Generator,
                gain: float = math.sqrt(2)):
  """Orthogonal weight (gain sqrt 2), zero bias."""
  nn.init.orthogonal_(layer.weight, gain, generator=gen)
  nn.init.zeros_(layer.bias)


@torch.no_grad()
def lecun_normal_(layer: nn.Linear, gen: torch.Generator):
  """flax's default Dense/attention init: truncated normal with variance
  1/fan_in (std corrected for the +-2 sigma truncation), zero bias."""
  std = math.sqrt(1.0 / layer.weight.shape[1]) / 0.87962566103423978
  nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                        generator=gen)
  nn.init.zeros_(layer.bias)


@torch.no_grad()
def xavier_uniform_(layer: nn.Module, gen: torch.Generator):
  """Xavier-uniform weight, zero bias (the Impala convs)."""
  nn.init.xavier_uniform_(layer.weight, generator=gen)
  nn.init.zeros_(layer.bias)
