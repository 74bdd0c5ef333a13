"""Networks of the off-policy family (torch mirror of vision4leg_tpu.
models.off_policy_nets; reference torchrl policies + QNet/BootstrappedNet
in networks/nets.py):

  * TanhGaussianPolicy: the SAC actor (state-dependent mean and logstd,
    logstd clamped to [-5, 2]; the tanh is the learner's);
  * DetTanhPolicy: the DDPG/TD3 actor (tanh output);
  * QNet: Q(s, a) on concat(obs, action);
  * DiscreteQNet: DQN's head, or QRDQN's with num_quantiles > 1;
  * BootstrappedQNet: K heads over a shared base.

Each is an MLPBase `base` followed by the linear layers `layers`: the
append-FC layers (fan-in uniform, bias 0.1) and the output layers
(uniform +-3e-3), in the flax module's Dense_0, Dense_1, ... order."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vision4leg_torch.models import init as winit
from vision4leg_torch.models.base import MLPBase

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -5.0


class _MLPNet(nn.Module):

  def __init__(self, in_dim, hidden_shapes, append_hidden_shapes,
               out_dims, generator):
    super().__init__()
    self.base = MLPBase(in_dim, hidden_shapes)
    dims = [self.base.out_dim, *append_hidden_shapes]
    self.n_append = len(append_hidden_shapes)
    self.layers = nn.ModuleList(
        [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]
        + [nn.Linear(dims[-1], d) for d in out_dims])
    if generator is not None:
      self.init_weights(generator)

  def init_weights(self, gen: torch.Generator):
    self.base.init_weights(gen)
    for i, layer in enumerate(self.layers):
      if i < self.n_append:
        winit.fanin_uniform_(layer, gen)
      else:
        winit.uniform_small_(layer, gen)

  def _hidden(self, x):
    h = self.base(x)
    for layer in self.layers[:self.n_append]:
      h = torch.relu(layer(h))
    return h


class TanhGaussianPolicy(_MLPNet):

  def __init__(self, obs_dim: int, action_dim: int,
               hidden_shapes: Sequence[int] = (256, 256),
               append_hidden_shapes: Sequence[int] = (),
               generator: torch.Generator | None = None):
    super().__init__(obs_dim, hidden_shapes, append_hidden_shapes,
                     [2 * action_dim], generator)

  def forward(self, x):
    """-> (mean, std, logstd)."""
    mean, logstd = self.layers[-1](self._hidden(x)).chunk(2, dim=-1)
    logstd = torch.clamp(logstd, LOG_SIG_MIN, LOG_SIG_MAX)
    return mean, torch.exp(logstd), logstd


class DetTanhPolicy(_MLPNet):

  def __init__(self, obs_dim: int, action_dim: int,
               hidden_shapes: Sequence[int] = (256, 256),
               generator: torch.Generator | None = None):
    super().__init__(obs_dim, hidden_shapes, (), [action_dim], generator)

  def forward(self, x):
    return torch.tanh(self.layers[-1](self._hidden(x)))


class QNet(_MLPNet):
  """Q(s, a) (nets.py QNet: input concat(obs, action))."""

  def __init__(self, obs_dim: int, action_dim: int,
               hidden_shapes: Sequence[int] = (256, 256),
               generator: torch.Generator | None = None):
    super().__init__(obs_dim + action_dim, hidden_shapes, (), [1],
                     generator)

  def forward(self, obs, act):
    return self.layers[-1](self._hidden(torch.cat([obs, act], dim=-1)))


class DiscreteQNet(_MLPNet):
  """(..., A), or (..., A, Q) with num_quantiles Q > 1."""

  def __init__(self, obs_dim: int, num_actions: int,
               hidden_shapes: Sequence[int] = (256, 256),
               num_quantiles: int = 1,
               generator: torch.Generator | None = None):
    self.num_actions, self.num_quantiles = num_actions, num_quantiles
    super().__init__(obs_dim, hidden_shapes, (),
                     [num_actions * num_quantiles], generator)

  def forward(self, obs):
    out = self.layers[-1](self._hidden(obs))
    if self.num_quantiles > 1:
      return out.reshape(out.shape[:-1] + (self.num_actions,
                                           self.num_quantiles))
    return out


class BootstrappedQNet(_MLPNet):
  """K bootstrapped heads over a shared base: (..., K, A)."""

  def __init__(self, obs_dim: int, num_actions: int, num_heads: int = 10,
               hidden_shapes: Sequence[int] = (256, 256),
               generator: torch.Generator | None = None):
    super().__init__(obs_dim, hidden_shapes, (), [num_actions] * num_heads,
                     generator)

  def forward(self, obs):
    h = self._hidden(obs)
    return torch.stack([head(h) for head in self.layers], dim=-2)
