"""Actor-critics (torch mirror of vision4leg_tpu.models.actor_critic):
the proprio-only one (StateActorCritic; reference ppo_state.py:93-104: a
shared MLP base, separate MLP heads), the LocoTransformer ones (LocoTransformerActorCritic,
VisionOnlyTransformerActorCritic; reference ppo_locotransformer.py:79-101
and ppo_locotransformer_vision_only.py: one shared tokenizer, separate
transformer stacks and MLP heads for policy and value) and the Nature-CNN
baselines (NatureFuseActorCritic, VisualNetActorCritic; reference
ppo_nature_cnn.py and ppo_nature_cnn_vision_only.py: one shared encoder,
separate MLP heads), and the ppo_aux backbone
(ImpalaFuseResidualActorCritic).  Each policy has a learnable state-independent logstd
initialized to log(0.125), clamped to [-5, 2] (continuous_policy.py:8-9,
239-254).  The Nature-CNN models, like the JAX package's, have no `pi_v`
and no fused layer."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from vision4leg_torch.models import init as winit
from vision4leg_torch.models.base import (ImpalaEncoder,
                                          LocoTransformerEncoder, MLPBase,
                                          NatureEncoder, NatureFuseEncoder,
                                          RLProjection,
                                          TransformerEncoderLayer,
                                          VisionTokenEncoder, impala_out_dim,
                                          nature_out_dim)

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -5.0


def gaussian_head(logstd, mean):
  """(mean, std, logstd) of the state-independent Gaussian policy."""
  logstd = torch.clamp(logstd, LOG_SIG_MIN, LOG_SIG_MAX)
  return mean, torch.exp(logstd).expand_as(mean), logstd


class MLPHead(nn.Module):
  """Append-FC stack + small-uniform output layer (nets.py:16-70 tail)."""

  def __init__(self, in_dim: int, hidden_shapes: Sequence[int],
               out_dim: int):
    super().__init__()
    dims = [in_dim, *hidden_shapes, out_dim]
    self.layers = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

  def init_weights(self, gen):
    for layer in self.layers[:-1]:
      winit.fanin_uniform_(layer, gen)
    winit.uniform_small_(self.layers[-1], gen)

  def forward(self, x):
    for layer in self.layers[:-1]:
      x = torch.relu(layer(x))
    return self.layers[-1](x)


class GaussianHead(nn.Module):
  """The state-independent logstd of the Nature-CNN policies, a module of
  its own as the JAX package's `head` (so `param_labels` gives it to the
  policy's optimizer under the same name)."""

  def __init__(self, action_dim: int, log_init: float = 0.125):
    super().__init__()
    self.logstd = nn.Parameter(torch.full((action_dim,), math.log(log_init)))

  def forward(self, mean):
    return gaussian_head(self.logstd, mean)


def _no_fused(model, fused: bool):
  if fused:
    raise NotImplementedError(
        f"fused: {type(model).__name__} has no transformer layer to fuse")


class StateActorCritic(nn.Module):
  """ppo_state: one MLPBase shared by the policy and the value (`vf.base
  = pf.base`, starter/ppo_state.py:93-104) under separate append-MLP
  heads; `pi_v` runs the base once.  The JAX module's `pi`, `v` and
  `pi_v` take no fused switch; here `fused` is accepted for the agent's
  sake and refused when set."""

  def __init__(self, action_dim: int, state_input_shape: int,
               hidden_shapes: Sequence[int] = (256, 256),
               append_hidden_shapes: Sequence[int] = (256, 256),
               log_init: float = 0.125,
               generator: torch.Generator | None = None):
    super().__init__()
    self.base = MLPBase(state_input_shape, hidden_shapes)
    self.head = GaussianHead(action_dim, log_init)
    self.pf_mlp = MLPHead(self.base.out_dim, append_hidden_shapes,
                          action_dim)
    self.vf_mlp = MLPHead(self.base.out_dim, append_hidden_shapes, 1)
    if generator is not None:
      self.init_weights(generator)

  def init_weights(self, gen: torch.Generator):
    """The reference's initializers, drawn from `gen`."""
    self.base.init_weights(gen)
    self.pf_mlp.init_weights(gen)
    self.vf_mlp.init_weights(gen)

  def pi(self, x, fused: bool = False):
    """-> (mean, std, logstd)."""
    _no_fused(self, fused)
    return self.head(self.pf_mlp(self.base(x)))

  def v(self, x, fused: bool = False):
    """-> (B, 1) value."""
    _no_fused(self, fused)
    return self.vf_mlp(self.base(x))

  def pi_v(self, x, fused: bool = False):
    """The base once, both heads: ((mean, std, logstd), value)."""
    _no_fused(self, fused)
    h = self.base(x)
    return self.head(self.pf_mlp(h)), self.vf_mlp(h)


class LocoTransformerActorCritic(nn.Module):

  def __init__(self, action_dim: int, state_input_shape: int,
               visual_input_shape: Tuple[int, int, int] = (4, 64, 64),
               encoder_hidden_shapes: Sequence[int] = (256, 256),
               transformer_params: Sequence[tuple] = ((1, 256), (1, 256)),
               append_hidden_shapes: Sequence[int] = (256, 256),
               token_dim: int = 64, max_pool: bool = False,
               log_init: float = 0.125,
               generator: torch.Generator | None = None):
    super().__init__()
    self.state_input_shape = state_input_shape
    self.max_pool = max_pool
    self.visual_input_shape = tuple(visual_input_shape)
    self.encoder = LocoTransformerEncoder(
        visual_input_shape[0], state_input_shape, encoder_hidden_shapes,
        token_dim)
    self.pf_layers = nn.ModuleList(
        TransformerEncoderLayer(token_dim, nh, ff)
        for nh, ff in transformer_params)
    self.vf_layers = nn.ModuleList(
        TransformerEncoderLayer(token_dim, nh, ff)
        for nh, ff in transformer_params)
    self.n_modal = 2 if visual_input_shape[0] == 16 else 1
    width = (1 + self.n_modal) * token_dim
    self.pf_mlp = MLPHead(width, append_hidden_shapes, action_dim)
    self.vf_mlp = MLPHead(width, append_hidden_shapes, 1)
    self.logstd = nn.Parameter(torch.full((action_dim,), math.log(log_init)))
    if generator is not None:
      self.init_weights(generator)

  def init_weights(self, gen: torch.Generator):
    """The reference's initializers, drawn from `gen`."""
    self.encoder.init_weights(gen)
    for layer in (*self.pf_layers, *self.vf_layers):
      layer.init_weights(gen)
    self.pf_mlp.init_weights(gen)
    self.vf_mlp.init_weights(gen)

  def _tokens(self, x):
    state_x = x[..., : self.state_input_shape]
    visual_x = x[..., self.state_input_shape:].reshape(
        x.shape[:-1] + self.visual_input_shape)
    return self.encoder(visual_x, state_x)

  def _pool(self, tokens):
    """State token + mean (or, with max_pool, max) of each modality's
    tokens (nets.py:1014-1030)."""
    pm = self.encoder.per_modal_tokens
    pool = ((lambda t: t.amax(dim=1)) if self.max_pool
            else (lambda t: t.mean(dim=1)))
    return torch.cat([tokens[:, 0]] + [
        pool(tokens[:, 1 + i * pm: 1 + (i + 1) * pm])
        for i in range(self.n_modal)], dim=-1)

  def _head(self, mean):
    return gaussian_head(self.logstd, mean)

  def pi(self, x, fused: bool = False):
    """-> (mean, std, logstd).  `fused` runs each transformer layer through
    the fused kernel (models.base.TransformerEncoderLayer)."""
    t = self._tokens(x)
    for layer in self.pf_layers:
      t = layer(t, fused=fused)
    return self._head(self.pf_mlp(self._pool(t)))

  def v(self, x, fused: bool = False):
    """-> (B, 1) value."""
    t = self._tokens(x)
    for layer in self.vf_layers:
      t = layer(t, fused=fused)
    return self.vf_mlp(self._pool(t))

  def pi_v(self, x, fused: bool = False):
    """Tokenize once, run both stacks: ((mean, std, logstd), value)."""
    t0 = self._tokens(x)
    t = t0
    for layer in self.pf_layers:
      t = layer(t, fused=fused)
    pi_out = self._head(self.pf_mlp(self._pool(t)))
    t = t0
    for layer in self.vf_layers:
      t = layer(t, fused=fused)
    return pi_out, self.vf_mlp(self._pool(t))


class VisionOnlyTransformerActorCritic(nn.Module):
  """ppo_locotransformer_vision_only (the JAX package's
  VisionOnlyTransformerActorCritic): the transformer stacks run over the
  tokens of VisionTokenEncoder alone (16, or 32 on rgbd: depth then rgb);
  the proprio head of the observation (empty on the vision-only MPC env)
  is ignored.  Each stack's output is pooled over tokens [0, 1 +
  per_modal_tokens) as the reference slices it (nets.py:884-901), which on
  one modality's 16 tokens is all of them and on rgbd's 32 the 16 depth
  tokens and the first rgb one (the reference's own off-by-one), and on
  rgbd also over [per_modal_tokens, 2 per_modal_tokens).
  encoder_hidden_shapes is accepted for the config's sake: the
  vision-only encoder has no proprio MLP."""

  def __init__(self, action_dim: int, state_input_shape: int,
               visual_input_shape: Tuple[int, int, int] = (4, 64, 64),
               encoder_hidden_shapes: Sequence[int] = (256, 256),
               transformer_params: Sequence[tuple] = ((1, 256), (1, 256)),
               append_hidden_shapes: Sequence[int] = (256, 256),
               token_dim: int = 64, max_pool: bool = False,
               log_init: float = 0.125,
               generator: torch.Generator | None = None):
    super().__init__()
    del encoder_hidden_shapes
    self.state_input_shape = state_input_shape
    self.max_pool = max_pool
    self.visual_input_shape = tuple(visual_input_shape)
    self.encoder = VisionTokenEncoder(visual_input_shape[0], token_dim)
    self.pf_layers = nn.ModuleList(
        TransformerEncoderLayer(token_dim, nh, ff)
        for nh, ff in transformer_params)
    self.vf_layers = nn.ModuleList(
        TransformerEncoderLayer(token_dim, nh, ff)
        for nh, ff in transformer_params)
    self.rgbd = visual_input_shape[0] == 16
    width = (2 if self.rgbd else 1) * token_dim
    self.pf_mlp = MLPHead(width, append_hidden_shapes, action_dim)
    self.vf_mlp = MLPHead(width, append_hidden_shapes, 1)
    self.logstd = nn.Parameter(torch.full((action_dim,), math.log(log_init)))
    if generator is not None:
      self.init_weights(generator)

  def init_weights(self, gen: torch.Generator):
    """The reference's initializers, drawn from `gen`."""
    self.encoder.init_weights(gen)
    for layer in (*self.pf_layers, *self.vf_layers):
      layer.init_weights(gen)
    self.pf_mlp.init_weights(gen)
    self.vf_mlp.init_weights(gen)

  def _tokens(self, x):
    visual_x = x[..., self.state_input_shape:].reshape(
        x.shape[:-1] + self.visual_input_shape)
    return self.encoder(visual_x)

  def _stack(self, t, layers, mlp, fused):
    for layer in layers:
      t = layer(t, fused=fused)
    pm = self.encoder.per_modal_tokens
    pool = ((lambda z: z.amax(dim=1)) if self.max_pool
            else (lambda z: z.mean(dim=1)))
    outs = [pool(t[:, :1 + pm])]
    if self.rgbd:
      outs.append(pool(t[:, pm:2 * pm]))
    return mlp(torch.cat(outs, dim=-1))

  def pi(self, x, fused: bool = False):
    """-> (mean, std, logstd); `fused` as in LocoTransformerActorCritic."""
    return gaussian_head(self.logstd, self._stack(
        self._tokens(x), self.pf_layers, self.pf_mlp, fused))

  def v(self, x, fused: bool = False):
    """-> (B, 1) value."""
    return self._stack(self._tokens(x), self.vf_layers, self.vf_mlp, fused)

  def pi_v(self, x, fused: bool = False):
    """Tokenize once, run both stacks: ((mean, std, logstd), value)."""
    t = self._tokens(x)
    return (gaussian_head(self.logstd, self._stack(t, self.pf_layers,
                                                   self.pf_mlp, fused)),
            self._stack(t, self.vf_layers, self.vf_mlp, fused))


class NatureFuseActorCritic(nn.Module):
  """ppo_nature_cnn: shared NatureFuseEncoder + separate MLP heads
  (starter/ppo_nature_cnn.py:81-100)."""

  def __init__(self, action_dim: int, state_input_shape: int,
               visual_input_shape: Tuple[int, int, int] = (4, 64, 64),
               encoder_hidden_shapes: Sequence[int] = (256, 256),
               visual_dim: int = 256,
               append_hidden_shapes: Sequence[int] = (256, 256),
               log_init: float = 0.125,
               generator: torch.Generator | None = None):
    super().__init__()
    self.state_input_shape = state_input_shape
    self.visual_input_shape = tuple(visual_input_shape)
    self.encoder = NatureFuseEncoder(visual_input_shape, state_input_shape,
                                     encoder_hidden_shapes, visual_dim)
    self.head = GaussianHead(action_dim, log_init)
    self.pf_mlp = MLPHead(self.encoder.out_dim, append_hidden_shapes,
                          action_dim)
    self.vf_mlp = MLPHead(self.encoder.out_dim, append_hidden_shapes, 1)
    if generator is not None:
      self.init_weights(generator)

  def init_weights(self, gen: torch.Generator):
    """The reference's initializers, drawn from `gen`."""
    self.encoder.init_weights(gen)
    self.pf_mlp.init_weights(gen)
    self.vf_mlp.init_weights(gen)

  def _features(self, x):
    state_x = x[..., : self.state_input_shape]
    visual_x = x[..., self.state_input_shape:].reshape(
        x.shape[:-1] + self.visual_input_shape)
    return self.encoder(visual_x, state_x)

  def pi(self, x):
    """-> (mean, std, logstd)."""
    return self.head(self.pf_mlp(self._features(x)))

  def v(self, x):
    """-> (B, 1) value."""
    return self.vf_mlp(self._features(x))


class VisualNetActorCritic(nn.Module):
  """ppo_nature_cnn_vision_only: MLP heads over one shared NatureEncoder's
  flattened output (continuous_policy.py:257, nets.py:133-191).  As in the
  reference and the JAX package there is no projection: the heads take the
  1024-wide conv flatten (the config's visual_dim has no place here).  The
  proprio head of the observation is ignored."""

  def __init__(self, action_dim: int, state_input_shape: int,
               visual_input_shape: Tuple[int, int, int] = (4, 64, 64),
               append_hidden_shapes: Sequence[int] = (256, 256),
               log_init: float = 0.125,
               generator: torch.Generator | None = None):
    super().__init__()
    self.state_input_shape = state_input_shape
    self.visual_input_shape = tuple(visual_input_shape)
    self.backbone = NatureEncoder(visual_input_shape[0])
    width = nature_out_dim(visual_input_shape)
    self.head = GaussianHead(action_dim, log_init)
    self.pf_mlp = MLPHead(width, append_hidden_shapes, action_dim)
    self.vf_mlp = MLPHead(width, append_hidden_shapes, 1)
    if generator is not None:
      self.init_weights(generator)

  def init_weights(self, gen: torch.Generator):
    """The reference's initializers, drawn from `gen`."""
    self.backbone.init_weights(gen)
    self.pf_mlp.init_weights(gen)
    self.vf_mlp.init_weights(gen)

  def _features(self, x):
    visual_x = x[..., self.state_input_shape:].reshape(
        x.shape[:-1] + self.visual_input_shape)
    return self.backbone(visual_x).flatten(1)

  def pi(self, x):
    """-> (mean, std, logstd)."""
    return self.head(self.pf_mlp(self._features(x)))

  def v(self, x):
    """-> (B, 1) value."""
    return self.vf_mlp(self._features(x))


class ImpalaFuseResidualActorCritic(nn.Module):
  """ppo_aux backbone (nets.py:384-530 ImpalaFuseResidualActor; the JAX
  package's ImpalaFuseResidualActorCritic): an Impala visual encoder
  projected to visual_dim beside a proprio MLP; the actor's mean is the
  sum of a fused (visual + state) head and a state-only residual head, and
  the visual features also regress the displacement-sensor history, the
  first history * displacement_dim proprio inputs (the aux loss,
  :488-530)."""

  def __init__(self, action_dim: int, state_input_shape: int,
               visual_input_shape: Tuple[int, int, int] = (4, 64, 64),
               encoder_hidden_shapes: Sequence[int] = (256, 256),
               visual_dim: int = 256,
               append_hidden_shapes: Sequence[int] = (256, 256),
               displacement_dim: int = 7, history: int = 3,
               log_init: float = 0.125,
               generator: torch.Generator | None = None):
    super().__init__()
    self.state_input_shape = state_input_shape
    self.visual_input_shape = tuple(visual_input_shape)
    self.aux_dim = displacement_dim * history
    self.visual_base = ImpalaEncoder(visual_input_shape[0])
    self.visual_proj = RLProjection(impala_out_dim(visual_input_shape),
                                    visual_dim)
    self.state_mlp = MLPBase(state_input_shape, encoder_hidden_shapes)
    fused = visual_dim + self.state_mlp.out_dim
    self.head = GaussianHead(action_dim, log_init)
    self.pf_fused = MLPHead(fused, append_hidden_shapes, action_dim)
    self.pf_state = MLPHead(self.state_mlp.out_dim, append_hidden_shapes,
                            action_dim)
    self.vf_fused = MLPHead(fused, append_hidden_shapes, 1)
    self.aux_head = MLPHead(visual_dim, (), self.aux_dim)
    if generator is not None:
      self.init_weights(generator)

  def init_weights(self, gen: torch.Generator):
    """The reference's initializers, drawn from `gen`."""
    self.visual_base.init_weights(gen)
    self.visual_proj.init_weights(gen)
    self.state_mlp.init_weights(gen)
    for head in (self.pf_fused, self.pf_state, self.vf_fused, self.aux_head):
      head.init_weights(gen)

  def _features(self, x):
    state_x = x[..., : self.state_input_shape]
    visual_x = x[..., self.state_input_shape:].reshape(
        x.shape[:-1] + self.visual_input_shape)
    v = self.visual_proj(self.visual_base(visual_x))
    return v, self.state_mlp(state_x), state_x

  def pi_with_aux(self, x):
    """-> ((mean, std, logstd), aux_loss)."""
    v, s, state_x = self._features(x)
    mean = self.pf_fused(torch.cat([v, s], dim=-1)) + self.pf_state(s)
    disp_gt = state_x[..., : self.aux_dim]
    aux_loss = torch.mean((self.aux_head(v) - disp_gt) ** 2)
    return self.head(mean), aux_loss

  def pi(self, x):
    """-> (mean, std, logstd)."""
    return self.pi_with_aux(x)[0]

  def v(self, x):
    """-> (B, 1) value."""
    v, s, _ = self._features(x)
    return self.vf_fused(torch.cat([v, s], dim=-1))
