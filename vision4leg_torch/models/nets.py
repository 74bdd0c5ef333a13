"""Network heads (torch mirror of vision4leg_tpu.models.nets; reference
torchrl/networks/nets.py): Net, LocoTransformer, Transformer and
NatureFuseNet, built from the port's `models/base.py` pieces.  Each maps
a flat observation to `output_shape` outputs; their transformer layers
are the plain (unfused) ones, as in the JAX package.  Torch needs the
input widths that flax infers: `input_shape` for Net, the proprio width
`state_input_shape` and the image shape for the others.  The JAX package
keeps these heads beside the actor-critics, and no starter uses them;
`convert.nets_params_from_flax` maps their flax parameters."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vision4leg_torch.models.actor_critic import MLPHead
from vision4leg_torch.models.base import (LocoTransformerEncoder, MLPBase,
                                          NatureFuseEncoder,
                                          TransformerEncoderLayer)


class Net(nn.Module):
  """MLPBase + append FCs + small-uniform last layer (nets.py:16-70): the
  `ppo_state` policy/value network."""

  def __init__(self, output_shape: int, input_shape: int,
               hidden_shapes: Sequence[int],
               append_hidden_shapes: Sequence[int] = ()):
    super().__init__()
    self.base = MLPBase(input_shape, hidden_shapes)
    self.head = MLPHead(self.base.out_dim, append_hidden_shapes,
                        output_shape)

  def init_weights(self, gen: torch.Generator):
    self.base.init_weights(gen)
    self.head.init_weights(gen)

  def forward(self, x):
    return self.head(self.base(x))


class _TokenNet(nn.Module):
  """The tokenizer and transformer stack of LocoTransformer and
  Transformer: flat obs [proprio | image (C, 64, 64)] -> tokens after the
  layers (B, 1 + 16 M, token_dim)."""

  def __init__(self, state_input_shape: int, visual_input_shape,
               encoder_hidden_shapes: Sequence[int],
               transformer_params: Sequence[tuple], token_dim: int,
               two_by_two: bool = False, token_norm: bool = False):
    super().__init__()
    self.state_input_shape = state_input_shape
    self.visual_input_shape = tuple(visual_input_shape)
    self.encoder = LocoTransformerEncoder(
        visual_input_shape[0], state_input_shape, encoder_hidden_shapes,
        token_dim, two_by_two=two_by_two)
    self.token_norm = (nn.LayerNorm(token_dim, eps=1e-6) if token_norm
                       else None)
    self.layers = nn.ModuleList(
        TransformerEncoderLayer(token_dim, nh, ff)
        for nh, ff in transformer_params)

  def init_weights(self, gen: torch.Generator):
    self.encoder.init_weights(gen)
    for layer in self.layers:
      layer.init_weights(gen)

  def tokens(self, x):
    state_x = x[..., : self.state_input_shape]
    visual_x = x[..., self.state_input_shape:].reshape(
        x.shape[:-1] + self.visual_input_shape)
    t = self.encoder(visual_x, state_x)
    if self.token_norm is not None:
      t = self.token_norm(t)
    for layer in self.layers:
      t = layer(t)
    return t

  def pool(self, t):
    return t.amax(dim=1) if self.max_pool else t.mean(dim=1)


class LocoTransformer(_TokenNet):
  """Cross-modal transformer head (nets.py:909-1038): tokens -> layers ->
  [state token, the pooled tokens of each modality] -> MLP -> output."""

  def __init__(self, output_shape: int, state_input_shape: int,
               visual_input_shape, encoder_hidden_shapes: Sequence[int],
               transformer_params: Sequence[tuple] = ((1, 256), (1, 256)),
               append_hidden_shapes: Sequence[int] = (256, 256),
               token_dim: int = 64, max_pool: bool = False,
               token_norm: bool = False, two_by_two: bool = False):
    super().__init__(state_input_shape, visual_input_shape,
                     encoder_hidden_shapes, transformer_params, token_dim,
                     two_by_two, token_norm)
    self.max_pool = max_pool
    self.n_modal = 2 if visual_input_shape[0] == 16 else 1
    self.head = MLPHead((1 + self.n_modal) * token_dim,
                        append_hidden_shapes, output_shape)

  def init_weights(self, gen: torch.Generator):
    super().init_weights(gen)
    self.head.init_weights(gen)

  def forward(self, x):
    t = self.tokens(x)
    pm = self.encoder.per_modal_tokens
    h = torch.cat([t[:, 0]] + [self.pool(t[:, 1 + i * pm: 1 + (i + 1) * pm])
                               for i in range(self.n_modal)], dim=-1)
    return self.head(h)


class Transformer(_TokenNet):
  """Vision-only transformer head (nets.py:784-907): LocoTransformer's
  tokens and layers, the head on the pool of every token but the
  state's."""

  def __init__(self, output_shape: int, state_input_shape: int,
               visual_input_shape, encoder_hidden_shapes: Sequence[int],
               transformer_params: Sequence[tuple] = ((1, 256), (1, 256)),
               append_hidden_shapes: Sequence[int] = (256, 256),
               token_dim: int = 64, max_pool: bool = False):
    super().__init__(state_input_shape, visual_input_shape,
                     encoder_hidden_shapes, transformer_params, token_dim)
    self.max_pool = max_pool
    self.head = MLPHead(token_dim, append_hidden_shapes, output_shape)

  def init_weights(self, gen: torch.Generator):
    super().init_weights(gen)
    self.head.init_weights(gen)

  def forward(self, x):
    return self.head(self.pool(self.tokens(x)[:, 1:]))


class NatureFuseNet(nn.Module):
  """Nature-CNN + proprio fuse net (the `ppo_nature_cnn` baseline's
  policy/value head; ref nets.py:133-250 with NatureFuseEncoder)."""

  def __init__(self, output_shape: int, state_input_shape: int,
               visual_input_shape, encoder_hidden_shapes: Sequence[int],
               visual_dim: int = 256,
               append_hidden_shapes: Sequence[int] = (256, 256)):
    super().__init__()
    self.state_input_shape = state_input_shape
    self.visual_input_shape = tuple(visual_input_shape)
    self.encoder = NatureFuseEncoder(visual_input_shape, state_input_shape,
                                     encoder_hidden_shapes, visual_dim)
    self.head = MLPHead(self.encoder.out_dim, append_hidden_shapes,
                        output_shape)

  def init_weights(self, gen: torch.Generator):
    self.encoder.init_weights(gen)
    self.head.init_weights(gen)

  def forward(self, x):
    state_x = x[..., : self.state_input_shape]
    visual_x = x[..., self.state_input_shape:].reshape(
        x.shape[:-1] + self.visual_input_shape)
    return self.head(self.encoder(visual_x, state_x))
