"""Encoder modules (torch mirror of vision4leg_tpu.models.base; reference
torchrl/networks/base.py).  Images arrive channel-first (B, C, 64, 64),
the layout of the observation's raw_img tail."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vision4leg_torch.models import init as winit
from vision4leg_torch.ops import attention


class MLPBase(nn.Module):
  """Linear + ReLU stack (base.py:8-44)."""

  def __init__(self, in_dim: int, hidden_shapes: Sequence[int]):
    super().__init__()
    dims = [in_dim, *hidden_shapes]
    self.layers = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
    self.out_dim = dims[-1]

  def init_weights(self, gen):
    for layer in self.layers:
      winit.fanin_uniform_(layer, gen)

  def forward(self, x):
    for layer in self.layers:
      x = torch.relu(layer(x))
    return x


class NatureEncoder(nn.Module):
  """Nature CNN (base.py:304-343): 32c8s4 - 64c4s2 - 64c3s1, ReLU.
  (B, C, 64, 64) -> (B, 64, 4, 4)."""

  def __init__(self, in_channels: int):
    super().__init__()
    self.convs = nn.ModuleList([nn.Conv2d(in_channels, 32, 8, 4),
                                nn.Conv2d(32, 64, 4, 2),
                                nn.Conv2d(64, 64, 3, 1)])

  def init_weights(self, gen):
    for conv in self.convs:
      winit.orthogonal_(conv, gen)

  def forward(self, x):
    for conv in self.convs:
      x = torch.relu(conv(x))
    return x


def nature_out_dim(visual_input_shape) -> int:
  """Width of NatureEncoder's flattened output on (C, H, W) inputs."""
  _, h, w = visual_input_shape
  for k, st in ((8, 4), (4, 2), (3, 1)):
    h, w = (h - k) // st + 1, (w - k) // st + 1
  return 64 * h * w


class ImpalaResBlock(nn.Module):
  """x + conv(relu(conv(relu(x)))), 3x3 convs with padding 1; every
  Impala conv xavier-uniform with zero bias, as the reference applies
  xavier_uniform_init (base.py:171)."""

  def __init__(self, feats: int):
    super().__init__()
    self.conv0 = nn.Conv2d(feats, feats, 3, padding=1)
    self.conv1 = nn.Conv2d(feats, feats, 3, padding=1)

  def init_weights(self, gen):
    winit.xavier_uniform_(self.conv0, gen)
    winit.xavier_uniform_(self.conv1, gen)

  def forward(self, x):
    h = self.conv0(torch.relu(x))
    return x + self.conv1(torch.relu(h))


IMPALA_FEATS = (16, 32, 32)


class ImpalaEncoder(nn.Module):
  """Residual conv stack (base.py:158-207): per stage a 3x3 conv, a 3/2
  max-pool with symmetric padding 1 (torch MaxPool2d's, which the JAX
  package pads explicitly) and two residual blocks; a final ReLU; the
  output flattened in (C, H, W) order.  (B, C, H, W) -> (B, out_dim)."""

  def __init__(self, in_channels: int):
    super().__init__()
    dims = [in_channels, *IMPALA_FEATS]
    self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1)
                               for a, b in zip(dims[:-1], dims[1:]))
    self.blocks = nn.ModuleList(ImpalaResBlock(f) for f in IMPALA_FEATS
                                for _ in range(2))

  def init_weights(self, gen):
    for i, conv in enumerate(self.convs):
      winit.xavier_uniform_(conv, gen)
      self.blocks[2 * i].init_weights(gen)
      self.blocks[2 * i + 1].init_weights(gen)

  def forward(self, x):
    for i, conv in enumerate(self.convs):
      x = torch.nn.functional.max_pool2d(conv(x), 3, 2, padding=1)
      x = self.blocks[2 * i + 1](self.blocks[2 * i](x))
    return torch.relu(x).flatten(1)


def impala_out_dim(visual_input_shape) -> int:
  """Width of ImpalaEncoder's flattened output on (C, H, W) inputs."""
  _, h, w = visual_input_shape
  for _ in IMPALA_FEATS:
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
  return IMPALA_FEATS[-1] * h * w


class RLProjection(nn.Module):
  """Linear + ReLU projection (base.py:209-230)."""

  def __init__(self, in_dim: int, out_dim: int):
    super().__init__()
    self.dense = nn.Linear(in_dim, out_dim)

  def init_weights(self, gen):
    winit.fanin_uniform_(self.dense, gen)

  def forward(self, x):
    return torch.relu(self.dense(x))


class NatureFuseEncoder(nn.Module):
  """Nature CNN on the depth frames, flattened in (C, H, W) order and
  projected to visual_dim, beside a proprio MLP; the two concatenated
  (base.py:345-386): the `ppo_nature_cnn` baseline's shared trunk.
  Output (B, visual_dim + hidden_shapes[-1])."""

  def __init__(self, visual_input_shape, state_dim: int,
               hidden_shapes: Sequence[int], visual_dim: int = 256):
    super().__init__()
    self.nature = NatureEncoder(visual_input_shape[0])
    self.projection = RLProjection(nature_out_dim(visual_input_shape),
                                   visual_dim)
    self.state_mlp = MLPBase(state_dim, hidden_shapes)
    self.out_dim = visual_dim + self.state_mlp.out_dim

  def init_weights(self, gen):
    self.nature.init_weights(gen)
    self.projection.init_weights(gen)
    self.state_mlp.init_weights(gen)

  def forward(self, visual_x, state_x):
    v = self.projection(self.nature(visual_x).flatten(1))
    return torch.cat([v, self.state_mlp(state_x)], dim=-1)


def modality_slices(in_channels: int):
  """The channel slices of the image's modalities, rgb first: rgb is
  channels 0..11 (four rgb frames) and depth the last four (JAX
  base.py:158-165); 4 channels are depth alone, 12 rgb alone."""
  if in_channels not in (4, 12, 16):
    raise ValueError(f"the tokenizers take 4 (depth), 12 (rgb) or 16 "
                     f"(rgbd) channels, got {in_channels}")
  rgb = slice(0, 12) if in_channels in (12, 16) else None
  depth = (slice(12, 16) if in_channels == 16
           else slice(0, 4) if in_channels == 4 else None)
  return rgb, depth


class _Modalities(nn.Module):
  """The rgb and depth tokenizers of 4, 12 or 16 channels
  (`modality_slices`): per modality NatureEncoder -> 1x1 conv (or, with
  two_by_two, 2x2 stride-2 conv) to token_dim -> 16 (or 4) spatial
  tokens, row-major over the conv's output grid.  The depth modality
  keeps the names of the 4-frame tokenizer (`nature`, `token_conv`), so
  that the port's earlier snapshots and checkpoints load; rgb's are
  `rgb_nature`, `rgb_token_conv`."""

  def _add_modalities(self, in_channels: int, token_dim: int,
                      two_by_two: bool):
    self.rgb_slice, self.depth_slice = modality_slices(in_channels)
    self.per_modal_tokens = 4 if two_by_two else 16
    conv = lambda: (nn.Conv2d(64, token_dim, 2, 2) if two_by_two
                    else nn.Conv2d(64, token_dim, 1))
    self._modalities = []   # (name, Nature CNN, token conv, channels)
    if self.rgb_slice is not None:
      self.rgb_nature, self.rgb_token_conv = NatureEncoder(12), conv()
      self._modalities.append(("rgb", self.rgb_nature, self.rgb_token_conv,
                               self.rgb_slice))
    if self.depth_slice is not None:
      self.nature, self.token_conv = NatureEncoder(4), conv()
      self._modalities.append(("depth", self.nature, self.token_conv,
                               self.depth_slice))

  def _init_modalities(self, gen):
    for _, nature, conv, _ in self._modalities:
      nature.init_weights(gen)
      winit.orthogonal_(conv, gen)

  def modality_tokens(self, visual_x):
    """{"rgb" or "depth": (B, per_modal_tokens, token_dim)}, contiguous
    as the fused layer takes them."""
    out = {}
    for name, nature, conv, sl in self._modalities:
      h = conv(nature(visual_x[:, sl]))                  # (B, D, P, P)
      out[name] = h.flatten(2).transpose(1, 2).contiguous()
    return out


class LocoTransformerEncoder(_Modalities):
  """Tokenizer (base.py:497-627): a projected proprio token, then each
  modality's 16 (or, with two_by_two, 4) spatial tokens, in the order
  state, [rgb], [depth] (base.py:611-622).  Output (B, 1 + 16 M,
  token_dim) for M modalities: 17 tokens on 4 depth frames, 33 on rgbd."""

  def __init__(self, in_channels: int, state_dim: int,
               hidden_shapes: Sequence[int], token_dim: int = 64,
               two_by_two: bool = False):
    super().__init__()
    self.state_mlp = MLPBase(state_dim, hidden_shapes)
    self.state_proj = nn.Linear(self.state_mlp.out_dim, token_dim)
    self._add_modalities(in_channels, token_dim, two_by_two)

  def init_weights(self, gen):
    self.state_mlp.init_weights(gen)
    winit.fanin_uniform_(self.state_proj, gen)
    self._init_modalities(gen)

  def forward(self, visual_x, state_x):
    s = torch.relu(self.state_proj(self.state_mlp(state_x)))
    return torch.cat([s[:, None], *self.modality_tokens(visual_x).values()],
                     dim=1)


class VisionTokenEncoder(_Modalities):
  """Vision-only tokenizer (base.py:388-496): each modality's 16 (or 4)
  spatial tokens and no proprio token, in the order depth, rgb for 16
  channels (base.py:488-493), the opposite of LocoTransformerEncoder's.
  Output (B, 16 M, token_dim)."""

  def __init__(self, in_channels: int, token_dim: int = 64,
               two_by_two: bool = False):
    super().__init__()
    self._add_modalities(in_channels, token_dim, two_by_two)

  def init_weights(self, gen):
    self._init_modalities(gen)

  def forward(self, visual_x):
    t = self.modality_tokens(visual_x)
    parts = [t[k] for k in ("depth", "rgb") if k in t]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class TransformerEncoderLayer(nn.Module):
  """Post-norm encoder layer, dropout 0 (torch nn.TransformerEncoderLayer
  semantics, as the flax mirror): x = LN(x + SelfAttn(x));
  x = LN(x + FFN(x)).  LayerNorm eps 1e-6 as flax's.

  `fused=True` runs the layer through the fused kernel with this layer's
  own parameters (`ops.attention.fused_transformer_layer_ad`: the CUDA
  kernel forward on the card, plain math on the CPU; differentiable).  It
  takes a single head and float32 only, and raises otherwise, where the
  JAX package quietly takes the unfused path."""

  def __init__(self, d_model: int, n_head: int, dim_feedforward: int):
    super().__init__()
    if d_model % n_head:
      raise ValueError("d_model must divide by n_head")
    self.n_head = n_head
    self.query = nn.Linear(d_model, d_model)
    self.key = nn.Linear(d_model, d_model)
    self.value = nn.Linear(d_model, d_model)
    self.out = nn.Linear(d_model, d_model)
    self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
    self.ff1 = nn.Linear(d_model, dim_feedforward)
    self.ff2 = nn.Linear(dim_feedforward, d_model)
    self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

  def init_weights(self, gen):
    for layer in (self.query, self.key, self.value, self.out, self.ff1,
                  self.ff2):
      winit.lecun_normal_(layer, gen)

  def forward(self, x, fused: bool = False):              # (B, T, D)
    if fused:
      if self.n_head != 1 or x.dtype != torch.float32:
        raise NotImplementedError(
            f"fused transformer layer: one head and float32 only, got "
            f"{self.n_head} heads and {x.dtype} (bf16 collection builds "
            "its forward with the fused layer off, as the JAX layer routes "
            "a non-float32 input, vision4leg_tpu/models/base.py:233-238)")
      return attention.fused_transformer_layer_ad(
          x, attention.weights_from_layer(self))
    B, T, D = x.shape
    hd = D // self.n_head
    split = lambda y: y.view(B, T, self.n_head, hd).transpose(1, 2)
    q = split(self.query(x)) / hd ** 0.5
    k, v = split(self.key(x)), split(self.value(x))
    a = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = self.out((a @ v).transpose(1, 2).reshape(B, T, D))
    x = self.norm1(x + o)
    return self.norm2(x + self.ff2(torch.relu(self.ff1(x))))
