"""Running observation normalizer (torch mirror of
vision4leg_tpu.data.normalizer; reference torchrl/env/base_wrapper.py:
44-101 and vision4leg/get_env.py:41-67 NormObsWithImg: only the proprio
head is normalized, the image tail passes through raw)."""
from __future__ import annotations

import dataclasses

import torch

from vision4leg_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class NormalizerState:
  mean: torch.Tensor   # (D,)
  var: torch.Tensor    # (D,)
  count: torch.Tensor  # ()


def init_normalizer(dim: int, device="cpu") -> NormalizerState:
  return NormalizerState(mean=torch.zeros(dim, device=device),
                         var=torch.ones(dim, device=device),
                         count=torch.tensor(1e-4, device=device))


def update(state: NormalizerState, batch,
           mesh: mesh_lib.Mesh = mesh_lib.ONE) -> NormalizerState:
  """Merge the statistics of a (B, D) batch (base_wrapper.py:44-61).
  Under a sharded `mesh` the batch is this rank's rows of the global one,
  whose statistics are merged (`Mesh.moments`)."""
  b_count = batch.shape[0] * mesh.world
  if batch.shape[-1]:
    b_mean, b_var = mesh.moments(batch)
  else:
    # a zero-size head (vision-only envs) has nothing to merge but the
    # count; torch.var warns on it
    b_mean = b_var = torch.mean(batch, dim=0)
  delta = b_mean - state.mean
  tot = state.count + b_count
  new_mean = state.mean + delta * b_count / tot
  m2 = (state.var * state.count + b_var * b_count
        + delta * delta * state.count * b_count / tot)
  return NormalizerState(mean=new_mean, var=m2 / tot, count=tot)


def filt(state: NormalizerState, x, clip: float = 10.0):
  return torch.clamp((x - state.mean) / (torch.sqrt(state.var) + 1e-4),
                     -clip, clip)


def filt_with_img_tail(state: NormalizerState, x, proprio_dim: int,
                       clip: float = 10.0):
  head = filt(state, x[..., :proprio_dim], clip)
  return torch.cat([head, x[..., proprio_dim:]], dim=-1)
