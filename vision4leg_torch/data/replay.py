"""Off-policy replay buffer on the agent's device (torch mirror of
vision4leg_tpu.data.replay; reference torchrl/replay_buffers/base.py, a
dict-of-arrays ring).

A fixed-capacity ring of tensors written by the collector and sampled
uniformly by the updates.  Unlike the JAX buffer, which is a value,
`add_batch` writes into the ring in place and returns it with its new
position and size."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class ReplayBuffer:
  data: Dict[str, torch.Tensor]   # each (capacity, ...)
  pos: int                        # next write index
  size: int                       # valid entries

  @property
  def capacity(self) -> int:
    return next(iter(self.data.values())).shape[0]


def init_replay(capacity: int, example: Dict[str, torch.Tensor]
                ) -> ReplayBuffer:
  """Zeros of (capacity,) + each example's shape, dtype and device."""
  data = {k: torch.zeros((capacity,) + tuple(v.shape), dtype=v.dtype,
                         device=v.device) for k, v in example.items()}
  return ReplayBuffer(data=data, pos=0, size=0)


def add_batch(rb: ReplayBuffer, batch: Dict[str, torch.Tensor]
              ) -> ReplayBuffer:
  """Insert a batch of B transitions at the ring position, wrapping at
  the capacity; `size` saturates there."""
  b = next(iter(batch.values())).shape[0]
  cap = rb.capacity
  dev = next(iter(rb.data.values())).device
  idx = (rb.pos + torch.arange(b, device=dev)) % cap
  for k, v in batch.items():
    rb.data[k].index_copy_(0, idx, v.to(rb.data[k].dtype))
  return ReplayBuffer(data=rb.data, pos=(rb.pos + b) % cap,
                      size=min(rb.size + b, cap))


def sample(rb: ReplayBuffer, batch_size: int, gen=None, idx=None
           ) -> Dict[str, torch.Tensor]:
  """batch_size transitions drawn uniformly from the first max(size, 1)
  slots by `gen`, or at the given indices `idx`."""
  if idx is None:
    dev = next(iter(rb.data.values())).device
    idx = torch.randint(0, max(rb.size, 1), (batch_size,), generator=gen,
                        device=dev)
  return {k: v[idx] for k, v in rb.data.items()}
