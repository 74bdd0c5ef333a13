"""PyTorch/CUDA port of `vision4leg_tpu`.

The JAX package stays the reference; this package mirrors its module
layout (physics/, robots/, ops/, envs/, models/, data/, collector/) and
never imports JAX or `vision4leg_tpu`.  Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
  """The device an entry point runs on: "cuda" unless the caller asks for
  another.  Raises when CUDA is asked for and no card is present, so a
  run never carries on quietly on the CPU."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "vision4leg_torch: no CUDA device is available; pass device='cpu' "
        "to run the plain PyTorch path on the CPU")
  return dev
