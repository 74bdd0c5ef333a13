"""Tracing and profiling utilities (mirror of
vision4leg_tpu.utils.profiling).

The reference's only observability is coarse wall-clock accounting
(rl_algo.py:111-156 Explore/Train/Eval times).  This module provides:

  * `PhaseTimer`: the Explore_Time / Train___Time accounting, each phase
    stopped only after the device of its `block_on` tensors finished;
  * `trace(logdir)`: a torch.profiler trace of a region (host and, on a
    card, CUDA activity), written into `logdir` as a Chrome trace that
    TensorBoard's profiler plugin or chrome://tracing reads;
  * `device_memory_summary()`: the caching allocator's bytes in use, its
    peak and the card's capacity, per card.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def block_until_ready(tree):
  """Wait for the devices of every tensor in `tree` (a tensor, or lists,
  tuples, dicts and dataclasses of them); returns `tree`."""
  devices = set()

  def visit(x):
    if isinstance(x, torch.Tensor):
      devices.add(x.device)
    elif isinstance(x, dict):
      for v in x.values():
        visit(v)
    elif isinstance(x, (list, tuple)):
      for v in x:
        visit(v)
    elif hasattr(x, "__dataclass_fields__"):
      for name in x.__dataclass_fields__:
        visit(getattr(x, name))

  visit(tree)
  for d in devices:
    if d.type == "cuda":
      torch.cuda.synchronize(d)
  return tree


class PhaseTimer:
  """Accumulates wall-clock per named phase (blocks on device results)."""

  def __init__(self):
    self.totals = defaultdict(float)
    self.counts = defaultdict(int)

  @contextlib.contextmanager
  def phase(self, name: str, block_on=None):
    t0 = time.time()
    yield
    if block_on is not None:
      block_until_ready(block_on)
    self.totals[name] += time.time() - t0
    self.counts[name] += 1

  def summary(self) -> dict:
    return {f"{k}_Time": v for k, v in self.totals.items()}

  def reset(self):
    self.totals.clear()
    self.counts.clear()


@contextlib.contextmanager
def trace(logdir: str):
  """Capture a torch.profiler trace of the enclosed region into
  `logdir` (CPU activity, and CUDA activity when a card is present)."""
  acts = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(logdir, exist_ok=True)
  prof = torch.profiler.profile(
      activities=acts,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
  prof.start()
  try:
    yield prof
  finally:
    prof.stop()


def device_memory_summary() -> dict:
  """Per card: bytes held by live tensors, their peak since the last
  reset, and the card's total memory ({} without a card)."""
  out = {}
  if not torch.cuda.is_available():
    return out
  for i in range(torch.cuda.device_count()):
    stats = torch.cuda.memory_stats(i)
    _, total = torch.cuda.mem_get_info(i)
    out[f"cuda:{i}"] = {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
  return out
