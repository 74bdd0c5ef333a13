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
    peak and the card's capacity, per card;
  * `span(name)` and `count(name, n)`: the program's own spans and
    counters, recorded only while a torch profiler records (any: `trace`
    here, or a caller's `torch.profiler.profile`), and
    read back with `recorded()`.

A span opens a `record_function` range, so it sits on the profiler's
timeline, and keeps (name, parent, start_ns, end_ns, thread) in memory:
`time.time_ns()` stamps taken inside that range, on the clock of the
profiler's events, so a reader can hold the program's spans against the
device's operations of the same profile.  `parent` is the span open on
the same thread when it opened (the autograd thread that runs a backward
keeps its own).  With no profiler recording, `span` returns one shared
null context after a single check, and `count` does nothing.  Every
span's name starts with `v4l.`.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

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
  clear()
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


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------


class Span(NamedTuple):
  name: str
  parent: Optional[str]      # the span open on this thread when it opened
  start_ns: int              # time.time_ns(), inside the profiler's range
  end_ns: int
  thread: int                # threading.get_ident()


class Recorded(NamedTuple):
  spans: List[Span]
  counts: Dict[str, int]


_SPANS: List[Span] = []
_COUNTS: Dict[str, int] = defaultdict(int)
_OPEN = threading.local()      # .names: this thread's open spans
_NULL = contextlib.nullcontext()


class _Span:
  __slots__ = ("name", "parent", "start", "range", "names")

  def __init__(self, name: str):
    self.name = name

  def __enter__(self):
    self.range = torch.profiler.record_function(self.name)
    self.range.__enter__()
    names = getattr(_OPEN, "names", None)
    if names is None:
      names = _OPEN.names = []
    self.parent = names[-1] if names else None
    names.append(self.name)
    self.names = names
    self.start = time.time_ns()
    return self

  def __exit__(self, *exc):
    end = time.time_ns()
    self.names.pop()
    _SPANS.append(Span(self.name, self.parent, self.start, end,
                       threading.get_ident()))
    self.range.__exit__(*exc)


def span(name: str):
  """A context that records the enclosed region as the span `name` while
  a torch profiler records; otherwise a shared null context."""
  if not torch.autograd._profiler_enabled():
    return _NULL
  return _Span(name)


def count(name: str, n: int = 1):
  """Add the host integer n to the counter `name` while a torch profiler
  records."""
  if torch.autograd._profiler_enabled():
    _COUNTS[name] += n


def recorded() -> Recorded:
  """The spans (in the order they closed) and counters recorded since
  the last `clear`."""
  return Recorded(list(_SPANS), dict(_COUNTS))


def clear():
  _SPANS.clear()
  _COUNTS.clear()
