"""A learner's minibatch step replayed as a CUDA graph.

On one CUDA device the PPO minibatch step (the advantages' normalization,
the value forward and backward, the clipped value Adam, the policy forward
and backward, the clipped policy Adam, the metrics) is some 900 small
launches, and the host takes longer to make them than the card takes to
run them.  `StepGraphs` captures the step and replays it: the same kernels
(cuDNN's convolutions, the fused layer's, torch's foreach Adam) in the same
order on the same addresses, launched by one graph launch.

Lifetime: one `StepGraphs` serves one `update_per_epoch` call and is
dropped at its end, with its graphs, their outputs and the bias tensors.
What lasts across calls (`CaptureStream`: the side stream the captures
run on, the graphs' memory pool, the batch shapes already stepped once)
holds no batch-sized memory.

A graph is keyed by the batch's shapes and the optimizers' learning rates
(each rate is baked into the captured step as the eager step's scalar; it
changes once an epoch).  The first step of a batch shape in the learner's
life runs eagerly on the side stream, as the warm-up (cuDNN's and cuBLAS's
lazy set-up); from the second on, each key is captured once and replayed.
Before each replay:
  * the batch is copied into the captured inputs where it lies elsewhere
    (`update_per_epoch` gathers straight into them, so nothing is copied);
  * the reciprocals of the optimizers' bias corrections, which change
    every step, are filled into float32 0-d tensors: the eager step divides
    by the corrections as Python scalars, which on the card is the product
    with the float32 reciprocal (`inverse_bias_corrections`).
After it, the metrics, which the next replay overwrites, are cloned (one
stack).  The optimizer states come back as the eager step returns them:
the same moment tensors (updated in place), the count advanced as far as
the captured step advanced it.

A replay calls no Python of the step: the kernel wrappers' launch
counters (`.launches` in ops/attention.py) count the capture's calls
once, and a device trace names each replayed kernel as it names an eager
one.  Each replay runs inside a `v4l.learner.replay` span, each capture
inside `v4l.learner.capture`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Tuple

import torch

from vision4leg_torch.algo.on_policy_base import (AdamState, MaskedAdam,
                                                  inverse_bias_corrections)
from vision4leg_torch.utils import profiling


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
  """a and b are the same memory seen the same way."""
  return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
          and a.stride() == b.stride() and a.dtype == b.dtype)


class CaptureStream:
  """What a learner's graphs share across its `update_per_epoch` calls:
  the side stream they are captured on, their memory pool, and the batch
  shapes whose first (warm-up) step has run.

  A graph's pool lives as long as some graph captured into it, and torch
  refuses a pool again once its last graph is gone; so a graph of one
  small memset, kept here, holds the pool between the calls.  Its memory
  is free in the pool: nothing it holds counts as allocated."""

  def __init__(self, device: torch.device):
    self.device = device
    self.stream = torch.cuda.Stream(device)
    self.warmed = set()
    self.keeper = torch.cuda.CUDAGraph()
    with self.side():
      self.keeper.capture_begin()
      torch.zeros(1, device=device)
      self.keeper.capture_end()
    self.pool = self.keeper.pool()

  @contextlib.contextmanager
  def side(self):
    """The block's launches on the side stream, ordered after everything
    launched before it and before everything launched after it.  cuBLAS
    keeps a workspace for each handle (one a thread) and stream for the
    life of the process: its workspaces are dropped before and after the
    block, so that the side stream's do not outlive it (a capture's lies
    in the graph's pool, as torch's own graph trees do it) and the device
    memory in use stays the eager path's."""
    here = torch.cuda.current_stream(self.device)
    self.stream.wait_stream(here)
    torch._C._cuda_clearCublasWorkspaces()
    try:
      with torch.cuda.stream(self.stream):
        yield
    finally:
      torch._C._cuda_clearCublasWorkspaces()
    here.wait_stream(self.stream)


@dataclasses.dataclass
class _Graph:
  graph: "torch.cuda.CUDAGraph"
  inputs: Tuple[torch.Tensor, ...]     # the batch the graph reads
  states: Dict[str, AdamState]         # the optimizer states it steps
  out: Dict[str, AdamState]            # ... as the captured step left them
  names: Tuple[str, ...]               # the metrics' names
  metrics: torch.Tensor                # stacked; each replay overwrites

  def steps(self, states: Dict[str, AdamState]) -> bool:
    """The graph updates these states' moments in place."""
    ids = lambda s: [id(x) for x in s.mu + s.nu]
    return all(ids(states[n]) == ids(c) for n, c in self.states.items())


class StepGraphs:
  """The graphs of one `update_per_epoch` call.  `txs` maps the fields of
  the TrainState that the step advances to their optimizers."""

  def __init__(self, home: CaptureStream, txs: Dict[str, MaskedAdam]):
    self.home = home
    self.txs = txs
    self.graphs: Dict[tuple, _Graph] = {}
    self.inv_bias: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

  def step(self, fn: Callable, ts, batch):
    """fn(ts, batch) -> (ts, metrics), eagerly the first time the learner
    sees the batch's shapes, else replayed from its graph."""
    home = self.home
    shapes = tuple((tuple(x.shape), x.dtype) for x in batch)
    if shapes not in home.warmed:
      with home.side():
        out = fn(ts, batch)
      home.warmed.add(shapes)
      return out
    states = {n: getattr(ts, n) for n in self.txs}
    key = (shapes,) + tuple(tx.lr(states[n].count)
                            for n, tx in self.txs.items())
    g = self.graphs.get(key)
    if g is None or not g.steps(states):
      g = self.graphs[key] = self._capture(fn, ts, batch, states)
    for dst, src in zip(g.inputs, batch):
      if not _same(dst, src):
        dst.copy_(src)
    for n, (r1, r2) in self.inv_bias.items():
      v1, v2 = inverse_bias_corrections(states[n].count + 1)
      r1.fill_(v1)
      r2.fill_(v2)
    with profiling.span("v4l.learner.replay"):
      g.graph.replay()
    metrics = dict(zip(g.names, g.metrics.clone().unbind()))
    return ts.replace(**{
        n: dataclasses.replace(
            g.out[n], count=s.count + g.out[n].count - g.states[n].count)
        for n, s in states.items()}), metrics

  def _capture(self, fn: Callable, ts, batch, states) -> _Graph:
    dev = batch[0].device
    for n in self.txs:
      if n not in self.inv_bias:
        self.inv_bias[n] = tuple(
            torch.empty((), dtype=torch.float32, device=dev) for _ in range(2))
    graph = torch.cuda.CUDAGraph()
    with profiling.span("v4l.learner.capture"), self.home.side():
      for n, tx in self.txs.items():
        tx.inv_bias = self.inv_bias[n]
      graph.capture_begin(pool=self.home.pool)
      try:
        out, metrics = fn(ts, batch)
        stacked = torch.stack(list(metrics.values()))
      finally:
        graph.capture_end()
        for tx in self.txs.values():
          tx.inv_bias = None
    return _Graph(graph, tuple(batch), states,
                  {n: getattr(out, n) for n in self.txs},
                  tuple(metrics), stacked)
