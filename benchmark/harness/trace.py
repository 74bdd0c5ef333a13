"""Reading a torch.profiler trace: device time by span, the device's busy
time as the union of its operations on the timeline, and the breakdown.

A span is a `record_function` range that the benchmark puts around a
layer's entry point (harness/spans.py).  A device operation belongs to a
span when the host call that launched it (matched by the profiler's
correlation id) started inside that span.  Spans of one name neither nest
nor overlap, so each name is looked up on its own, by time alone: the
backward's spans open on autograd's thread while the main thread waits
inside the learner's span, and both contain the backward's kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW_SPAN = "bench_window"


@dataclasses.dataclass
class Interval:
  name: str
  start: int          # ns
  end: int            # ns
  thread: int = 0


@dataclasses.dataclass
class Trace:
  """What a traced window left: our spans on the host, the device's
  operations and the host start of their launch."""
  spans: List[Interval]
  ops: List[Interval]                 # device operations
  launch_start: np.ndarray            # (n_ops,) ns, -1 where unmatched

  @classmethod
  def from_kineto(cls, events, span_names) -> "Trace":
    """From `prof.profiler.kineto_results.events()`.  A device operation's
    launch is the runtime call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...) that shares its correlation id; failing that,
    the host op it is linked to."""
    names = set(span_names) | {WINDOW_SPAN}
    spans, ops, runtime, host = [], [], {}, {}
    for e in events:
      dev = str(e.device_type())
      if dev.endswith("CPU"):
        name = e.name()
        if name.startswith("cu"):
          runtime[e.correlation_id()] = e.start_ns()
        else:
          host[e.correlation_id()] = e.start_ns()
        if name in names:
          spans.append(Interval(name, e.start_ns(),
                                e.start_ns() + e.duration_ns(),
                                e.start_thread_id()))
      elif dev.endswith("CUDA") and not e.is_user_annotation():
        ops.append(e)
    starts, out = [], []
    for e in ops:
      s = runtime.get(e.correlation_id(), -1)
      if s < 0 and e.linked_correlation_id() > 0:
        s = host.get(e.linked_correlation_id(), -1)
      out.append(Interval(e.name(), e.start_ns(),
                          e.start_ns() + e.duration_ns()))
      starts.append(s)
    return cls(spans, out, np.asarray(starts, np.int64))

  # ------------------------------------------------------------------
  def window(self) -> Tuple[int, int]:
    w = [s for s in self.spans if s.name == WINDOW_SPAN]
    if not w:
      raise ValueError("trace: no window span")
    return min(s.start for s in w), max(s.end for s in w)

  def window_s(self) -> float:
    a, b = self.window()
    return (b - a) * 1e-9

  def _op_arrays(self):
    st = np.asarray([o.start for o in self.ops], np.int64)
    en = np.asarray([o.end for o in self.ops], np.int64)
    return st, en

  def busy_s(self) -> float:
    """Seconds of the window in which some operation ran on the device:
    the union of the operations' intervals, cut to the window."""
    a, b = self.window()
    st, en = self._op_arrays()
    return union_length(np.clip(st, a, b), np.clip(en, a, b)) * 1e-9

  def _named(self, name: str):
    ss = sorted((s for s in self.spans if s.name == name),
                key=lambda s: s.start)
    return (np.asarray([s.start for s in ss], np.int64),
            np.asarray([s.end for s in ss], np.int64))

  def _enclosing(self, name: str) -> np.ndarray:
    """(n_ops,) the start of the span `name` each op was launched in, or
    -1."""
    st, en = self._named(name)
    out = np.full(len(self.ops), -1, np.int64)
    t = self.launch_start
    i = np.searchsorted(st, t, side="right") - 1
    ok = (i >= 0) & (t >= 0)
    ok[ok] &= t[ok] <= en[i[ok]]
    out[ok] = st[i[ok]]
    return out

  def in_span(self, name: str) -> np.ndarray:
    """(n_ops,) bool: the op was launched inside a span `name`."""
    return self._enclosing(name) >= 0

  def device_s(self, name: str) -> float:
    """Device seconds of the operations launched inside spans `name`."""
    st, en = self._op_arrays()
    m = self.in_span(name)
    return float((en[m] - st[m]).sum()) * 1e-9

  def host_s(self, name: str) -> float:
    return sum(s.end - s.start for s in self.spans if s.name == name) * 1e-9

  def calls(self, name: str) -> int:
    return sum(1 for s in self.spans if s.name == name)

  # ------------------------------------------------------------------
  def innermost(self, span_names) -> List[str]:
    """Per op, the innermost of `span_names` it was launched in (the one
    that started last), or "other"."""
    best = np.full(len(self.ops), -1, np.int64)
    label = np.full(len(self.ops), "other", object)
    for name in span_names:
      starts = self._enclosing(name)
      newer = starts > best
      best[newer] = starts[newer]
      label[newer] = name
    return list(label)

  def breakdown(self, span_names, top: int = 10) -> dict:
    """The device operations that took most time, by innermost span and
    name, and the idle gaps summed by the innermost span the host had
    open on the window's thread when the device went idle."""
    st, en = self._op_arrays()
    labels = self.innermost(span_names)
    tot: Dict[str, float] = {}
    for lab, o, a, b in zip(labels, self.ops, st, en):
      key = f"{lab}:{o.name[:80]}"
      tot[key] = tot.get(key, 0.0) + (b - a) * 1e-9
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    gaps = np.asarray(idle_gaps(st, en, *self.window()), np.int64)
    main = [s for s in self.spans if s.name == WINDOW_SPAN][0].thread
    g_start = gaps[:, 0] if len(gaps) else np.zeros(0, np.int64)
    best = np.full(len(g_start), -1, np.int64)
    glab = np.full(len(g_start), "other", object)
    for name in span_names:
      ss = sorted((s for s in self.spans
                   if s.name == name and s.thread == main),
                  key=lambda s: s.start)
      if not ss:
        continue
      s0 = np.asarray([s.start for s in ss], np.int64)
      e0 = np.asarray([s.end for s in ss], np.int64)
      i = np.searchsorted(s0, g_start, side="right") - 1
      ok = i >= 0
      ok[ok] &= g_start[ok] < e0[i[ok]]
      newer = ok & (np.where(ok, s0[np.maximum(i, 0)], -1) > best)
      best[newer] = s0[i[newer]]
      glab[newer] = name
    idle: Dict[str, float] = {}
    for lab, (a, b) in zip(glab, gaps):
      idle[lab] = idle.get(lab, 0.0) + (b - a) * 1e-9
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}


def union_length(starts: np.ndarray, ends: np.ndarray) -> int:
  """Total length covered by the intervals [starts, ends)."""
  if len(starts) == 0:
    return 0
  order = np.argsort(starts, kind="stable")
  s, e = starts[order], ends[order]
  reach = np.maximum.accumulate(e)
  # a new block starts where an interval begins after all before it ended
  new = np.empty(len(s), bool)
  new[0] = True
  new[1:] = s[1:] > reach[:-1]
  block = np.cumsum(new) - 1
  b_start = s[new]
  b_end = np.zeros(block[-1] + 1, np.int64)
  np.maximum.at(b_end, block, e)
  return int(np.sum(np.maximum(b_end - b_start, 0)))


def idle_gaps(starts, ends, a: int, b: int) -> List[Tuple[int, int]]:
  """The gaps in [a, b) that no interval covers."""
  if len(starts) == 0:
    return [(a, b)]
  order = np.argsort(starts, kind="stable")
  s, e = np.clip(starts[order], a, b), np.clip(ends[order], a, b)
  gaps, t = [], a
  for x, y in zip(s, e):
    if x > t:
      gaps.append((t, int(x)))
    t = max(t, int(y))
  if t < b:
    gaps.append((t, b))
  return gaps


def idle_share(busy_s: float, window_s: float) -> Optional[float]:
  if window_s <= 0:
    return None
  return 100.0 * (1.0 - busy_s / window_s)
