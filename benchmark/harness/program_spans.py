"""The program's own spans beside the device trace of the same profile.

`vision4leg_torch.utils.profiling` records each span of the program
(`v4l.*`: name, parent, start and end in ns, thread) while a torch profiler
records, stamped with time.time_ns() inside its record_function
range: on the clock of the trace's events.  So they are held against
`ctx.trace` as they are.  Cut to the traced window:
  * a device operation belongs to a program span when the host call that
    launched it started inside it, on any thread (as harness/trace.py
    attributes operations to the benchmark's own spans; a backward's
    kernels launch on autograd's thread while the main thread waits
    inside the learner's spans);
  * an idle gap of the device is put under the innermost program span
    open on the window's thread (the thread of `v4l.epoch`), split where
    that span changes.
A program that records no spans (one from before they existed) gives
None, and the readers then return None.  The spans are
`vision4leg_torch.utils.profiling.Span`s.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np

from harness.trace import Trace, idle_gaps

NONE = "(no span)"
# the device trace's names of the copies between host and device; each
# waits for the card, since the program makes none non_blocking
COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def of(ctx) -> Optional["ProgramSpans"]:
  """The program's spans of the traced window of `ctx`, or None."""
  if ctx.trace is None:
    return None
  from vision4leg_torch.utils import profiling
  recorded = getattr(profiling, "recorded", None)
  if recorded is None:
    return None
  return ProgramSpans.cut(recorded().spans, ctx.trace)


def _merged(starts: np.ndarray, ends: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
  """The disjoint blocks, in order, that the intervals cover."""
  if len(starts) == 0:
    return starts, ends
  order = np.argsort(starts, kind="stable")
  s, e = starts[order], ends[order]
  reach = np.maximum.accumulate(e)
  new = np.ones(len(s), bool)
  new[1:] = s[1:] > reach[:-1]
  last = np.r_[np.flatnonzero(new)[1:] - 1, len(s) - 1]
  return s[new], reach[last]


def _covered(bs: np.ndarray, be: np.ndarray, t: np.ndarray) -> np.ndarray:
  """Length of the disjoint sorted blocks [bs, be) that lies before each
  time in t."""
  t = np.asarray(t, np.int64)
  if len(bs) == 0:
    return np.zeros(len(t), np.int64)
  full = np.r_[0, np.cumsum(be - bs)]        # before block k, all of it
  k = np.searchsorted(bs, t, side="right")   # blocks that start by t
  j = np.maximum(k - 1, 0)
  part = np.clip(t - bs[j], 0, be[j] - bs[j])
  return np.where(k > 0, full[j] + part, 0)


@dataclasses.dataclass
class ProgramSpans:
  spans: list                 # of profiling.Span
  trace: Trace

  @classmethod
  def cut(cls, spans, trace: Trace) -> Optional["ProgramSpans"]:
    a, b = trace.window()
    inside = [s for s in spans if a <= s.start_ns and s.end_ns <= b]
    return cls(inside, trace) if inside else None

  # ------------------------------------------------------------------
  def named(self, name: str) -> list:
    return [s for s in self.spans if s.name == name]

  def count(self, name: str) -> int:
    return len(self.named(name))

  def host_s(self, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in self.named(name)) * 1e-9

  def _blocks(self, name: str):
    ss = self.named(name)
    return _merged(np.asarray([s.start_ns for s in ss], np.int64),
                   np.asarray([s.end_ns for s in ss], np.int64))

  def launched_in(self, name: str) -> np.ndarray:
    """(n_ops,) bool: the operation's launch started inside a span
    `name`, on any thread."""
    bs, be = self._blocks(name)
    t = self.trace.launch_start
    i = np.searchsorted(bs, t, side="right") - 1
    ok = (i >= 0) & (t >= 0)
    ok[ok] &= t[ok] <= be[i[ok]]
    return ok

  def launches(self, name: str) -> int:
    return int(self.launched_in(name).sum())

  def device_s(self, name: str) -> float:
    """Device seconds of the operations launched inside spans `name`."""
    m = self.launched_in(name)
    return sum(o.end - o.start for o, k in zip(self.trace.ops, m)
               if k) * 1e-9

  def busy_share(self, name: str) -> Optional[float]:
    """The union of the device's operations within the spans `name`,
    over those spans' length."""
    bs, be = self._blocks(name)
    total = int((be - bs).sum())
    if total <= 0:
      return None
    os_, oe = _merged(*self.trace._op_arrays())
    busy = _covered(os_, oe, be) - _covered(os_, oe, bs)
    return float(busy.sum()) / total

  def copies(self, name: str) -> int:
    """Copies between host and device launched inside spans `name`."""
    m = self.launched_in(name)
    return sum(1 for o, k in zip(self.trace.ops, m)
               if k and o.name.startswith(COPIES))

  # ------------------------------------------------------------------
  def main_thread(self) -> int:
    epochs = self.named("v4l.epoch")
    if epochs:
      return epochs[0].thread
    return Counter(s.thread for s in self.spans).most_common(1)[0][0]

  def idle_by_span(self) -> Dict[str, float]:
    """Seconds of the window in which the device ran nothing, by the
    innermost program span open on the window's thread (NONE where none
    was): each span's idle time less its children's."""
    a, b = self.trace.window()
    st, en = self.trace._op_arrays()
    gaps = np.asarray(idle_gaps(st, en, a, b), np.int64).reshape(-1, 2)
    gs, ge = gaps[:, 0], gaps[:, 1]
    thread = self.main_thread()
    main = [s for s in self.spans if s.thread == thread]
    t0 = np.asarray([s.start_ns for s in main], np.int64)
    t1 = np.asarray([s.end_ns for s in main], np.int64)
    idle = _covered(gs, ge, t1) - _covered(gs, ge, t0)
    out: Dict[str, float] = {NONE: float((ge - gs).sum())}
    for s, x in zip(main, idle):
      out[s.name] = out.get(s.name, 0.0) + float(x)
      parent = s.parent if s.parent is not None else NONE
      out[parent] = out.get(parent, 0.0) - float(x)
    return {k: v * 1e-9 for k, v in out.items()}
