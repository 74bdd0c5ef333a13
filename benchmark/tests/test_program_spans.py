"""The program's spans held against a device trace (harness/program_spans.py)
on a synthetic timeline, the readers where the program records no spans,
and the new metrics of a traced tiny CPU cell."""
import time

import numpy as np
import pytest
import torch

from harness import program_spans
from harness.program_spans import NONE, ProgramSpans
from harness.trace import WINDOW_SPAN, Interval, Trace
from vision4leg_torch.utils.profiling import Span

M, A = 1, 2          # the window's thread and autograd's

# (name, parent, start, end, thread), in ns
SPANS = [Span(*s) for s in [
    ("v4l.learner.vf_backward", "v4l.learner.minibatch", 150, 250, M),
    ("v4l.layer.bwd", None, 160, 200, A),
    ("v4l.learner.minibatch", "v4l.update", 100, 300, M),
    ("v4l.learner.minibatch", "v4l.update", 400, 600, M),
    ("v4l.update", "v4l.epoch", 20, 900, M),
    ("v4l.epoch", None, 10, 990, M),
    ("v4l.epoch", None, 2000, 2100, M),        # after the window: cut
]]
# (device start, device end, launch start): op 2 launched on autograd's
# thread inside the first minibatch; op 3 between the minibatches, running
# into the second; op 5's launch unmatched
OPS = [(120, 180, 110), (170, 260, 170), (320, 420, 310), (500, 550, 450),
       (560, 570, -1)]


def _trace(ops=OPS, names=None):
  names = names or [f"k{i}" for i in range(len(ops))]
  return Trace([Interval(WINDOW_SPAN, 0, 1000, 0)],
               [Interval(n, s, e) for n, (s, e, _) in zip(names, ops)],
               np.asarray([t for _, _, t in ops], np.int64))


def test_cut_to_the_window():
  ps = ProgramSpans.cut(SPANS, _trace())
  assert ps.count("v4l.epoch") == 1 and len(ps.spans) == 6
  assert ProgramSpans.cut(SPANS[-1:], _trace()) is None


def test_launches_by_launch_time_on_any_thread():
  ps = ProgramSpans.cut(SPANS, _trace())
  # ops 1, 2 (autograd's thread) and 4; not op 3 (launched between them)
  assert list(ps.launched_in("v4l.learner.minibatch")) == [
      True, True, False, True, False]
  assert ps.launches("v4l.learner.minibatch") == 3
  assert ps.device_s("v4l.learner.minibatch") == pytest.approx(200e-9)
  assert ps.launches("v4l.layer.bwd") == 1          # op 2, at 170
  assert ps.host_s("v4l.learner.minibatch") == pytest.approx(400e-9)


def test_busy_share_is_a_union_within_the_spans():
  ps = ProgramSpans.cut(SPANS, _trace())
  # ops 1 and 2 overlap: [120, 260] is 140 in the first minibatch, not
  # 150; in the second op 3's tail [400, 420], op 4, op 5: 80
  assert ps.busy_share("v4l.learner.minibatch") == pytest.approx(220 / 400)
  assert ps.busy_share("v4l.collector.step") is None


def test_idle_by_the_innermost_span_on_the_windows_thread():
  ps = ProgramSpans.cut(SPANS, _trace())
  idle = ps.idle_by_span()
  want = {NONE: 20, "v4l.epoch": 100, "v4l.update": 400,
          "v4l.learner.minibatch": 180, "v4l.learner.vf_backward": 0}
  assert idle == pytest.approx({k: v * 1e-9 for k, v in want.items()})
  # autograd's span opens no idle time of its own
  assert "v4l.layer.bwd" not in idle
  assert sum(idle.values()) == pytest.approx(
      1e-9 * (1000 - 140 - 100 - 50 - 10))
  assert ps.main_thread() == M


# a collection: two steps, the second with a partial reset
COLLECT = [Span(*s) for s in [
    ("v4l.collector.step", "v4l.collect", 110, 200, M),
    ("v4l.collector.step", "v4l.collect", 200, 400, M),
    ("v4l.collect", "v4l.epoch", 100, 500, M),
    ("v4l.epoch", None, 50, 600, M)]]
# a read (DtoH), a constant's copy (HtoD), a kernel, a copy on the device,
# a read in the reset, then one after the collection
COPY_OPS = [(120, 125, 115), (130, 132, 128), (140, 160, 135),
            (210, 215, 205), (300, 305, 290), (520, 530, 510)]
COPY_NAMES = ["Memcpy DtoH (Device -> Pageable)",
              "Memcpy HtoD (Pageable -> Device)", "k2",
              "Memcpy DtoD (Device -> Device)",
              "Memcpy DtoH (Device -> Pinned)",
              "Memcpy DtoH (Device -> Pageable)"]


def test_copies_between_host_and_device_launched_inside():
  ps = ProgramSpans.cut(COLLECT, _trace(COPY_OPS, COPY_NAMES))
  assert ps.copies("v4l.collect") == 3
  assert ps.copies("v4l.collector.step") == 3
  assert ps.copies("v4l.epoch") == 4
  # no device operation at all: the window is one gap
  ps = ProgramSpans.cut(COLLECT, _trace([]))
  assert ps.copies("v4l.collect") == 0
  assert sum(ps.idle_by_span().values()) == pytest.approx(1000e-9)


class _Ctx:
  def __init__(self, trace):
    self.trace = trace


@pytest.mark.parametrize("metric", ["update_launches", "update_busy",
                                    "step_launches", "collect_syncs",
                                    "reset_ms"])
def test_readers_without_program_spans(monkeypatch, metric):
  """No trace, or a program that records no spans: None, not an error."""
  import importlib

  from vision4leg_torch.utils import profiling
  read = importlib.import_module(f"metrics.{metric}").read
  assert read(_Ctx(None)) is None
  monkeypatch.delattr(profiling, "recorded")
  assert read(_Ctx(_trace())) is None


def test_readers_on_the_synthetic_timeline(monkeypatch):
  from metrics import collect_syncs, update_busy, update_launches
  from vision4leg_torch.utils import profiling
  monkeypatch.setattr(profiling, "recorded",
                      lambda: profiling.Recorded(SPANS, {}))
  ctx = _Ctx(_trace())
  assert update_launches.read(ctx) == pytest.approx(1.5)
  assert update_busy.read(ctx) == pytest.approx(55.0)
  assert collect_syncs.read(ctx) is None           # no collection traced
  monkeypatch.setattr(profiling, "recorded",
                      lambda: profiling.Recorded(COLLECT, {}))
  assert collect_syncs.read(_Ctx(_trace(COPY_OPS, COPY_NAMES))) == 1.5
  assert collect_syncs.read(_Ctx(_trace([]))) is None  # no device trace


def test_traced_tiny_cell_reads_the_program_spans(tiny):
  """On the CPU the program's spans are there but no device trace: the
  resets' host time reads; the launch counts, the busy share and the
  copies do not."""
  from harness import run_cell
  root, bench = tiny
  torch.set_num_threads(4)
  out = run_cell.run("mmdr-moving.tiny", 2 ** 31 + 5, 0.05, True, "cpu",
                     time.perf_counter(), bench, root, log=lambda s: None)
  got = out["metrics"]
  assert got["reset_ms"]["value"] >= 0.0
  assert got["reset_ms"]["unit"] == "ms"
  assert not {"update_launches", "update_busy", "step_launches",
              "collect_syncs"} & set(got)
  assert out["correct"]
