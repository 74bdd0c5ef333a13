"""`metrics/update_replayed.py` on the synthetic timeline of
test_program_spans.py, on a program that records no spans, and on a
traced tiny CPU cell (no graph on the CPU)."""
import time

import pytest
import torch

from test_program_spans import COLLECT, M, SPANS, _Ctx, _trace
from vision4leg_torch.utils.profiling import Span

REPLAY = Span("v4l.learner.replay", "v4l.learner.minibatch", 420, 580, M)


@pytest.mark.parametrize("spans,want", [(SPANS + [REPLAY], 50.0),
                                        (SPANS, 0.0), (COLLECT, None)])
def test_replays_over_minibatches(monkeypatch, spans, want):
  """One of the two traced minibatches replayed: 50%; none: 0.0; no
  minibatch spans: None."""
  from metrics import update_replayed
  from vision4leg_torch.utils import profiling
  monkeypatch.setattr(profiling, "recorded",
                      lambda: profiling.Recorded(spans, {}))
  assert update_replayed.read(_Ctx(_trace())) == want


def test_none_without_spans(monkeypatch):
  """No trace, or a program that records no spans: None, not an error."""
  from metrics import update_replayed
  from vision4leg_torch.utils import profiling
  assert update_replayed.read(_Ctx(None)) is None
  monkeypatch.delattr(profiling, "recorded")
  assert update_replayed.read(_Ctx(_trace())) is None


def test_tiny_cpu_cell_replays_nothing(tiny):
  from harness import run_cell
  root, bench = tiny
  torch.set_num_threads(4)
  out = run_cell.run("thin-goal.tiny", 2 ** 31 + 7, 0.05, True, "cpu",
                     time.perf_counter(), bench, root, log=lambda s: None)
  assert out["metrics"]["update_replayed"] == {"value": 0.0, "unit": "%"}
  assert out["correct"]
