"""On the card (marked `cuda`; it skips without one): the host syncs of one
training epoch at 64 envs against what torch reports as synchronizing
(`torch.cuda.set_sync_debug_mode("warn")`).  Inside the collection every
reported sync is one copy between host and device in the device trace, and
the copies there are as many as the reports, so `collect_syncs`, which
counts those copies, misses none; each of the reads that carries a
`v4l.sync.*` span is one of them.  Outside the collection no reported sync
falls outside a `v4l.sync.*` span.  Episodes are capped at 8 steps, so
every env resets twice and the partial resets' sites run too."""
import collections
import threading
import time
import traceback
import warnings

import pytest
import torch

from conftest import tiny_root

CARD = {"num_envs": 64, "epoch_frames": 1024, "batch_size": 64}
READS = ("v4l.sync.cap", "v4l.sync.reset_counts", "v4l.sync.reset_rows")


@pytest.mark.cuda
@pytest.mark.parametrize("config,limits_of", [
    ("thin-goal", "thin-goal.train"), ("mmdr-moving", "mmdr-moving.train")])
def test_every_sync_of_the_collection_is_a_counted_copy(card, tmp_path,
                                                         config, limits_of):
  from torch.profiler import ProfilerActivity, profile, record_function

  from harness import cell as cell_lib, check
  from harness.program_spans import ProgramSpans
  from harness.trace import WINDOW_SPAN, Trace
  from vision4leg_torch.utils import profiling
  root = str(tmp_path)
  tiny_root(root, limits_of, CARD)
  cell = cell_lib.load(f"{config}.tiny", root)
  cell_lib.precision(cell.params)
  agent, _ = check.warm_start(cell, 2 ** 31 + 3, card)
  seen = []

  def hook(message, category, *a, **kw):
    if "called a synchronizing CUDA operation" in str(message):
      where = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}"
               for f in traceback.extract_stack()[:-1]
               if "vision4leg_torch" in f.filename][-3:]
      seen.append((time.time_ns(), threading.get_ident(), tuple(where)))

  profiling.clear()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with record_function(WINDOW_SPAN):
      with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
          agent.train_epoch(max_ep=8)
        finally:
          torch.cuda.set_sync_debug_mode(0)
  spans, counts = profiling.recorded()
  ps = ProgramSpans.cut(
      spans, Trace.from_kineto(prof.profiler.kineto_results.events(), ()))

  def within(w, s):
    return s.thread == w[1] and s.start_ns <= w[0] <= s.end_ns

  collect = ps.named("v4l.collect")
  inside = [w for w in seen if any(within(w, s) for s in collect)]
  assert inside and len(inside) == ps.copies("v4l.collect"), (
      len(inside), ps.copies("v4l.collect"),
      collections.Counter(w[2] for w in inside))
  named = [s for s in ps.spans if s.name.startswith("v4l.sync.")]
  unnamed = [w for w in seen if w not in inside
             and not any(within(w, s) for s in named)]
  assert not unnamed, collections.Counter(w[2] for w in unnamed)
  # each read is one reported sync
  reads = [s for s in ps.spans if s.name in READS]
  assert [sum(within(w, s) for w in seen) for s in reads] == [1] * len(reads)
  steps = ps.count("v4l.collector.step")
  assert steps == CARD["epoch_frames"] // CARD["num_envs"]
  assert ps.count("v4l.sync.cap") == ps.count("v4l.sync.reset_counts") \
      == steps
  assert ps.count("v4l.sync.reset_rows") >= 2
  assert counts["v4l.collector.envs_reset"] >= 2 * CARD["num_envs"]
