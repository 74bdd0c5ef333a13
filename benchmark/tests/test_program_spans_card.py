"""On the card (marked `cuda`; it skips without one): the program's spans
against the benchmark's own, in each cell at its own size, over the two
epochs that `--trace 1` traces with the spans of harness/spans.py on:

  * every recorded `v4l.*` interval lies inside the profiler's range of the
    same name (the same clock);
  * the device seconds launched under `v4l.env.camera`, `v4l.window` and
    `v4l.layer.fwd` + `v4l.layer.bwd` are those under the harness's
    `camera`, `window` and `layer` + `layer_bwd`, within 1%, so a metric
    can move from the outside spans to the program's;
  * at least 90% of the device's idle seconds fall under a program span
    below `v4l.collect` / `v4l.update`, and under 10% are bare (no span,
    or `v4l.learner.minibatch` / `v4l.collector.step` with no child open).

Prints one JSON line a cell with the numbers (`-s` shows it):

  python -m pytest benchmark/tests/test_program_spans_card.py -m cuda -s
"""
import json

import pytest
import torch

CELLS = ("thin-goal.train", "mmdr-moving.train", "thin-goal.train-4096")
PAIRS = {"camera": (("v4l.env.camera",), ("camera",)),
         "window": (("v4l.window",), ("window",)),
         "layer": (("v4l.layer.fwd", "v4l.layer.bwd"),
                   ("layer", "layer_bwd"))}
LEARNER = ("gather", "vf_forward", "vf_backward", "vf_adam", "pf_forward",
           "pf_backward", "pf_adam", "metrics")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_spans_stand_in_for_the_harness_spans(card, name):
  from torch.profiler import ProfilerActivity, profile, record_function

  from harness import cell as cell_lib, check, run_cell, spans
  from harness.program_spans import NONE, ProgramSpans
  from harness.trace import WINDOW_SPAN, Trace
  from vision4leg_torch.utils import profiling
  cell = cell_lib.load(name)
  cell_lib.precision(cell.params)
  agent, _ = check.warm_start(cell, 2 ** 31 + 11, card)
  profiling.clear()
  with spans.installed(agent):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      with record_function(WINDOW_SPAN):
        for _ in range(run_cell.TRACED_EPOCHS):
          agent.train_epoch()
        torch.cuda.synchronize(card)
  events = prof.profiler.kineto_results.events()
  trace = Trace.from_kineto(events, spans.NAMES)
  ps = ProgramSpans.cut(profiling.recorded().spans, trace)

  ranges = {}
  for e in events:
    if e.name().startswith("v4l.") and str(e.device_type()).endswith("CPU"):
      ranges.setdefault(e.name(), []).append(
          (e.start_ns(), e.start_ns() + e.duration_ns()))
  offsets, outside = [], []
  for s in ps.spans:
    fits = [max(s.start_ns - a, b - s.end_ns)
            for a, b in ranges.get(s.name, ()) if a <= s.start_ns
            and s.end_ns <= b]
    if fits:
      offsets.append(min(fits))
    else:
      outside.append(s)
  device_s = {k: (sum(ps.device_s(n) for n in p),
                  sum(trace.device_s(n) for n in h))
              for k, (p, h) in PAIRS.items()}
  idle = ps.idle_by_span()
  total = sum(idle.values())
  above = sum(idle.get(k, 0.0) for k in (NONE, "v4l.epoch", "v4l.collect",
                                         "v4l.update"))
  bare = sum(idle.get(k, 0.0) for k in (NONE, "v4l.learner.minibatch",
                                        "v4l.collector.step"))
  n_mb = ps.count("v4l.learner.minibatch")
  resets = profiling.recorded().counts.get("v4l.collector.envs_reset", 0)
  n_reset = ps.count("v4l.collector.reset")
  print(json.dumps(dict(
      cell=name, spans=len(ps.spans), outside=len(outside), window_s=trace.window_s(),
      busy_s=trace.busy_s(), idle_s=total, idle_below=1 - above / total,
      idle_bare=bare / total, largest_offset_us=max(offsets) / 1e3,
      median_offset_us=sorted(offsets)[len(offsets) // 2] / 1e3,
      device_s=device_s, envs_reset=resets, resets=n_reset,
      reset_host_ms_per_env=(1e3 * ps.host_s("v4l.collector.reset") / resets
                             if resets else None),
      reset_launches=(ps.launches("v4l.collector.reset") / n_reset
                      if n_reset else None),
      idle_by_span={k: round(v, 4) for k, v in sorted(
          idle.items(), key=lambda kv: -kv[1])[:14]},
      minibatch_host_ms={p: 1e3 * ps.host_s(f"v4l.learner.{p}") / n_mb
                         for p in ("minibatch",) + LEARNER},
      minibatch_launches={p: ps.launches(f"v4l.learner.{p}") / n_mb
                          for p in ("minibatch",) + LEARNER})), flush=True)
  assert not outside, outside[:5]
  for k, (program, harness) in device_s.items():
    assert harness > 0 and abs(program - harness) <= 0.01 * harness, k
  assert above <= 0.10 * total
  assert bare < 0.10 * total
