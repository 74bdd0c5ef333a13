"""One run of one cell: set-up, the timed window, the traced epochs, the
check, and the result's line.

Set-up is everything from the process's start to the first timed epoch:
the kernels (built by nvcc into the program's own cache in the checkout,
`vision4leg_torch/_build/`), the env and its reset, the weights from the
seed, and one warm epoch of the cell's own shapes, whose outputs the
check keeps.  The window calls `PPOAgent.train_epoch` back to back until
`seconds` have passed, and ends on the last epoch that finished, after a
synchronize.  With `trace`, a run then traces TRACED_EPOCHS more epochs
with the spans of harness/spans.py on and reads the per-layer metrics
from them (`metrics/<name>.py`).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from harness import cell as cell_lib
from harness import check, spans
from harness.trace import WINDOW_SPAN, Trace

TRACED_EPOCHS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "vision4leg_tpu", "bench", "chip_smoke")


def forbidden_modules() -> List[str]:
  """Loaded modules whose top-level name is one the run may not load."""
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
  """What a per-layer metric's reader may read."""
  cell: cell_lib.Cell
  epochs: List[Dict[str, float]]     # phase seconds of the window's epochs
  window_s: float                    # the untraced window
  trace: Optional[Trace] = None
  calls: Optional[dict] = None       # recorded inputs of the traced calls
  traced_epochs: int = 0
  dt: float = 0.0


def timed_window(agent, seconds: float):
  """(epochs, seconds, phase seconds per epoch, the main thread's CPU
  seconds) of train_epoch called back to back until `seconds` have
  passed."""
  sync = _sync(agent.device)
  sync()
  t0, c0 = time.perf_counter(), time.thread_time()
  phases = []
  while True:
    agent.train_epoch()        # synchronizes at its end
    phases.append(dict(agent.phase_seconds))
    elapsed = time.perf_counter() - t0
    if elapsed >= seconds:
      return len(phases), elapsed, phases, time.thread_time() - c0


def host_probe_ms(n: int = 2_000_000) -> float:
  """Milliseconds of a fixed pure-Python loop: the host's single-thread
  pace at the moment (the sandbox reports no load or steal time)."""
  t0 = time.perf_counter()
  acc = 0
  for i in range(n):
    acc += i & 7
  return 1e3 * (time.perf_counter() - t0)


def _sync(device) -> Callable[[], None]:
  if torch.device(device).type == "cuda":
    return lambda: torch.cuda.synchronize(device)
  return lambda: None


def traced(agent, n_epochs: int):
  """Trace n_epochs more epochs with the spans on: (Trace, calls)."""
  from torch.profiler import ProfilerActivity, profile, record_function
  acts = [ProfilerActivity.CPU]
  if agent.device.type == "cuda":
    acts.append(ProfilerActivity.CUDA)
  sync = _sync(agent.device)
  with spans.installed(agent) as calls:
    with profile(activities=acts) as prof:
      with record_function(WINDOW_SPAN):
        for _ in range(n_epochs):
          agent.train_epoch()
        sync()
  return Trace.from_kineto(prof.profiler.kineto_results.events(),
                           spans.NAMES), calls


def read_metric(name: str, ctx: Context):
  mod = importlib.import_module(f"metrics.{name}")
  return mod.read(ctx)


def device_info(device, count: int) -> dict:
  dev = torch.device(device)
  if dev.type != "cuda":
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}
  return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
          "count": count,
          "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> Optional[str]:
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20)
  except (OSError, subprocess.SubprocessError):
    return None
  return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench: dict, root: str = cell_lib.REPO,
        log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
  """The result of one run (the line run.py prints)."""
  cell = cell_lib.load(name, root)
  spec = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
  cell_lib.precision(cell.params)
  dev = torch.device(device)
  if dev.type == "cuda":
    torch.cuda.reset_peak_memory_stats(dev)
  log(f"set-up: imports and CUDA {time.perf_counter() - t_start:.3f} s")
  agent, cap = check.warm_start(cell, seed, dev, log)
  _sync(dev)()
  setup_s = time.perf_counter() - t_start
  log(f"set-up {setup_s:.3f} s")

  n, window_s, phases, cpu_s = timed_window(agent, seconds)
  steps = n * cell.num_envs * cell.horizon
  log(f"window: {n} epochs, {window_s:.3f} s, {steps / window_s:.1f} "
      f"env-steps/s; collect / update s: " + ", ".join(
          f"{p['Explore_Time']:.3f}/{p['Update_Time']:.3f}" for p in phases))
  log(f"host: main thread CPU {cpu_s:.3f} s of the window's "
      f"{window_s:.3f} s; probe {host_probe_ms():.1f} ms")
  ctx = Context(cell, phases, window_s,
                dt=cell.params["env"]["env_build"]["time_step_s"])
  out: dict = {}
  if trace:
    t0 = time.perf_counter()
    ctx.trace, ctx.calls = traced(agent, TRACED_EPOCHS)
    ctx.traced_epochs = TRACED_EPOCHS
    log(f"traced {TRACED_EPOCHS} epochs, read in "
        f"{time.perf_counter() - t0:.1f} s")
  info = device_info(dev, cell.chips)
  leftover = forbidden_modules()
  if leftover:
    raise SystemExit(f"forbidden modules loaded: {leftover}")

  metrics = {}
  if not trace:
    metrics["train_steps_per_s"] = steps / window_s
    metrics["peak_mem_gib"] = info["memory_peak_bytes"] / 2 ** 30
    metrics["setup_s"] = setup_s
  else:
    for m in bench["per_layer"]:
      if name in m.get("workloads", [name]):
        v = read_metric(m["name"], ctx)
        if v is not None:
          metrics[m["name"]] = v
    info["busy_s"] = ctx.trace.busy_s()
    info["window_s"] = ctx.trace.window_s()
    out["breakdown"] = ctx.trace.breakdown(spans.NAMES)

  # the check, once the window has closed and the program's state is gone
  ctx.trace = ctx.calls = None
  del agent
  gc.collect()
  if dev.type == "cuda":
    torch.cuda.empty_cache()
  t0 = time.perf_counter()
  got = check.numbers(cap.program_side(),
                      cap.reference_side(cell.params, tf32=False), cap.w0)
  got.update(cap.env_numbers(cell.params))
  limits = cell_lib.limits(name, root)
  checks = {k: {"value": got[k], "limit": limits[k]} for k in sorted(got)}
  correct = all(c["value"] <= c["limit"] for c in checks.values())
  log(f"check {time.perf_counter() - t0:.1f} s")
  pl = power_limit()
  if pl:
    log(f"card: {pl}")
  for k, c in checks.items():
    log(f"{k} {c['value']!r} limit {c['limit']!r}")
  return {"correct": correct, "attempted": n, "failed": 0,
          "metrics": {k: {"value": v, "unit": spec[k]["unit"]}
                      for k, v in metrics.items()},
          "device": info, **out, "checks": checks}
