"""Where the time of one thin-goal rollout of the torch port goes, on the card.

    python3 tools/profile_torch_rollout.py            # a rollout
    python3 tools/profile_torch_rollout.py --train    # a PPO update epoch
    python3 tools/profile_torch_rollout.py --mpc      # an MPC rollout
    python3 tools/profile_torch_rollout.py --eval     # a policy eval

Builds the main path as chip_smoke.py does (thin-goal JSON, 1024 envs,
LocoTransformer at full width, random weights from a seed), runs one
rollout to warm up, times two more without the profiler, then profiles
one with torch.profiler.  The spans are the program's own (`v4l.*`,
`vision4leg_torch.utils.profiling`), read with the benchmark's
`harness/program_spans.py`: a device operation belongs to the span whose
range its launch started in, on any thread.  Prints the card, the
steady-state rate, the device's busy share of the profiled region (the
union of its operations on the timeline), each span's calls, host ms,
launches and device ms, the program's counters (with the host ms of a
partial reset per env reset), the device's idle ms by the innermost span
open, and the top CUDA kernels, then one JSON line with the same numbers.

The tool reads the trace with the benchmark's `harness/program_spans.py`
and `harness/trace.py` (put on the path from `benchmark/`): a change
there that renames `ProgramSpans` or `Trace.from_kineto` has to keep
this tool running.

--train profiles the PPO update of one training epoch instead (a
PPOAgent as chip_smoke.py's training phase builds it: fused layer on in
collection and update, torch's default TF32 settings); --mpc the MPC
collection (chip_smoke.py's phase 9: config/mpc/locotransformer/
thin-goal.json, an 8-step rollout; its controller's spans are
`v4l.mpc.kkt` and `v4l.mpc.tick`); --eval the trainer's eval (the
config's eval envs, 32 steps).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmark")]


def profiled(fn):
  """(ProgramSpans, counters, wall seconds) of fn() run once under the
  profiler."""
  import torch
  from torch.profiler import ProfilerActivity, profile, record_function

  from harness.program_spans import ProgramSpans
  from harness.trace import WINDOW_SPAN, Trace
  from vision4leg_torch.utils import profiling
  profiling.clear()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    with record_function(WINDOW_SPAN):
      t = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      wall = time.perf_counter() - t
  trace = Trace.from_kineto(prof.profiler.kineto_results.events(), ())
  spans, counts = profiling.recorded()
  return ProgramSpans.cut(spans, trace), counts, wall


def report(ps, counts, wall, card, extra):
  """Print the spans and kernels of a profiled region and one JSON line."""
  trace = ps.trace
  busy = trace.busy_s() / trace.window_s()
  print(f"profiled region: wall {wall * 1e3:.2f} ms, device busy "
        f"{trace.busy_s() * 1e3:.2f} ms = {busy:.4f} of it (profiler on)",
        flush=True)
  spans = {}
  for name in sorted({s.name for s in ps.spans},
                     key=lambda n: -ps.host_s(n)):
    spans[name] = dict(calls=ps.count(name), host_ms=ps.host_s(name) * 1e3,
                       launches=ps.launches(name),
                       device_ms=ps.device_s(name) * 1e3)
    print(f"  span {name:26s} " + " ".join(
        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in spans[name].items()), flush=True)
  resets = counts.get("v4l.collector.envs_reset", 0)
  if resets:
    counts = dict(counts, reset_host_ms_per_env=ps.host_s(
        "v4l.collector.reset") * 1e3 / resets)
  print("  counters: " + ", ".join(f"{k} {v}" for k, v in counts.items()),
        flush=True)
  idle = {k: v * 1e3 for k, v in sorted(ps.idle_by_span().items(),
                                        key=lambda kv: -kv[1]) if v > 0}
  print("  device idle ms by innermost span: " + ", ".join(
      f"{k} {v:.2f}" for k, v in idle.items()), flush=True)
  kernels = {}
  for o in trace.ops:
    kernels[o.name] = kernels.get(o.name, 0.0) + (o.end - o.start) * 1e-6
  top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
  for name, ms in top:
    print(f"  kernel {ms:9.3f} ms {name[:90]}", flush=True)
  print(json.dumps(dict(
      card=card, **extra, profiled_wall_ms=wall * 1e3,
      device_busy_ms=trace.busy_s() * 1e3, device_busy_share=busy,
      spans=spans, counters=counts, idle_ms=idle,
      top_kernels=[dict(name=k, device_ms=v) for k, v in top])), flush=True)


def timed(fn, n=2):
  import torch
  walls = []
  for _ in range(n):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
  return walls


def make_agent(env, meta, params, tmp):
  """A PPOAgent of the thin-goal config as chip_smoke.py's training phase
  builds it (1024 envs, full width, fused layer on, eval of 32 steps)."""
  import chip_smoke
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter.ppo_locotransformer import build_module
  from vision4leg_torch.utils.logger import Logger
  logger = Logger("profile", params["env_name"], 0, params, tmp)
  return PPOAgent(
      env=env, ac_module=build_module(env, params),
      cfg=common.ppo_config(params), num_envs=chip_smoke.NUM_ENVS, seed=0,
      logger=logger, save_dir=os.path.join(tmp, "model"),
      obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"], fused_attention=True,
      fused_update=True, num_eval_envs=common.num_eval_envs(params),
      eval_horizon=chip_smoke.EVAL_HORIZON, device=env.device)


def agent_mode(card, mode) -> int:
  """--train: the PPO update of one epoch; --eval: the trainer's eval."""
  import tempfile

  import torch

  import chip_smoke
  from vision4leg_torch.starter import common
  env, meta, _, params = chip_smoke.build_main_path(torch.device("cuda"))
  with tempfile.TemporaryDirectory(prefix="profile_") as tmp:
    agent = make_agent(env, meta, params, tmp)
    if mode == "--eval":
      agent.evaluate()                          # warm-up
      walls = timed(agent.evaluate)
      print(f"steady evals ({agent.num_eval_envs} envs x "
            f"{agent.eval_horizon} steps) on {card}: {walls}", flush=True)
      ps, counts, wall = profiled(agent.evaluate)
      extra = dict(envs=agent.num_eval_envs, steps=agent.eval_horizon,
                   steady_wall_s=walls)
    else:
      epochs = []
      for _ in range(2):
        epochs.append(dict(wall_s=timed(agent.train_epoch, 1)[0],
                           **agent.phase_seconds))
      print(f"epochs on {card} (TF32: matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
            f"{torch.backends.cudnn.allow_tf32}): {epochs}", flush=True)
      _, traj, last_value = agent.rollout(agent.collector_state)
      ps, counts, wall = profiled(lambda: agent.learner.update_per_epoch(
          agent.train_state, traj, last_value, gen=agent.update_gen))
      cfg = common.ppo_config(params)
      extra = dict(envs=chip_smoke.NUM_ENVS, minibatches=cfg.opt_epochs * (
          cfg.epoch_frames // cfg.batch_size), epochs=epochs)
  report(ps, counts, wall, card, extra)
  return 0


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("profile_torch_rollout: no CUDA device", file=sys.stderr)
    return 2
  import chip_smoke
  from vision4leg_torch.collector import rollout as rollout_lib

  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  print(card, flush=True)
  for mode in ("--train", "--eval"):
    if mode in sys.argv[1:]:
      return agent_mode(card, mode)
  dev = torch.device("cuda")
  mpc = "--mpc" in sys.argv[1:]
  build = chip_smoke.build_mpc_path if mpc else chip_smoke.build_main_path
  env, meta, net, params = build(dev)
  rollout = chip_smoke.make_rollout(env, meta, net, params)
  n = chip_smoke.NUM_ENVS
  horizon = params["collector"]["epoch_frames"] // n
  state = [rollout_lib.init_collector(
      env, n, torch.Generator(device=dev).manual_seed(0))]

  def step():
    state[0] = rollout(state[0])[0]
  step()                                       # warm-up
  walls = timed(step)
  rate = [horizon * n / w for w in walls]
  print(f"steady rollouts: {horizon} steps x {n} envs in {walls} s = "
        f"{rate} env-steps/s on {card}", flush=True)
  ps, counts, wall = profiled(step)
  report(ps, counts, wall, card, dict(
      config=chip_smoke.MPC_CONFIG if mpc else chip_smoke.CONFIG, envs=n,
      steps=horizon, steady_wall_s=walls, steady_env_steps_per_s=rate))
  return 0


if __name__ == "__main__":
  sys.exit(main())
