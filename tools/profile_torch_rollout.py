"""Where the time of one thin-goal rollout of the torch port goes, on the card.

    python3 tools/profile_torch_rollout.py            # a rollout
    python3 tools/profile_torch_rollout.py --train    # a PPO update epoch
    python3 tools/profile_torch_rollout.py --mpc      # an MPC rollout
    python3 tools/profile_torch_rollout.py --eval     # a policy eval

Builds the main path as chip_smoke.py does (thin-goal JSON, 1024 envs,
LocoTransformer at full width, random weights from a seed), runs one
rollout to warm up, times two more without the profiler, then profiles
one with torch.profiler.  Spans named here wrap the layers' entry points
(the env's reset and step as the collector calls them, `reset_from` and
`step_from`; the eval's `step_batch`; the physics window's CUDA launch,
the camera, the policy); the program itself carries no spans.  Prints the card, the
steady-state env-steps/s, the share of the profiled rollout's wall time
that kernels ran on the card, each span's host milliseconds and its range
on the device timeline, and the top CUDA kernels, then one JSON line with
the same numbers.

With --train it profiles the PPO update of one training epoch instead:
a PPOAgent built as chip_smoke.py's training phase builds it (1024 envs,
full width, fused layer on in collection and update, torch's default
TF32 settings: matmul off, cuDNN convolutions on) trains one epoch to
warm up, then one more with the update under the profiler, with spans
on the value and policy forwards, the fused layer's launch (its
residual-saving forward), its backward (the backward kernel, the weight
products and sums) and the backward kernel's launch within it, and the
two Adam steps.

With --mpc it profiles the MPC collection path instead (chip_smoke.py's
phase 9: config/mpc/locotransformer/thin-goal.json, 1024 envs, an 8-step
rollout), with spans on the env step, the per-step KKT inverse, the
controller tick (gait, estimator, swing, warm-QP stance), the hybrid
window's launch, the camera and the policy.

With --eval it profiles the trainer's eval instead: a PPOAgent built as
for --train runs `evaluate` (chip_smoke.py's eval: the config's eval envs,
32 steps) once to warm up, twice timed, then once under the profiler,
with spans on the env step, the physics window's launch, the camera and
the policy.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _device_us(evt) -> float:
  for name in ("self_device_time_total", "self_cuda_time_total"):
    if hasattr(evt, name):
      return float(getattr(evt, name))
  return 0.0


def _is_kernel(evt) -> bool:
  """Events that ran on the card (kernels, copies), not host ops whose
  device time is also summed from their kernels."""
  return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _device_total_us(evt) -> float:
  for name in ("device_time_total", "cuda_time_total"):
    if hasattr(evt, name):
      return float(getattr(evt, name))
  return 0.0


def _report(prof, wall, spans, card, extra):
  """Print span and kernel times of a profiled region and one JSON line."""
  avgs = prof.key_averages()
  # each span appears twice: its host range and its range on the device
  # timeline (first to last kernel inside it, gaps included)
  span_ms = {name: dict(calls=0, host_ms=0.0, device_range_ms=0.0)
             for name in spans}
  for e in avgs:
    if e.key in span_ms:
      d = span_ms[e.key]
      if _is_kernel(e):
        d["device_range_ms"] = _device_us(e) / 1e3
      else:
        d["calls"] = e.count
        d["host_ms"] = e.cpu_time_total / 1e3
  kernels = [e for e in avgs if _is_kernel(e) and e.key not in span_ms]
  device_us = sum(_device_us(e) for e in kernels)
  busy = device_us / (wall * 1e6)
  print(f"profiled region: wall {wall * 1e3:.2f} ms, device kernels "
        f"{device_us / 1e3:.2f} ms = {busy:.4f} of wall (profiler on)",
        flush=True)
  for name, d in span_ms.items():
    print(f"  span {name:20s} calls {d['calls']:4d} host "
          f"{d['host_ms']:9.2f} ms, on the device timeline "
          f"{d['device_range_ms']:9.2f} ms", flush=True)
  kernels = sorted(kernels, key=_device_us, reverse=True)[:15]
  for e in kernels:
    print(f"  kernel {_device_us(e) / 1e3:9.3f} ms x{e.count:5d} "
          f"{e.key[:90]}", flush=True)
  print(json.dumps(dict(
      card=card, **extra, profiled_wall_ms=wall * 1e3,
      device_kernel_ms=device_us / 1e3, device_busy_share=busy,
      spans=span_ms,
      top_kernels=[dict(name=e.key, device_ms=_device_us(e) / 1e3,
                        calls=e.count) for e in kernels])), flush=True)


def span(name, fn):
  """fn inside a profiler range named `name`."""
  from torch.profiler import record_function

  def wrapped(*args, **kwargs):
    with record_function(name):
      return fn(*args, **kwargs)
  return wrapped


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


def evaluate(card) -> int:
  """Profile the trainer's eval (the window at eval's batch)."""
  import tempfile

  import torch
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke
  from vision4leg_torch.ops import physics_kernel as pk

  env, meta, _, params = chip_smoke.build_main_path(torch.device("cuda"))
  with tempfile.TemporaryDirectory(prefix="profile_eval_") as tmp:
    agent = make_agent(env, meta, params, tmp)
    spans = ("env.step_batch", "physics_window", "camera", "policy.pi")
    env.step_batch = span("env.step_batch", env.step_batch)
    env._render = span("camera", env._render)
    pk._launch = span("physics_window", pk._launch)
    agent.apply_pi = span("policy.pi", agent.apply_pi)
    agent.evaluate()                            # warm-up
    walls = []
    for _ in range(2):
      torch.cuda.synchronize()
      t = time.perf_counter()
      agent.evaluate()
      torch.cuda.synchronize()
      walls.append(time.perf_counter() - t)
    print(f"steady evals ({agent.num_eval_envs} envs x "
          f"{agent.eval_horizon} steps) on {card}: "
          + ", ".join(f"{w:.4f}s" for w in walls), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      torch.cuda.synchronize()
      t = time.perf_counter()
      agent.evaluate()
      torch.cuda.synchronize()
      wall = time.perf_counter() - t
  _report(prof, wall, spans, card, dict(
      envs=agent.num_eval_envs, steps=agent.eval_horizon,
      steady_wall_s=walls))
  return 0


def train(card) -> int:
  """Profile the PPO update of one thin-goal training epoch."""
  import tempfile

  import torch
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.starter import common

  dev = torch.device("cuda")
  env, meta, _, params = chip_smoke.build_main_path(dev)
  cfg = common.ppo_config(params)

  with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
    agent = make_agent(env, meta, params, tmp)
    walls = []
    for _ in range(2):
      torch.cuda.synchronize()
      t = time.perf_counter()
      agent.train_epoch()
      torch.cuda.synchronize()
      walls.append(dict(wall_s=time.perf_counter() - t,
                        **agent.phase_seconds))
    print(f"epochs on {card} (TF32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}): {walls}", flush=True)

    learner = agent.learner
    spans = ("value forward", "policy forward", "layer kernel",
             "layer backward", "layer backward kernel", "vf adam",
             "pf adam")
    learner.apply_v = span("value forward", learner.apply_v)
    learner.apply_pi = span("policy forward", learner.apply_pi)
    att._launch = span("layer kernel", att._launch)
    att._FusedLayerAD.backward = staticmethod(
        span("layer backward", att._FusedLayerAD.backward))
    att._launch_bwd = span("layer backward kernel", att._launch_bwd)
    learner.vf_tx.update = span("vf adam", learner.vf_tx.update)
    learner.pf_tx.update = span("pf adam", learner.pf_tx.update)
    cs, traj, last_value = agent.rollout(agent.collector_state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t = time.perf_counter()
      learner.update_per_epoch(agent.train_state, traj, last_value,
                               gen=agent.update_gen)
      torch.cuda.synchronize()
      wall = time.perf_counter() - t
  _report(prof, wall, spans, card, dict(
      envs=chip_smoke.NUM_ENVS, minibatches=cfg.opt_epochs * (
          cfg.epoch_frames // cfg.batch_size), epochs=walls))
  return 0


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("profile_torch_rollout: no CUDA device", file=sys.stderr)
    return 2
  from torch.profiler import ProfilerActivity, profile

  import chip_smoke
  from vision4leg_torch.collector import rollout as rollout_lib
  from vision4leg_torch.ops import physics_kernel as pk

  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  print(card, flush=True)
  if "--train" in sys.argv[1:]:
    return train(card)
  if "--eval" in sys.argv[1:]:
    return evaluate(card)
  dev = torch.device("cuda")
  mpc = "--mpc" in sys.argv[1:]
  build = chip_smoke.build_mpc_path if mpc else chip_smoke.build_main_path
  env, meta, net, params = build(dev)

  spans = ("env.reset_from", "env.step_from", "physics_window", "camera",
           "policy.pi_v")
  if mpc:
    from vision4leg_torch.mpc import convex_mpc
    spans += ("kkt_inverse", "controller_tick")
    convex_mpc.kkt_inverse = span("kkt_inverse", convex_mpc.kkt_inverse)
    env.controller_tick = span("controller_tick", env.controller_tick)
  env.reset_from = span("env.reset_from", env.reset_from)
  env.step_from = span("env.step_from", env.step_from)
  env._render = span("camera", env._render)
  # robot_window keeps its launch count on itself: wrap the launch inside
  pk._launch = span("physics_window", pk._launch)
  net.pi_v = span("policy.pi_v", net.pi_v)
  rollout = chip_smoke.make_rollout(env, meta, net, params)
  n = chip_smoke.NUM_ENVS
  horizon = params["collector"]["epoch_frames"] // n

  gen = torch.Generator(device=dev).manual_seed(0)
  cs = rollout_lib.init_collector(env, n, gen)
  cs, _, _ = rollout(cs)                       # warm-up
  walls = []
  for _ in range(2):
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs, _, _ = rollout(cs)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
  rate = [horizon * n / w for w in walls]
  print(f"steady rollouts: {horizon} steps x {n} envs in "
        + ", ".join(f"{w:.4f}s" for w in walls) + " = "
        + ", ".join(f"{r:.1f}" for r in rate) + f" env-steps/s on {card}",
        flush=True)

  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
      as prof:
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs, _, _ = rollout(cs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
  _report(prof, wall, spans, card, dict(
      config=chip_smoke.MPC_CONFIG if mpc else chip_smoke.CONFIG, envs=n,
      steps=horizon, steady_wall_s=walls, steady_env_steps_per_s=rate))
  return 0


if __name__ == "__main__":
  sys.exit(main())
