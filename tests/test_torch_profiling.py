"""The port's profiling and tensorboard utilities
(vision4leg_torch.utils.profiling, tensorboard_starter) on the CPU,
against the JAX package's: the same phase keys, a trace written into its
directory, the memory summary without a card, and the same tensorboard
command line."""
import dataclasses
import os
import subprocess
import time

import torch

from vision4leg_tpu.utils import profiling as jprofiling
from vision4leg_tpu.utils import tensorboard_starter as jtb
from vision4leg_torch.utils import profiling, tensorboard_starter


@dataclasses.dataclass
class _Tree:
  a: torch.Tensor
  b: list


def test_phase_timer_keys_and_totals():
  ours, ref = profiling.PhaseTimer(), jprofiling.PhaseTimer()
  tree = _Tree(torch.ones(3), [torch.zeros(2), {"c": torch.ones(1)}])
  for timer in (ours, ref):
    for name in ("Explore", "Train__", "Explore"):
      with timer.phase(name, block_on=tree if timer is ours else None):
        time.sleep(0.01)
  assert set(ours.summary()) == set(ref.summary()) == {"Explore_Time",
                                                       "Train___Time"}
  assert ours.counts == ref.counts == {"Explore": 2, "Train__": 1}
  assert ours.summary()["Explore_Time"] >= 0.02
  assert profiling.block_until_ready(tree) is tree
  ours.reset()
  assert ours.summary() == {} and not ours.counts


def test_trace_writes_a_trace_file(tmp_path):
  logdir = str(tmp_path / "trace")
  with profiling.trace(logdir):
    torch.randn(64, 64) @ torch.randn(64, 64)
  files = [f for f in os.listdir(logdir) if f.endswith(".json")]
  assert files
  assert os.path.getsize(os.path.join(logdir, files[0])) > 0


def test_device_memory_summary_without_a_card(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  assert profiling.device_memory_summary() == {}


def test_tensorboard_logdir_spec_matches_jax(monkeypatch):
  calls = []
  monkeypatch.setattr(subprocess, "run", lambda cmd, *a, **k: calls.append(
      cmd))
  argv = ["--dirs", "log/exp1/", "/abs/exp2", "--port", "6123"]
  tensorboard_starter.main(argv)
  monkeypatch.setattr("sys.argv", ["tb"] + argv)
  jtb.main()
  assert calls[0] == calls[1] == [
      "tensorboard", "--logdir_spec", "exp1:log/exp1/,exp2:/abs/exp2",
      "--port", "6123"]


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

def _cpu_profile():
  from torch.profiler import ProfilerActivity, profile
  return profile(activities=[ProfilerActivity.CPU])


def test_span_without_a_profiler_records_nothing(monkeypatch):
  calls = []
  real = torch.profiler.record_function
  monkeypatch.setattr(torch.profiler, "record_function",
                      lambda *a, **k: calls.append(a) or real(*a, **k))
  profiling.clear()
  assert not torch.autograd._profiler_enabled()
  assert profiling.span("v4l.a") is profiling.span("v4l.b")
  with profiling.span("v4l.a"):
    with profiling.span("v4l.b"):
      profiling.count("v4l.n", 3)
  assert calls == []
  assert profiling.recorded() == ([], {})


def test_spans_nest_on_the_profilers_clock(monkeypatch):
  import threading
  profiling.clear()
  with _cpu_profile() as prof:
    with profiling.span("v4l.outer"):
      with profiling.span("v4l.inner"):
        torch.ones(8) + 1
        profiling.count("v4l.n")
      with profiling.span("v4l.inner"):
        profiling.count("v4l.n", 4)
  # a thread keeps its own stack: patched on, since a new thread does not
  # inherit the profiler's thread-local state
  monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
  with profiling.span("v4l.outer"):
    t = threading.Thread(target=lambda: profiling.span("v4l.worker")
                         .__enter__().__exit__(None, None, None))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
  spans, counts = profiling.recorded()
  me = threading.get_ident()
  got = [(s.name, s.parent, s.thread == me) for s in spans]
  assert got == [("v4l.inner", "v4l.outer", True),
                 ("v4l.inner", "v4l.outer", True),
                 ("v4l.outer", None, True),
                 ("v4l.worker", None, False),
                 ("v4l.outer", None, True)]
  assert counts == {"v4l.n": 5}
  ranges = {}
  for e in prof.profiler.kineto_results.events():
    if e.name().startswith("v4l."):
      ranges.setdefault(e.name(), []).append(
          (e.start_ns(), e.start_ns() + e.duration_ns()))
  assert sorted(ranges) == ["v4l.inner", "v4l.outer"]
  for s in spans[:3]:
    assert s.start_ns <= s.end_ns
    assert any(a <= s.start_ns and s.end_ns <= b for a, b in ranges[s.name])
  profiling.clear()
  assert profiling.recorded() == ([], {})


def test_a_tiny_epoch_records_its_spans(tmp_path):
  import json
  import warnings

  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.algo.on_policy_base import minibatches
  from vision4leg_torch.algo.ppo import PPOConfig
  from vision4leg_torch.envs.env import A1GymEnv
  from vision4leg_torch.envs.get_env import env_config_from_build_params
  from vision4leg_torch.models.actor_critic import \
      LocoTransformerActorCritic
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  with open(os.path.join(
      root, "config/rl/static/locotransformer/thin-goal.json")) as f:
    params = json.load(f)
  env = A1GymEnv(dataclasses.replace(
      env_config_from_build_params(params["env"]["env_build"]),
      settle_steps=20), device="cpu")
  n_envs, horizon = 4, 4
  cfg = PPOConfig(plr=1e-3, vlr=1e-3, opt_epochs=2, batch_size=8,
                  epoch_frames=n_envs * horizon, num_epochs=2)
  module = LocoTransformerActorCritic(
      action_dim=env.cfg.action_dim, state_input_shape=env.cfg.proprio_dim,
      encoder_hidden_shapes=(16,), transformer_params=((1, 32), (1, 32)),
      append_hidden_shapes=(16,), token_dim=16)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    agent = PPOAgent(env=env, ac_module=module, cfg=cfg, num_envs=n_envs,
                     seed=0, logger=None, save_dir=str(tmp_path),
                     device="cpu")
  profiling.clear()
  with _cpu_profile():
    # episodes capped at 2 steps: every env resets at steps 2 and 4
    agent.train_epoch(max_ep=2)
  spans, counts = profiling.recorded()
  names = [s.name for s in spans]
  n_of = names.count
  # the program's names: none a benchmark span's, none read as a CUDA call
  assert all(n.startswith("v4l.") for n in names)
  rows, per_sweep = minibatches(cfg, horizon, n_envs)
  assert n_of("v4l.epoch") == n_of("v4l.collect") == n_of("v4l.update") == 1
  assert n_of("v4l.collector.step") == n_of("v4l.env.step") == horizon
  assert n_of("v4l.window") == horizon
  assert n_of("v4l.learner.minibatch") == cfg.opt_epochs * per_sweep
  for name in ("gather", "vf_forward", "vf_backward", "vf_adam",
               "pf_forward", "pf_backward", "pf_adam"):
    assert n_of(f"v4l.learner.{name}") == n_of("v4l.learner.minibatch")
  # the reads an env step passes: the cap and the reset counts; a
  # partial reset's: the finished rows (no trainer wait on the CPU): 2-3
  # a step
  resets = n_of("v4l.collector.reset")
  syncs = [s.name for s in spans if s.name.startswith("v4l.sync.")]
  assert resets >= 2 and n_of("v4l.sync.reset_rows") == resets
  assert n_of("v4l.sync.cap") == n_of("v4l.sync.reset_counts") == horizon
  assert len(syncs) == 2 * horizon + resets, sorted(syncs)
  assert 2 * horizon <= len(syncs) <= 3 * horizon
  assert counts["v4l.collector.envs_reset"] >= 2 * n_envs
  parents = {(s.name, s.parent) for s in spans}
  for pair in [("v4l.collect", "v4l.epoch"),
               ("v4l.collector.step", "v4l.collect"),
               ("v4l.collector.policy", "v4l.collector.step"),
               ("v4l.env.step", "v4l.collector.step"),
               ("v4l.env.pre", "v4l.env.step"),
               ("v4l.window", "v4l.env.step"),
               ("v4l.env.post", "v4l.env.step"),
               ("v4l.env.camera", "v4l.env.post"),
               ("v4l.env.reset", "v4l.collector.reset"),
               ("v4l.env.camera", "v4l.env.reset"),
               ("v4l.collector.stack", "v4l.collect"),
               ("v4l.learner.gae", "v4l.update"),
               ("v4l.learner.minibatch", "v4l.update"),
               ("v4l.learner.vf_adam", "v4l.learner.minibatch"),
               ("v4l.learner.metrics", "v4l.update")]:
    assert pair in parents, pair
  profiling.clear()
