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
