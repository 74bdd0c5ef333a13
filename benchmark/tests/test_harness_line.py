"""The result's line on a tiny CPU cell, its check, and the faults that the
check has to catch."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, REPO

KEYS = ("correct", "attempted", "failed", "metrics", "device")
CHECKS = ("change_gap", "collect_gap", "env_mismatch", "grad_gap",
          "loss_gap", "norm_gap", "template_gap")


def _run(tiny, name="thin-goal.tiny", trace=False, seed=2 ** 31 + 17):
  from harness import run_cell
  root, bench = tiny
  torch.set_num_threads(4)
  return run_cell.run(name, seed, 0.05, trace, "cpu", time.perf_counter(),
                      bench, root, log=lambda s: None)


def _schema(out: dict, bench: dict, trace: bool):
  assert list(out)[:5] == list(KEYS) and list(out)[-1] == "checks"
  names = [m["name"] for m in bench["per_layer" if trace else "end_to_end"]]
  units = {m["name"]: m["unit"]
           for m in bench["end_to_end"] + bench["per_layer"]}
  assert set(out["metrics"]) <= set(names)
  for k, v in out["metrics"].items():
    assert v["unit"] == units[k] and isinstance(v["value"], float)
  assert sorted(out["checks"]) == list(CHECKS)
  for c in out["checks"].values():
    assert set(c) == {"value", "limit"}
  json.loads(json.dumps(out, allow_nan=False))


@pytest.mark.parametrize("name", ["thin-goal.tiny", "mmdr-moving.tiny"])
def test_line_and_check(tiny, name):
  out = _run(tiny, name)
  _schema(out, tiny[1], trace=False)
  assert set(out["metrics"]) == {"train_steps_per_s", "peak_mem_gib",
                                 "setup_s"}
  assert out["correct"], out["checks"]
  assert out["device"]["platform"] == "cpu"


def test_traced_line(tiny):
  out = _run(tiny, trace=True)
  _schema(out, tiny[1], trace=True)
  # the CPU has no device trace: only the host's metrics are read
  assert {"collect_s", "update_s", "env_step_ms", "train_mfu"} <= set(
      out["metrics"])
  assert not {"camera_ms", "window_roofline", "layer_roofline"} & set(
      out["metrics"])
  assert out["device"]["window_s"] > 0
  assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
  assert out["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_value",
                                   "stale_norm", "altered_reward",
                                   "altered_template"])
def test_fault_is_caught(tiny, fault):
  """The timed path broken underneath: the run's check says incorrect."""
  from harness import cell as cell_lib, faults
  program = cell_lib.load("thin-goal.tiny", tiny[0]).program
  with faults.planted(fault, program):
    out = _run(tiny)
  assert not out["correct"], out["checks"]


def test_no_jax_after_a_run(tiny):
  """A run loads no module named jax, jaxlib, flax, vision4leg_tpu, bench
  or chip_smoke (by top-level name), in a process of its own."""
  root, _ = tiny
  code = (
      "import sys, time, json; sys.path[:0] = [%r, %r]\n"
      "from harness import run_cell\n"
      "bench = json.load(open(%r))\n"
      "run_cell.run('thin-goal.tiny', 5, 0.05, False, 'cpu', "
      "time.perf_counter(), bench, %r, log=lambda s: None)\n"
      "print(json.dumps(run_cell.forbidden_modules()))\n"
      % (BENCH, REPO, os.path.join(root, "BENCHMARK.json"), root))
  env = dict(os.environ, OMP_NUM_THREADS="4")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, check=True)
  assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_refuses_without_card():
  """run.py exits with 2 and prints no result where no card is there."""
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  out = subprocess.run(
      [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
       "thin-goal.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
      capture_output=True, text=True, timeout=300, cwd=REPO)
  assert out.returncode == 2 and out.stdout.strip() == ""
