"""Fixtures of the benchmark's own tests: the harness on the import path,
and a checkout-like root that holds a tiny cell for the CPU.

  python -m pytest benchmark/tests -q              # the CPU tests
  python -m pytest benchmark/tests -q -m cuda      # on the card
"""
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]

TINY = {"num_envs": 4, "epoch_frames": 16, "batch_size": 4}


def tiny_root(path, limits_of="thin-goal.train", traffic=TINY):
  """A directory laid out as a checkout's root: BENCHMARK.json with a
  small cell of each configuration ("<config>.tiny"; by default 4 envs x
  4 steps) held to the limits of `limits_of`, and the benchmark's
  configuration files."""
  with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    bench = json.load(f)
  for c in bench["configs"]:
    name = f"{c['name']}.tiny"
    bench["workloads"].append({"name": name, "config": c["name"],
                               "traffic": "tiny", "chips": 1,
                               "why": "CPU test"})
    for m in bench["per_layer"]:
      if "workloads" in m:
        m["workloads"].append(name)
  os.makedirs(os.path.join(path, "benchmark", "traffic"))
  os.makedirs(os.path.join(path, "benchmark", "limits"))
  shutil.copytree(os.path.join(BENCH, "configs"),
                  os.path.join(path, "benchmark", "configs"))
  with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
    json.dump(bench, f)
  with open(os.path.join(path, "benchmark", "traffic", "tiny.json"),
            "w") as f:
    json.dump(traffic, f)
  for c in bench["configs"]:
    shutil.copy(os.path.join(BENCH, "limits", f"{limits_of}.json"),
                os.path.join(path, "benchmark", "limits",
                             f"{c['name']}.tiny.json"))
  return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
  """(root, bench) of a checkout-like directory with the tiny cells."""
  root = str(tmp_path_factory.mktemp("root"))
  return root, tiny_root(root)


@pytest.fixture
def card():
  """The card, or a skip: decided here, never when a module is imported."""
  import torch
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card")
  return torch.device("cuda")
