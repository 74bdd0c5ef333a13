"""A cell of BENCHMARK.json, found by name: its configuration file, its
traffic file (`traffic/<traffic>.json`), and the modules that the
configuration names:
  program        `programs/<name>.py`, how the program is built and
                 recorded (see programs/__init__.py);
  reference      `reference/<name>.py`, the plain model it is held to:
                 `spec` (the weights' names, shapes and kinds), `Net`,
                 `gae`, `ppo_steps`, `proprio_dim` and `forward_flops`;
  env_reference  `reference/<name>.py`, the plain env step and reset:
                 `EnvRef`, `mismatch` and `template_gap`.

The traffic file holds the job's sizes: `num_envs`, `epoch_frames` and
`batch_size` (the rest of the epoch's shape, horizon and minibatches,
follows from them as the program's learner derives it).
"""
from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import math
import os
from types import ModuleType
from typing import Dict

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
  name: str
  config: str
  params: dict          # the configuration as it is run, sizes applied
  traffic: dict
  chips: int
  program: ModuleType
  reference: ModuleType
  env_reference: ModuleType

  @property
  def num_envs(self) -> int:
    return self.traffic["num_envs"]

  @property
  def horizon(self) -> int:
    return self.params["collector"]["epoch_frames"] // self.num_envs

  @property
  def minibatch(self):
    """(time rows per minibatch, minibatches per epoch, samples per
    minibatch): whole time rows, batch_size // num_envs of them and at
    least one, opt_epochs sweeps."""
    rows = max(self.params["general_setting"]["batch_size"]
               // self.num_envs, 1)
    per_sweep = self.horizon // rows
    return rows, self.params["ppo"]["opt_epochs"] * per_sweep, \
        rows * self.num_envs


def load(name: str, root: str = REPO) -> Cell:
  with open(os.path.join(root, "BENCHMARK.json")) as f:
    bench = json.load(f)
  work = {w["name"]: w for w in bench["workloads"]}
  if name not in work:
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
  w = work[name]
  conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
  with open(os.path.join(root, conf["file"])) as f:
    params = json.load(f)
  with open(os.path.join(root, "benchmark", "traffic",
                         f"{w['traffic']}.json")) as f:
    traffic = json.load(f)
  mod = importlib.import_module
  return Cell(name, w["config"], apply_traffic(params, traffic), traffic,
              w["chips"], mod(f"programs.{params['program']}"),
              mod(f"reference.{params['reference']}"),
              mod(f"reference.{params['env_reference']}"))


def apply_traffic(params: dict, traffic: dict) -> dict:
  p = copy.deepcopy(params)
  p["collector"]["epoch_frames"] = traffic["epoch_frames"]
  p["general_setting"]["batch_size"] = traffic["batch_size"]
  if traffic["epoch_frames"] % traffic["num_envs"]:
    raise ValueError("epoch_frames must divide by num_envs")
  return p


def precision(params: dict):
  """Set torch's float32 modes to what the configuration states."""
  prec = params["precision"]
  torch.backends.cuda.matmul.allow_tf32 = prec["matmul_tf32"]
  torch.backends.cudnn.allow_tf32 = prec["cudnn_conv_tf32"]


def make_weights(cell: Cell, seed: int, device) -> dict:
  """The network's weights drawn from `seed` on the device, in one call
  to the generator, scaled per leaf by its kind (the reference's
  `spec`)."""
  spec = cell.reference.spec(cell.params)
  total = sum(math.prod(s) for _, s, _ in spec)
  gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
  u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
  out, off = {}, 0
  for name, shape, kind in spec:
    n = math.prod(shape)
    x = u[off:off + n].reshape(shape)
    off += n
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else None
    if kind == "fanin":
      x = x / math.sqrt(fan_in)
    elif kind == "he":
      x = x * math.sqrt(6.0 / fan_in)
    elif kind == "lecun":
      x = x * math.sqrt(3.0 / fan_in)
    elif kind in ("small", "small.bias"):
      x = x * 3e-3
    elif kind == "fanin.bias":
      x = torch.full(shape, 0.1, device=device)
    elif kind in ("he.bias", "lecun.bias", "zero"):
      x = torch.zeros(shape, device=device)
    elif kind == "one":
      x = torch.ones(shape, device=device)
    elif kind == "logstd":
      x = torch.full(shape, math.log(0.125), device=device)
    else:
      raise ValueError(kind)
    out[name] = x.contiguous()
  return out


def limits(name: str, root: str = REPO) -> Dict[str, float]:
  """The limits of the cell's compared numbers (`limits/<cell>.json`)."""
  with open(os.path.join(root, "benchmark", "limits", f"{name}.json")) as f:
    return json.load(f)["limits"]
