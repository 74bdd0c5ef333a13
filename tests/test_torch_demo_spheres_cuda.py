"""The CUDA physics-window kernel on the paths the locomotion-controller
demo and the sphere terrain give it, against its plain PyTorch version,
on the card (skipped without one: run `python -m pytest --noconftest
tests/test_torch_demo_spheres_cuda.py` on the card).

* The demo's first 20 ticks at one env (row 1h, hybrid mode, 5
  substeps) in float64 through the kernel against the same ticks through
  the plain window, at 1e-9 on positions, angles and the quaternion
  (`chip_smoke.demo_float64_hold`).
* A sphere-terrain batch of 12 envs (thin-goal with random_sphere_with_
  subgoal) after two steps, the nearest sphere moved against a toe in
  every fourth env (`chip_smoke.sphere_terrain_case`), by
  `physics_kernel.compare_with_plain`.
"""
import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda")


def _chip_smoke():
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.mark.cuda
def test_demo_ticks_match_plain_in_float64(cuda):
  from vision4leg_torch.starter import locomotion_controller_example as demo
  cs = _chip_smoke()
  env = demo.build_env("a1", cuda)
  diff, moved = cs.demo_float64_hold(env, 20)
  assert max(diff[k] for k in ("pos", "rpy", "joint_q", "quat")) <= 1e-9, \
      diff
  assert max(diff.values()) <= 1e-7, diff
  assert moved > 1e-4


@pytest.mark.cuda
def test_window_matches_plain_on_the_sphere_terrain(cuda):
  from vision4leg_torch.envs.get_env import get_env
  from vision4leg_torch.ops import physics_kernel as pk
  cs = _chip_smoke()
  with open(os.path.join(ROOT, cs.CONFIG)) as f:
    params = json.load(f)
  params["env"]["env_build"].update(cs.SPHERE_OVERRIDES)
  env, _ = get_env(params["env_name"], params["env"], device=cuda)
  gen = torch.Generator(device=cuda).manual_seed(0)
  states, _ = env.reset(12, gen)
  low, high = env.action_low, env.action_high
  for _ in range(2):
    act = low + (high - low) * torch.rand(12, 6, generator=gen, device=cuda)
    states, _, _, _, _ = env.step_batch(states, act, gen)
  args, rows = cs.sphere_terrain_case(env, states)
  assert args[5].shape == (12, env.NEAR_BOXES, 5)
  counts = {}
  pk.window_plain(*args, counts=counts)
  assert int(counts["sphere_contacts"].sum()) > 0
  ok, rep = pk.compare_with_plain(args)
  assert ok, rep
