"""The CUDA physics-window kernel against its plain PyTorch version on a
small moving thin-wide batch, on the card (skipped without one: run
`python -m pytest --noconftest tests/test_torch_mmdr_cuda.py` on the
card).  The env of config/rl/moving/frame_extract4_random_delay/
thin-wide.json steps 12 envs a few times with random actions (the boxes
move); `chip_smoke.moving_case` then moves one more step's boxes, prunes
them and moves the nearest box of every fourth env against a toe.  The
comparison is `physics_kernel.compare_with_plain`."""
import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "rl", "moving",
                      "frame_extract4_random_delay", "thin-wide.json")


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
def test_window_matches_plain_on_moving_thin_wide(cuda):
  from vision4leg_torch.envs.get_env import get_env
  from vision4leg_torch.ops import physics_kernel as pk
  with open(CONFIG) as f:
    params = json.load(f)
  env, _ = get_env(params["env_name"], params["env"], device=cuda)
  gen = torch.Generator(device=cuda).manual_seed(0)
  states, _ = env.reset(12, gen)
  start = states.terrain.boxes.clone()
  low, high = env.action_low, env.action_high
  for _ in range(4):
    act = low + (high - low) * torch.rand(12, 6, generator=gen, device=cuda)
    states, _, _, _, _ = env.step_batch(states, act, gen)
  assert not torch.equal(states.terrain.boxes, start)
  args, rows = _chip_smoke().moving_case(env, states)
  assert rows.numel() == 3
  before = pk.robot_window.launches
  pk.robot_window(*args)
  torch.cuda.synchronize()
  assert pk.robot_window.launches == before + 1
  ok, report = pk.compare_with_plain(args)
  assert ok, report
