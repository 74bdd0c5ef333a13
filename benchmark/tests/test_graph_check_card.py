"""On the card (marked `cuda`; skipped without one): the check's steps 2
and 3 run through the replayed CUDA graph of the PPO minibatch, a sound
program is correct, and the two faults planted on the learner
(`half_batch` on the step, `unchanged` on the optimizer) still come out
incorrect, at 64 envs of thin-goal."""
import pytest
import torch

from conftest import tiny_root
from test_harness_card import CARD


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "half_batch", "unchanged"])
def test_learner_faults_are_caught_through_the_graph(card, tmp_path,
                                                     monkeypatch, fault):
  from harness import cell as cell_lib, check, faults
  root = str(tmp_path)
  tiny_root(root, "thin-goal.train", CARD)
  cell = cell_lib.load("thin-goal.tiny", root)
  cell_lib.precision(cell.params)
  limits = cell_lib.limits(cell.name, root)
  replays = []
  replay = torch.cuda.CUDAGraph.replay
  monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                      lambda self: replays.append(1) or replay(self))
  with faults.planted(fault, cell.program):
    agent, cap = check.warm_start(cell, 2 ** 31 + 21, card)
  cfg = agent.learner.cfg
  minibatches = cfg.opt_epochs * cfg.epoch_frames // cfg.batch_size
  # the first minibatch warms up eagerly; every later one is a replay
  assert len(replays) == minibatches - 1
  got = {**check.numbers(cap.program_side(),
                         cap.reference_side(cell.params, tf32=False), cap.w0),
         **cap.env_numbers(cell.params)}
  over = {k: v for k, v in got.items() if v > limits[k]}
  assert bool(over) == (fault is not None), (fault, got)
