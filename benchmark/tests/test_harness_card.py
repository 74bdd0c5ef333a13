"""On the card (marked `cuda`; they skip without one): the control, the
plain reference with its matrix products in TF32 put in the program's
place, comes out incorrect by the cell's limits, while the program
itself is correct, at 64 envs of each configuration."""
import pytest
import torch

from conftest import tiny_root

CARD = {"num_envs": 64, "epoch_frames": 1024, "batch_size": 64}


@pytest.mark.cuda
@pytest.mark.parametrize("config,limits_of", [
    ("thin-goal", "thin-goal.train"), ("mmdr-moving", "mmdr-moving.train")])
def test_control_is_incorrect(card, tmp_path, config, limits_of):
  from harness import cell as cell_lib, check
  root = str(tmp_path)
  tiny_root(root, limits_of, CARD)
  cell = cell_lib.load(f"{config}.tiny", root)
  cell_lib.precision(cell.params)
  limits = cell_lib.limits(cell.name, root)
  for seed in (11, 12, 13):
    _, cap = check.warm_start(cell, seed, card)
    ref = cap.reference_side(cell.params, tf32=False)
    prog = {**check.numbers(cap.program_side(), ref, cap.w0),
            **cap.env_numbers(cell.params)}
    assert all(prog[k] <= limits[k] for k in prog), prog
    ctl = check.numbers(cap.reference_side(cell.params, tf32=True,
                                           norm_dtype=torch.float32),
                        ref, cap.w0)
    assert any(ctl[k] > limits[k] for k in ctl), ctl
