"""chip_smoke.py's `sphere_case` is the batch of the card test
tests/test_torch_kernel_cuda.py::test_kernel_matches_plain[2], so that
the smoke run holds the window kernel on the batch where its float32
build with FMA contraction parted from the plain version.  Here, on the
CPU, the card test's batch is captured by running the test with the
window and the comparison replaced, and compared with `sphere_case`
field by field."""
import dataclasses
import importlib.util
import os

import torch

import test_torch_kernel_cuda as case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(x, prefix=""):
  """Every tensor inside x (dataclasses and tuples opened), by path."""
  if isinstance(x, torch.Tensor):
    return {prefix: x}
  if dataclasses.is_dataclass(x):
    return {k: v for f in dataclasses.fields(x)
            for k, v in _flat(getattr(x, f.name),
                              f"{prefix}.{f.name}").items()}
  if isinstance(x, (tuple, list)):
    return {k: v for i, y in enumerate(x)
            for k, v in _flat(y, f"{prefix}[{i}]").items()}
  return {prefix: x}


def test_smoke_sphere_case_is_the_card_tests_batch(monkeypatch):
  seen = []

  def window(*args):
    window.launches += 1
  window.launches = 0
  monkeypatch.setattr(case.pk, "robot_window", window)
  monkeypatch.setattr(case.torch.cuda, "synchronize", lambda: None)
  monkeypatch.setattr(case.pk, "compare_with_plain",
                      lambda args: seen.append(args) or (True, None))
  case.test_kernel_matches_plain(torch.device("cpu"), 2)
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
  smoke = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(smoke)
  want, got = _flat(seen[0]), _flat(smoke.sphere_case(torch.device("cpu")))
  assert want.keys() == got.keys()
  for k, v in want.items():
    if isinstance(v, torch.Tensor):
      assert torch.equal(v, got[k]), k
    else:
      assert v == got[k], k
