"""Print the full kernel-vs-plain report of one case of the card-only test
tests/test_torch_kernel_cuda.py::test_kernel_matches_plain, on the card.

    python3 tools/window_case_report.py [--root DIR] [--n_sph N]

Runs that test case of the checkout at DIR (default: this one) with
`physics_kernel.compare_with_plain` wrapped so that each field's numbers
are printed (the test's assertion shows them cut short), then prints
whether the case passed.  Running it on two checkouts on one card shows
whether their kernels compute the same on the test's inputs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

FIELDS = ("max_abs_err", "f64_max_err", "f32_kernel_vs_f64",
          "f32_plain_vs_f64", "f32_spread", "excused", "failed")


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  ap.add_argument("--n_sph", type=int, default=2)
  args = ap.parse_args()
  import torch
  if not torch.cuda.is_available():
    print("window_case_report: no CUDA device", file=sys.stderr)
    return 2
  root = os.path.abspath(args.root)
  sys.path[:0] = [root, os.path.join(root, "tests")]
  import test_torch_kernel_cuda as case
  compare = case.pk.compare_with_plain

  def report(window_args, run=None):
    ok, rep = compare(window_args, run)
    for k, v in rep["fields"].items():
      print(k, json.dumps({f: v[f] for f in FIELDS}), flush=True)
    return ok, rep

  case.pk.compare_with_plain = report
  try:
    case.test_kernel_matches_plain(torch.device("cuda"), args.n_sph)
  except AssertionError:
    print(f"{root}: case n_sph={args.n_sph} failed")
    return 1
  print(f"{root}: case n_sph={args.n_sph} passed")
  return 0


if __name__ == "__main__":
  sys.exit(main())
