"""The readings the limits of a cell's compared numbers are set from, at
the cell's own size on the card (no timed window: a training cell's
numbers come from its first epoch).

  python3 benchmark/calibrate.py --workload thin-goal.train \
      --seeds 11 12 13 ... --control 3 --fault half_batch 3

For each seed: the program's numbers against the reference (the lower
readings); for the first `--control` seeds the control's, the reference
computed with its matrix products in TF32, put in the program's place;
with `--fault`, the program run again on the first seeds with that fault
planted under its timed path (harness/faults.py).  One JSON line per
reading on standard output.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, REPO) if p not in sys.path]


def main(argv=None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", type=int, nargs="+", required=True)
  ap.add_argument("--control", type=int, default=3)
  ap.add_argument("--fault", nargs=2, action="append", default=[],
                  metavar=("NAME", "SEEDS"))
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--float64", action="store_true",
                  help="also hold the program and the float32 reference "
                  "against the reference in float64")
  args = ap.parse_args(argv)

  import torch
  torch.set_num_threads(1)
  from harness import cell as cell_lib
  from harness import check, faults

  cell = cell_lib.load(args.workload, REPO)
  cell_lib.precision(cell.params)
  dev = torch.device(args.device)

  def first_epoch(seed, fault=None):
    with faults.planted(fault, cell.program):
      return check.warm_start(cell, seed, dev)[1]

  def leaves(side, ref, w0):
    """Beside the compared numbers: the worst leaves of the per-leaf gaps
    (the gradient's over every leaf, as the worst-leaf measure took
    it)."""
    every = [n for ns in ref["names"].values() for n in ns]
    out = {}
    for name, gaps in (("grad", check.grad_gaps(side, ref, every)),
                       ("change", check.change_gaps(side, ref, w0))):
      worst = sorted(gaps, key=gaps.get)[-3:]
      out[f"worst_{name}_leaves"] = {n: gaps[n] for n in worst}
      out[f"worst_{name}_gap"] = gaps[worst[-1]]
    return out

  def emit(kind, seed, got):
    print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                      **got}), flush=True)

  for i, seed in enumerate(args.seeds):
    t0 = time.perf_counter()
    cap = first_epoch(seed)
    ref = cap.reference_side(cell.params, tf32=False)
    prog = cap.program_side()
    emit("program", seed, {**check.numbers(prog, ref, cap.w0),
                           **cap.env_numbers(cell.params),
                           **leaves(prog, ref, cap.w0)})
    if args.float64:
      ref64 = cap.reference_side(cell.params, tf32=False,
                                 dtype=torch.float64)
      for name, side in (("reference", ref), ("program", prog)):
        emit(f"{name}_vs_float64", seed, {
            **check.numbers(side, ref64, cap.w0),
            **leaves(side, ref64, cap.w0)})
    if i < args.control:
      ctl = cap.reference_side(cell.params, tf32=True,
                               norm_dtype=torch.float32)
      emit("control", seed, {**check.numbers(ctl, ref, cap.w0),
                             **leaves(ctl, ref, cap.w0)})
    print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
  for name, n in args.fault:
    for seed in args.seeds[:int(n)]:
      cap = first_epoch(seed, name)
      ref = cap.reference_side(cell.params, tf32=False)
      prog = cap.program_side()
      emit(f"fault:{name}", seed,
           {**check.numbers(prog, ref, cap.w0),
            **cap.env_numbers(cell.params), **leaves(prog, ref, cap.w0)})
  return 0


if __name__ == "__main__":
  sys.exit(main())
