"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output.

  python3 benchmark/run.py --workload thin-goal.train --seed 7 \
      --seconds 30 --trace 0

From the root of a checkout, on a machine with the card(s) the cell asks
for; without them it exits with 2 and prints no result.  `--trace 0`
reports the cell's end-to-end metrics, `--trace 1` its per-layer metrics
(see README.md beside this file).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, REPO) if p not in sys.path]


def main(argv=None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)

  import torch
  # one process with one host thread for torch's own CPU work: the
  # program is bound by its Python thread's launches, and idle worker
  # threads of a CPU thread pool only contend with it
  torch.set_num_threads(1)
  from harness import cell as cell_lib
  from harness import run_cell

  with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    bench = json.load(f)
  cell = cell_lib.load(args.workload, REPO)
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f"{args.workload} needs {cell.chips} CUDA device(s); "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
          f" available", file=sys.stderr)
    return 2
  result = run_cell.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START, bench, REPO)
  leftover = run_cell.forbidden_modules()
  if leftover:
    print(f"forbidden modules loaded: {leftover}", file=sys.stderr)
    return 3
  print(json.dumps(result, allow_nan=False), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
