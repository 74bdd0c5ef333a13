"""Spawn tensorboard over one or more run directories (mirror of
vision4leg_tpu.utils.tensorboard_starter; reference
torchrl/utils/tensorboard_starter.py).

  python -m vision4leg_torch.utils.tensorboard_starter --dirs log/exp1 log/exp2
"""
from __future__ import annotations

import argparse
import os.path as osp
import subprocess


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--dirs", type=str, nargs="+", required=True)
  p.add_argument("--port", type=int, default=6006)
  args = p.parse_args(argv)
  logdir = ",".join(
      "{}:{}".format(osp.basename(d.rstrip("/")), d) for d in args.dirs)
  subprocess.run(["tensorboard", "--logdir_spec", logdir,
                  "--port", str(args.port)])


if __name__ == "__main__":
  main()
