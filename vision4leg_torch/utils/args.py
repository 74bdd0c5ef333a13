"""CLI flags + JSON experiment config loader.

Own copy of vision4leg_tpu.utils.args (torch port); mirrors
torchrl/utils/args.py:6-53 so every reference invocation —
`python -m vision4leg_torch.starter.ppo_locotransformer --config <json>
 --seed N --log_dir D --id ID` — works unchanged.
"""
from __future__ import annotations

import argparse
import json


def get_args():
  parser = argparse.ArgumentParser(description="RL")
  parser.add_argument("--seed", type=int, default=0,
                      help="random seed (default: 0)")
  parser.add_argument("--num_envs", type=int, default=None,
                      help="number of parallel on-device envs "
                           "(replacement for vec_env_nums x proc_nums; "
                           "defaults to vec_env_nums)")
  parser.add_argument("--num_epochs", type=int, default=None,
                      help="override general_setting.num_epochs (train "
                           "length in epochs of epoch_frames each)")
  parser.add_argument("--vec_env_nums", type=int, default=1,
                      help="vector env numbers (reference flag)")
  parser.add_argument("--proc_nums", type=int, default=1,
                      help="process numbers (reference flag; envs live "
                           "on-device here, kept for CLI parity)")
  parser.add_argument("--eval_episodes", type=int, default=1)
  parser.add_argument("--save_dir", type=str, default="./snapshots")
  parser.add_argument("--data_dir", type=str, default="./data")
  parser.add_argument("--log_dir", type=str, default="./log")
  parser.add_argument("--no_cuda", action="store_true", default=False)
  parser.add_argument("--cuda", action="store_true", default=False,
                      help="accepted for parity; the device is the card")
  parser.add_argument("--device", type=int, default=0)
  parser.add_argument("--config", type=str, default=None,
                      help="config file")
  parser.add_argument("--id", type=str, default=None,
                      help="experiment id")
  parser.add_argument("--overwrite", action="store_true", default=False)
  parser.add_argument("--resume", action="store_true", default=False,
                      help="resume from the run's full checkpoint "
                           "(optimizer + RNG + normalizer state)")
  parser.add_argument("--stop_epoch", type=int, default=None,
                      help="end this process before that epoch, on a full "
                           "checkpoint: one segment of a num_epochs run, "
                           "continued with --resume (the learning-rate "
                           "schedule still spans num_epochs)")
  return parser.parse_args()


def get_params(file_name: str) -> dict:
  with open(file_name) as f:
    return json.load(f)
