"""Experiment logger: stdout table + TensorBoard + CSV + params.json.

Own copy of vision4leg_tpu.utils.logger (torch port).  Mirrors
torchrl/utils/logger.py:12-115: per-epoch scalar dict aggregated from
per-update infos with mean/std/max/min, tensorboard scalars keyed on
total frames, one CSV row per epoch, and a params.json provenance dump so
viewers/deploy tooling can rebuild the exact network.
"""
from __future__ import annotations

import csv
import json
import os
import os.path as osp
import shutil
import sys
import time
from collections import OrderedDict
from numbers import Number

import numpy as np

try:
  from tensorboardX import SummaryWriter
except Exception:  # pragma: no cover
  SummaryWriter = None

try:
  import tabulate as _tabulate_mod
  def _tabulate(rows):
    return _tabulate_mod.tabulate(rows)
except Exception:  # pragma: no cover
  def _tabulate(rows):
    return "\n".join(" | ".join(str(c) for c in r) for r in rows)


# the columns of a PPO run's log.csv as the JAX package wrote them
# (runs/mmdr_moving_10M/A1MoveGround/0/log.csv), in that order; the
# port's other keys follow them
PPO_COLUMNS = (
    "EPOCH", "Total Frames", "Training/policy_loss", "Training/vf_loss",
    "advs/max", "advs/mean", "advs/min", "advs/std", "log_std/mean",
    "logprob/mean", "ratio/max", "ratio/min", "Training/avg_reward",
    "diagnostics/nonfinite_obs", "diagnostics/nonfinite_reward",
    "Running_Average_Rewards", "Train___Time", "Eval_Rewards_Average",
    "Eval____Time")


class Logger:
  def __init__(self, experiment_id, env_name, seed, params, log_dir,
               overwrite=False, leading_columns=()):
    """leading_columns (e.g. PPO_COLUMNS) open log.csv's header in that
    order, present from the first row (empty until a value comes)."""
    self.experiment_id = experiment_id
    self.leading_columns = list(leading_columns)
    self.env_name = env_name
    self.seed = seed
    self.work_dir = osp.join(log_dir, experiment_id, env_name, str(seed))
    if osp.exists(self.work_dir):
      if overwrite:
        shutil.rmtree(self.work_dir)
      else:
        # keep existing runs unless told otherwise (args.py --overwrite)
        pass
    os.makedirs(self.work_dir, exist_ok=True)
    self.tf_writer = (SummaryWriter(osp.join(self.work_dir, "log"))
                      if SummaryWriter else None)
    self.csv_file_path = osp.join(self.work_dir, "log.csv")
    self.update_infos = {}
    self.logger_dict = {}
    self.csv_fieldnames = None
    with open(osp.join(self.work_dir, "params.json"), "w") as f:
      json.dump(params, f, indent=2, default=str)
    self.start_time = time.time()

  def log(self, info: str):
    print("[{:.3f}s] {}".format(time.time() - self.start_time, info),
          flush=True)

  def add_update_info(self, infos: dict):
    """Accumulate per-minibatch update metrics (logger.py:58-64)."""
    for k, v in infos.items():
      self.update_infos.setdefault(k, []).append(float(np.asarray(v)))

  def truncate_epochs_from(self, epoch: int):
    """Drop log.csv rows with EPOCH >= epoch (resume path: a crashed
    segment may have logged past the checkpoint being restored; without
    this the resumed run appends duplicate epoch rows)."""
    if not osp.exists(self.csv_file_path):
      return
    with open(self.csv_file_path) as f:
      lines = f.read().splitlines()
    if not lines:
      return
    kept = [lines[0]]
    for line in lines[1:]:
      try:
        if int(float(line.split(",", 1)[0])) >= epoch:
          continue
      except ValueError:
        pass               # malformed row: keep it for the repair tool
      kept.append(line)
    if len(kept) != len(lines):
      with open(self.csv_file_path, "w") as f:
        f.write("\n".join(kept) + "\n")
      # keep appends consistent with the existing header
      self.csv_fieldnames = [c.strip() for c in lines[0].split(",")]

  def add_epoch_info(self, epoch_num, total_frames, total_time, infos,
                     csv_write=True):
    """Aggregate + emit one epoch of metrics (logger.py:66-115)."""
    rows = [("Epoch", epoch_num), ("Time Consumed", total_time),
            ("Total Frames", total_frames)]
    out = OrderedDict()
    out["EPOCH"] = epoch_num
    out["Total Frames"] = total_frames
    for k, v in infos.items():
      if isinstance(v, Number) or np.isscalar(v) or (
          hasattr(v, "ndim") and getattr(v, "ndim", 1) == 0):
        v = float(np.asarray(v))
        out[k] = v
        rows.append((k, "{:.5f}".format(v)))
        if self.tf_writer:
          self.tf_writer.add_scalar(k, v, total_frames)
    for k, vals in self.update_infos.items():
      arr = np.array(vals)
      stats = {"mean": arr.mean(), "std": arr.std(),
               "max": arr.max(), "min": arr.min()}
      for sk, sv in stats.items():
        key = "{}_{}".format(k, sk)
        out[key] = sv
        if self.tf_writer:
          self.tf_writer.add_scalar(key, sv, total_frames)
      rows.append((k, "{:.5f} +- {:.5f}".format(stats["mean"], stats["std"])))
    self.update_infos = {}
    print(_tabulate(rows), flush=True)
    if csv_write:
      self._write_csv_row(out)

  def _write_csv_row(self, out: "OrderedDict"):
    """Append one row, keeping columns aligned as the key set grows:
    epoch 0 has no Running_Average_Rewards / Eval_* keys yet, so when a
    new key first appears the file is rewritten with the expanded header
    (rows are small: one per epoch)."""
    if self.csv_fieldnames is None and osp.exists(self.csv_file_path):
      # resumed run: adopt the existing header
      with open(self.csv_file_path, newline="") as f:
        self.csv_fieldnames = next(csv.reader(f), None)
    new_keys = [k for k in out
                if self.csv_fieldnames is None or k not in self.csv_fieldnames]
    if self.csv_fieldnames is None:
      self.csv_fieldnames = self.leading_columns + [
          k for k in out if k not in self.leading_columns]
      with open(self.csv_file_path, "w", newline="") as f:
        csv.DictWriter(f, fieldnames=self.csv_fieldnames).writeheader()
    elif new_keys:
      with open(self.csv_file_path, newline="") as f:
        old_rows = list(csv.DictReader(f))
      self.csv_fieldnames = self.csv_fieldnames + new_keys
      with open(self.csv_file_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=self.csv_fieldnames)
        w.writeheader()
        for r in old_rows:
          w.writerow({k: r.get(k, "") for k in self.csv_fieldnames})
    with open(self.csv_file_path, "a", newline="") as f:
      w = csv.DictWriter(f, fieldnames=self.csv_fieldnames)
      w.writerow({k: out.get(k, "") for k in self.csv_fieldnames})
