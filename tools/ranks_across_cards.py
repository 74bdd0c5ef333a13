"""Env-axis data parallelism across the cards of one host, on NCCL.

    python3 tools/ranks_across_cards.py

With W >= 2 visible cards:
  1. the thin-goal starter (`vision4leg_torch.starter.ppo_locotransformer`)
     trains EPOCHS epochs at 1024 envs on one card (V4L_MESH=0) and then
     over every card (it starts one NCCL rank per card itself, 1024 / W
     envs a card): the log's rows with finite metrics, rank 0's finish
     snapshot, the last epoch's seconds and env-steps/s on each;
  2. chip_smoke.py's `epoch_on_rank` on W NCCL ranks, one a card, beside
     one unranked agent of 1024 envs on card 0 from the same seed,
     checked by chip_smoke's `check_ranks_against_one`: each rank's
     launches of rows 1, 2 and 2ad exact, the same initial observations,
     the ranks' trajectory (with partial resets) the unranked one's
     within RANK_TRAJ_TOL, the ranks' parameters the same bits, four
     fused minibatches from one state within FUSED_UPDATE_BAND of the
     unranked ones.
Prints the cards' names and power limits and one JSON line; exits 1 on a
failed check and 2 with fewer than two cards.
"""
from __future__ import annotations

import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
EPOCHS = 2     # the first epoch of a process carries its warmup


def starter_epochs(tmp, ranks: bool):
  """EPOCHS epochs of the thin-goal starter at NUM_ENVS envs, over every
  card (ranks) or on one (V4L_MESH=0); the last epoch's numbers."""
  import chip_smoke as cs
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  label = "ranks" if ranks else "one card"
  os.environ["V4L_MESH"] = "1" if ranks else "0"
  run_id = "ranks" if ranks else "one"
  sys.argv = ["ppo_locotransformer", "--config",
              os.path.join(ROOT, cs.CONFIG), "--num_envs",
              str(cs.NUM_ENVS), "--num_epochs", str(EPOCHS), "--log_dir",
              tmp, "--id", run_id, "--seed", "0"]
  t = time.perf_counter()
  common.run_experiment(starter.build_module)
  seconds = time.perf_counter() - t
  work = os.path.join(tmp, run_id, "A1MoveGround", "0")
  with open(os.path.join(work, "log.csv"), newline="") as f:
    rows = list(csv.DictReader(f))
  vals = {k: float(v) for k, v in rows[-1].items() if v not in ("", None)}
  bad = [k for k, v in vals.items() if not math.isfinite(v)]
  snap = os.path.join(work, "model", "model_pf_finish.pt")
  rate = float(rows[-1]["Total Frames"]) / len(rows) / vals["Train___Time"]
  cs.log(f"[starter, {label}] {EPOCHS} thin-goal epochs in {seconds:.2f}s "
         f"(process start included): {len(rows)} log rows; the last "
         f"epoch's Train___Time {vals['Train___Time']:.3f}s (collection "
         f"{vals['Explore_Time']:.3f}s, update {vals['Update_Time']:.3f}s)"
         f" = {rate:.1f} env-steps/s, policy_loss "
         f"{vals['Training/policy_loss']:.5f}; finish snapshot "
         f"{os.path.exists(snap)}")
  if len(rows) != EPOCHS or bad or not os.path.exists(snap):
    raise AssertionError(f"[starter, {label}] {len(rows)} rows, non-finite "
                         f"{bad}, snapshot {os.path.exists(snap)}")
  return dict(seconds=seconds, train_s=vals["Train___Time"],
              collect_s=vals["Explore_Time"], update_s=vals["Update_Time"],
              env_steps_per_s=rate)


def main() -> int:
  import torch
  W = torch.cuda.device_count()
  if W < 2:
    print(f"ranks_across_cards: {W} card(s); two or more are needed",
          file=sys.stderr)
    return 2
  import chip_smoke as cs
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import nvcc
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.parallel import mesh as mesh_lib
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cards = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip()
  print(cards, flush=True)
  nvcc.build(["physics_window", "transformer_layer"])
  pk.build_library()
  att.build_library()
  card = f"{W} x {cards.splitlines()[0]}"
  dev = torch.device("cuda", 0)
  with tempfile.TemporaryDirectory(prefix="ranks_across_cards_") as tmp:
    starter = {"one card": starter_epochs(tmp, False),
               "ranks": starter_epochs(tmp, True)}
    t = time.perf_counter()
    pending = mesh_lib.start_ranks(cs.epoch_on_rank, W, (tmp,),
                                   backend="nccl", timeout_s=600)
    plain, params = cs.thin_goal_agent(dev, cs.NUM_ENVS, save_dir=tmp)
    init = {k: v.clone() for k, v in plain.module.state_dict().items()}
    obs0 = cs.first_obs(plain)
    raw0 = plain.collector_state.raw_obs.cpu()
    _, plain_traj, _ = cs.gated_epoch(plain)
    plain_after = {k: v.cpu() for k, v in plain.module.state_dict().items()}
    ranks = mesh_lib.join_ranks(pending)
    ranks_s = time.perf_counter() - t
  plain.module.load_state_dict(init)
  single = cs.rank_update_check(plain.module, obs0.expand(4, *obs0.shape),
                                params)
  checked = cs.check_ranks_against_one(ranks, plain, raw0, single,
                                       plain_after, plain_traj, "nccl",
                                       card)
  print(json.dumps({"cards": cards.splitlines(), "world": W,
                    "starter": starter, "ranks_wall_s": ranks_s,
                    **checked}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
