"""A PPO starter's run at full length on the card, in segments, and its
report against the JAX package's own run of the same config.

One segment (a process of the LocoTransformer starter, fused layer on in
collection, update and eval; the starter's own flags after `--`):

  python3 tools/long_train.py segment --out seg1.json -- \\
      --config config/rl/moving/frame_extract4_random_delay/thin-goal.json \\
      --seed 0 --num_envs 1024 --num_epochs 611 --stop_epoch 300 \\
      --log_dir <dir> --id torch_mmdr_moving_10M
  python3 tools/long_train.py segment --out seg2.json -- <the same> \\
      --resume          (instead of --stop_epoch 300)

It sets every kernel's launch count to 0 just before `PPOAgent.train`
and reads them just after, and holds them to the count the path implies
(`expected_launches`); it writes them, the card's name and power limit
and the segment's seconds to --out.

The report (on any host; reads the run's log.csv, the JAX run's and
the segments' files when given):

  python3 tools/long_train.py report --run <work dir> \\
      [--jax runs/mmdr_moving_10M/A1MoveGround/0/log.csv] \\
      [--segments seg1.json seg2.json]

prints the learning band's two figures, the rows' checks, epoch and eval
seconds, the peak memory at epochs 20 and the last, the capped episodes
(the collector's time-limit truncations), the launches, and the two
runs' Running_Average_Rewards every 50 epochs, then one JSON line.
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import os.path as osp
import statistics
import subprocess
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

JAX_LOG = "runs/mmdr_moving_10M/A1MoveGround/0/log.csv"
BAND_RA, BAND_RA_EPOCH = 100.0, 200      # RA >= 100 at some epoch <= 200
BAND_EVAL, BAND_EVAL_LAST = 105.0, 30    # mean of the last 30 evals
MEMORY_EPOCHS = (20, None)               # None: the last epoch
MEMORY_BAND = 0.05


def card_name() -> str:
  """The card's name and power limit, as nvidia-smi gives them."""
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return smi.stdout.strip().splitlines()[0]


def expected_launches(epochs: int, evals: int, horizon: int, n_mb: int,
                      eval_horizon: int, bootstraps: int) -> dict:
  """The kernels' launches of `epochs` PPO epochs of the LocoTransformer
  (two layers a forward of pi or v) with the fused layer everywhere:
  a window a collection and eval step; the layer 4 a collection step
  (pi_v), 2 a bootstrap (the epoch's last value and each surpass step's),
  4 a minibatch (pi, v) and 2 an eval step; the backward 4 a minibatch."""
  return {"physics_window": epochs * horizon + evals * eval_horizon,
          "transformer_layer": (epochs * (4 * horizon + 2 + 4 * n_mb)
                                + 2 * bootstraps + evals * 2 * eval_horizon),
          "transformer_layer_bwd": epochs * 4 * n_mb}


def run_segment(out: str, starter_argv):
  """One process of the starter with the fused layer on and its launches
  counted around `PPOAgent.train`."""
  import torch
  from vision4leg_torch.algo import agent as agent_lib
  from vision4leg_torch.algo.on_policy_base import minibatches
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter

  os.environ["V4L_FUSED_ATTN"] = "1"
  os.environ["V4L_FUSED_UPDATE"] = "1"
  os.environ["V4L_MESH"] = "0"
  counters = {"physics_window": pk.robot_window,
              "transformer_layer": att.fused_transformer_layer,
              "transformer_layer_bwd": att.fused_transformer_layer_bwd}
  record = {"argv": list(starter_argv)}
  if torch.cuda.is_available():
    record["card"] = card_name()
  train = agent_lib.PPOAgent.train

  def counted_train(self, resume=False, stop_epoch=None):
    rollout, boot, n_epochs = self.rollout, [0], [0]

    def counted_rollout(cs, max_ep=None):
      steps_in = cs.ep_steps.clone()
      cs, traj, last_value = rollout(cs, max_ep)
      # each step at which some env reached the cap adds a `v` call, the
      # surpass bootstrap (collector/rollout.py)
      boot[0] += int(torch.count_nonzero(agent_lib.capped_episodes(
          steps_in, traj.terminals[..., 0],
          self.cfg.max_episode_frames if max_ep is None else max_ep)))
      n_epochs[0] += 1
      return cs, traj, last_value

    self.rollout = counted_rollout
    for c in counters.values():
      c.launches = 0
    t = time.time()
    train(self, resume=resume, stop_epoch=stop_epoch)
    self._sync("trained")
    seconds = time.time() - t
    launches = {k: c.launches for k, c in counters.items()}
    end = (self.cfg.num_epochs if stop_epoch is None
           else min(stop_epoch, self.cfg.num_epochs))
    epochs = range(end - n_epochs[0], end)
    evals = sum((e + 1) % self.eval_interval == 0 for e in epochs)
    _, n_batches = minibatches(self.cfg, self.horizon, self.num_envs)
    want = expected_launches(len(epochs), evals, self.horizon,
                             self.cfg.opt_epochs * n_batches,
                             self.eval_horizon, boot[0])
    record.update(first_epoch=epochs[0], last_epoch=epochs[-1],
                  evals=evals, bootstrap_steps=boot[0], seconds=seconds,
                  launches=launches, expected_launches=want,
                  cuda_max_memory_gib=(
                      torch.cuda.max_memory_allocated() / 2 ** 30
                      if self.device.type == "cuda" else None))
    with open(out, "w") as f:
      json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    if self.device.type == "cuda" and launches != want:
      raise AssertionError(f"launches {launches} != expected {want}")

  agent_lib.PPOAgent.train = counted_train
  sys.argv = [starter.__file__] + list(starter_argv)
  common.run_experiment(starter.build_module)


def read_log(path: str):
  """log.csv as a list of {column: float or None}, and its header."""
  with open(path, newline="") as f:
    reader = csv.DictReader(f)
    rows = [{k: (float(v) if v not in ("", None) else None)
             for k, v in r.items()} for r in reader]
    return rows, reader.fieldnames


def spread(xs):
  """Median, min, max, 10th and 90th percentiles."""
  xs = sorted(xs)
  pick = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]
  return dict(median=statistics.median(xs), min=xs[0], max=xs[-1],
              p10=pick(0.1), p90=pick(0.9), n=len(xs))


def band(rows):
  """The pre-registered learning band: (a) the first epoch whose
  Running_Average_Rewards reaches BAND_RA, met at or before BAND_RA_EPOCH;
  (b) the mean of the last BAND_EVAL_LAST evals, at least BAND_EVAL (a
  non-finite eval is counted and left out of the means)."""
  first = next((int(r["EPOCH"]) for r in rows
                if (r.get("Running_Average_Rewards") or -math.inf)
                >= BAND_RA), None)
  evals = [r["Eval_Rewards_Average"] for r in rows
           if r.get("Eval_Rewards_Average") is not None]
  mean = lambda xs: (statistics.fmean([x for x in xs if math.isfinite(x)])
                     if any(math.isfinite(x) for x in xs) else None)
  last = evals[-BAND_EVAL_LAST:]
  last_mean = mean(last)
  return dict(
      first_epoch_ra_100=first,
      a_met=first is not None and first <= BAND_RA_EPOCH,
      last_30_eval_mean=last_mean,
      last_30_eval_nonfinite=sum(not math.isfinite(x) for x in last),
      last_10_eval_mean=mean(evals[-10:]),
      b_met=last_mean is not None and last_mean >= BAND_EVAL,
      evals=len(evals),
      last_30_ra_mean=mean([r["Running_Average_Rewards"] for r in rows[-30:]
                            if r.get("Running_Average_Rewards") is not None]))


def ra_table(rows, jax_rows, every=50):
  """Running_Average_Rewards of both runs every `every` epochs and at the
  last, with the eval nearest before each."""
  by = lambda rs: {int(r["EPOCH"]): r for r in rs}
  port, jx = by(rows), by(jax_rows)
  last = max(port)
  out = []
  for e in sorted(set(range(0, last + 1, every)) | {last}):
    def last_eval(d):
      es = [d[k]["Eval_Rewards_Average"] for k in sorted(d) if k <= e
            and d[k].get("Eval_Rewards_Average") is not None]
      return es[-1] if es else None
    out.append(dict(epoch=e,
                    port_ra=port.get(e, {}).get("Running_Average_Rewards"),
                    jax_ra=jx.get(e, {}).get("Running_Average_Rewards"),
                    port_eval=last_eval(port), jax_eval=last_eval(jx)))
  return out


def report(run: str, jax_log: str, segments):
  rows, header = read_log(osp.join(run, "log.csv"))
  jax_rows, jax_header = read_log(jax_log)
  epochs = [int(r["EPOCH"]) for r in rows]
  checks = dict(
      rows=len(rows),
      epochs_in_order=epochs == list(range(len(rows))),
      duplicates=len(epochs) - len(set(epochs)),
      jax_columns_lead=header[:len(jax_header)] == jax_header,
      nonfinite_obs_max=max(r["diagnostics/nonfinite_obs"] for r in rows),
      nonfinite_reward_max=max(r["diagnostics/nonfinite_reward"]
                               for r in rows),
      nonfinite_entries=sum(not math.isfinite(v) for r in rows
                            for v in r.values() if v is not None))
  mem_col = "diagnostics/cuda_max_memory_gib"
  memory = {}
  if mem_col in header:
    for e in MEMORY_EPOCHS:
      r = rows[epochs[-1] if e is None else e]
      memory[int(r["EPOCH"])] = r[mem_col]
    a, b = memory.values()
    memory["ratio_last_to_first"] = b / a
    memory["within_band"] = abs(b / a - 1) <= MEMORY_BAND
  capped = [r.get("diagnostics/capped_episodes") or 0.0 for r in rows]
  # episodes ended in an epoch: its terminals, the terminal rate times
  # the epoch's frames
  frames = rows[0]["Total Frames"]
  ended = [r["diagnostics/terminal_rate"] * frames for r in rows]
  half = len(rows) // 2
  timing = dict(
      train_s=spread([r["Train___Time"] for r in rows]),
      collect_s=spread([r["Explore_Time"] for r in rows]),
      update_s=spread([r["Update_Time"] for r in rows]),
      eval_s=spread([r["Eval____Time"] for r in rows
                     if r.get("Eval____Time") is not None]))
  # the run in parts: its first 100 epochs, to the resume, after it
  parts = {}
  for lo, hi in ((0, 100), (100, 300), (300, len(rows))):
    part = rows[lo:hi]
    if part:
      med = lambda k: statistics.median(r[k] for r in part)
      parts[f"{lo}-{hi - 1}"] = dict(
          collect_s=med("Explore_Time"), update_s=med("Update_Time"),
          terminal_rate=med("diagnostics/terminal_rate"))
  timing["by_part"] = parts
  timing["eval_s_total"] = sum(r["Eval____Time"] for r in rows
                               if r.get("Eval____Time") is not None)
  segs = []
  for p in segments or ():
    with open(p) as f:
      segs.append(json.load(f))
  launches = {k: sum(s["launches"][k] for s in segs)
              for k in (segs[0]["launches"] if segs else ())}
  out = dict(
      run=run, checks=checks, band=band(rows),
      jax_band=band(jax_rows), timing=timing, memory_gib=memory,
      capped_episodes=dict(total=sum(capped), first_epoch=next(
          (e for e, c in zip(epochs, capped) if c), None),
          share_of_ended_second_half=sum(capped[half:]) / sum(ended[half:])),
      launches=launches,
      launches_as_expected=all(s["launches"] == s["expected_launches"]
                               for s in segs),
      segments=[{k: s.get(k) for k in (
          "card", "first_epoch", "last_epoch", "seconds", "launches",
          "bootstrap_steps", "cuda_max_memory_gib")} for s in segs],
      ra_every_50=ra_table(rows, jax_rows))
  print("epoch | port RA | JAX RA | port last eval | JAX last eval")
  fmt = lambda x: "-" if x is None else f"{x:.1f}"
  for t in out["ra_every_50"]:
    print(f"{t['epoch']} | {fmt(t['port_ra'])} | {fmt(t['jax_ra'])} | "
          f"{fmt(t['port_eval'])} | {fmt(t['jax_eval'])}")
  print(json.dumps(out))
  return out


def main(argv=None):
  argv = sys.argv[1:] if argv is None else list(argv)
  starter_argv = []
  if "--" in argv:
    i = argv.index("--")
    argv, starter_argv = argv[:i], argv[i + 1:]
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  sub = p.add_subparsers(dest="mode", required=True)
  s = sub.add_parser("segment")
  s.add_argument("--out", required=True)
  r = sub.add_parser("report")
  r.add_argument("--run", required=True)
  r.add_argument("--jax", default=JAX_LOG)
  r.add_argument("--segments", nargs="*", default=())
  args = p.parse_args(argv)
  if args.mode == "segment":
    run_segment(args.out, starter_argv)
  else:
    report(args.run, args.jax, args.segments)
  return 0


if __name__ == "__main__":
  sys.exit(main())
