"""A long run's pieces in the port, on the CPU at a tiny size: a run
trained in segments (`PPOAgent.train(stop_epoch=...)`, then
`resume=True`) is the same run, bit for bit, as one trained straight
through, where a shorter num_epochs is not (the learning rate decays over
num_epochs); the capped episodes of a rollout (the collector's time-limit
truncations, `agent.capped_episodes`); log.csv opening with the JAX run's
columns (`logger.PPO_COLUMNS`); the starter's V4L_FUSED_ATTN and
--stop_epoch."""
import csv
import importlib.util
import json
import os.path as osp
import sys

import pytest
import torch

from test_torch_agent import _agent, _cfg, _NullLogger, _state, thin_goal  # noqa: F401
from vision4leg_torch.algo import agent as agent_lib
from vision4leg_torch.starter import common
from vision4leg_torch.utils.logger import PPO_COLUMNS, Logger

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
EPOCHS, STOP = 4, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
  """Many small eager ops: with the suite's workers sharing the cores,
  torch's intra-op threads only contend."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _segment(env, params, log_dir, stop, resume, num_epochs=EPOCHS):
  """One segment of a run: a fresh agent of the same seed on the run
  directory, as a process of the starter would train it.  Returns the
  agent and the run's logger."""
  logger = Logger("exp", "A1MoveGround", 0, params, str(log_dir),
                  leading_columns=PPO_COLUMNS)
  a = _agent(env, osp.join(logger.work_dir, "model"), logger,
             cfg=_cfg(num_epochs=num_epochs))
  a.train(resume=resume, stop_epoch=stop)
  return a, logger


def test_segments_joined_by_resume_are_one_run(thin_goal, tmp_path):
  env, params = thin_goal
  whole, _ = _segment(env, params, tmp_path / "whole", None, False)

  _, logger = _segment(env, params, tmp_path / "joined", STOP, False)
  # a stopped segment ends on a checkpoint, and without a finish snapshot
  model = osp.join(logger.work_dir, "model")
  assert osp.exists(osp.join(model, "checkpoint"))
  assert not osp.exists(osp.join(model, "model_pf_finish.pt"))
  joined, logger = _segment(env, params, tmp_path / "joined", None, True)
  a, b = _state(whole), _state(joined)
  assert set(a) == set(b)
  for k in a:
    assert torch.equal(a[k], b[k]), k
  with open(logger.csv_file_path, newline="") as f:
    reader = csv.DictReader(f)
    rows = list(reader)
  assert [int(r["EPOCH"]) for r in rows] == list(range(EPOCHS))
  assert reader.fieldnames[:len(PPO_COLUMNS)] == list(PPO_COLUMNS)
  assert osp.exists(osp.join(model, "model_pf_finish.pt"))

  # a first segment of num_epochs STOP decays its rate to 0 at STOP: not
  # the same run
  _segment(env, params, tmp_path / "short", None, False, STOP)
  short, _ = _segment(env, params, tmp_path / "short", None, True)
  c = _state(short)
  assert any(not torch.equal(a[k], c[k]) for k in a if k.startswith("module"))


def test_capped_episodes_replays_the_step_counts():
  """Four envs over three steps at a cap of 999: env 1 reaches it at the
  second step, env 3 at the first; env 2 falls at the first step and
  starts over; env 0 never gets near."""
  steps_in = torch.tensor([0, 997, 5, 998], dtype=torch.int32)
  term = torch.tensor([[False, False, True, True],
                       [False, True, False, False],
                       [False, False, False, False]])
  assert int(agent_lib.capped_episodes(steps_in, term, 999).sum()) == 2
  # a cap of 6: env 2's fall comes on its 6th step, and counts
  assert int(agent_lib.capped_episodes(steps_in, term, 6).sum()) == 3
  # a cap of 2 and env 0 ending at the second step: every env
  term[1, 0] = True
  assert int(agent_lib.capped_episodes(steps_in, term, 2).sum()) == 4
  # ... but not where it ended at the first (its count then restarts)
  term[0, 0], term[1, 0] = True, False
  assert int(agent_lib.capped_episodes(steps_in, term, 2).sum()) == 3


def test_an_epoch_reports_its_capped_episodes(thin_goal, tmp_path):
  """Episodes capped at 3 steps in a 4-step epoch: the epoch's metric
  counts the terminals its rollout's step counts put at the cap."""
  env, _ = thin_goal
  a = _agent(env, tmp_path, _NullLogger(tmp_path), cfg=_cfg(num_epochs=1))
  rollout, seen = a.rollout, {}

  def watched(cs, max_ep=None):
    seen["steps_in"] = cs.ep_steps.clone()
    out = rollout(cs, max_ep)
    seen["terminals"] = out[1].terminals[..., 0]
    return out

  a.rollout = watched
  capped = float(a.train_epoch(max_ep=3)["diagnostics/capped_episodes"])
  assert capped == float(agent_lib.capped_episodes(
      seen["steps_in"], seen["terminals"], 3).sum())
  assert capped >= 1


def test_logger_opens_with_the_jax_columns(tmp_path):
  log = Logger("exp", "A1MoveGround", 0, {}, str(tmp_path),
               leading_columns=PPO_COLUMNS)
  log.add_epoch_info(0, 16, 1.0, {"Explore_Time": 0.5, "Train___Time": 1.0,
                                  "Training/vf_loss": 2.0})
  log.add_epoch_info(1, 32, 2.0, {"Explore_Time": 0.4, "Train___Time": 0.9,
                                  "Training/vf_loss": 1.5,
                                  "Running_Average_Rewards": 3.0,
                                  "diagnostics/capped_episodes": 0.0})
  with open(log.csv_file_path, newline="") as f:
    reader = csv.DictReader(f)
    rows = list(reader)
  assert reader.fieldnames == list(PPO_COLUMNS) + [
      "Explore_Time", "diagnostics/capped_episodes"]
  assert rows[0]["Running_Average_Rewards"] == ""
  assert float(rows[1]["Running_Average_Rewards"]) == 3.0
  assert float(rows[1]["Training/vf_loss"]) == 1.5
  with open(osp.join(ROOT, "runs/mmdr_moving_10M/A1MoveGround/0/log.csv")
            ) as f:
    assert f.readline().strip().split(",") == list(PPO_COLUMNS)


def test_starter_flags_reach_the_agent(thin_goal, tmp_path, monkeypatch):
  """V4L_FUSED_ATTN turns the fused layer on in the starter's agent, and
  --stop_epoch reaches train()."""
  env, params = thin_goal
  seen = {}

  class Agent:
    def __init__(self, **kw):
      seen.update(kw)

    def train(self, resume=False, stop_epoch=None):
      seen.update(resume=resume, stop_epoch=stop_epoch)

  monkeypatch.setattr(common, "PPOAgent", Agent)
  monkeypatch.setattr(common, "get_env", lambda name, p, device=None: (
      env, {"obs_norm": True, "horizon": 1000, "reward_scale": 1.0}))
  monkeypatch.setenv("V4L_FUSED_ATTN", "1")
  monkeypatch.setattr(sys, "argv", [
      "ppo_locotransformer", "--config", osp.join(
          ROOT, "config/rl/moving/frame_extract4_random_delay/"
          "thin-goal.json"), "--num_envs", "4", "--num_epochs", "611",
      "--stop_epoch", "300", "--log_dir", str(tmp_path)])
  common.train_run(None, common.get_args(), lambda e, p: torch.nn.Linear(1, 1))
  assert seen["fused_attention"] is True
  assert seen["stop_epoch"] == 300 and seen["cfg"].num_epochs == 611
  with open(osp.join(tmp_path, "thin-goal", "A1MoveGround", "0",
                     "params.json")) as f:
    assert json.load(f)["env_name"] == "A1MoveGround"


def test_the_committed_run_report(capsys):
  """tools/long_train.py's report on the committed 611-epoch run of the
  port (runs/torch_mmdr_moving_10M, trained on the card in two segments
  joined by --resume) against the JAX package's run of the config."""
  spec = importlib.util.spec_from_file_location(
      "long_train", osp.join(ROOT, "tools", "long_train.py"))
  tool = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(tool)
  out = tool.report(osp.join(ROOT, "runs/torch_mmdr_moving_10M/"
                             "A1MoveGround/0"),
                    osp.join(ROOT, tool.JAX_LOG), ())
  checks = out["checks"]
  assert checks["rows"] == 611 and checks["epochs_in_order"]
  assert checks["duplicates"] == 0 and checks["jax_columns_lead"]
  assert checks["nonfinite_obs_max"] == 0 == checks["nonfinite_reward_max"]
  assert out["memory_gib"]["within_band"]
  assert out["band"]["a_met"] and out["jax_band"]["a_met"]
  assert out["jax_band"]["last_30_eval_mean"] > 210
  assert len(out["ra_every_50"]) == 14
  assert "epoch | port RA | JAX RA" in capsys.readouterr().out
