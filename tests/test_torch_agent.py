"""The port's PPOAgent (vision4leg_torch.algo.agent) on the CPU: the
thin-goal env at 4 envs and a narrow LocoTransformer, the cases of
tests/test_train_loop.py:22,210 and tests/test_algo.py:301,455,521 of the
JAX agent — the epoch loop and its log, snapshots, a full-resume
checkpoint that continues bit for bit, the warm start from a snapshot and
the short-horizon warning.  The template settle is cut to 20 substeps, as
in those tests, to keep the CPU time small."""
import csv
import dataclasses
import json
import os
import os.path as osp
import shutil
import warnings

import numpy as np
import pytest
import torch

from vision4leg_torch.algo.agent import PPOAgent, _flatten
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.envs.env import A1GymEnv
from vision4leg_torch.envs.get_env import env_config_from_build_params
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
from vision4leg_torch.parallel.mesh import Mesh
from vision4leg_torch.starter import common
from vision4leg_torch.starter.ppo_locotransformer import build_module
from vision4leg_torch.utils.logger import Logger

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "config/rl/static/locotransformer/thin-goal.json")
NUM_ENVS = 4


@pytest.fixture(scope="module")
def thin_goal():
  with open(CONFIG) as f:
    params = json.load(f)
  cfg = dataclasses.replace(
      env_config_from_build_params(params["env"]["env_build"]),
      settle_steps=20)
  return A1GymEnv(cfg, device="cpu"), params


def _net(env):
  return LocoTransformerActorCritic(
      action_dim=env.cfg.action_dim, state_input_shape=env.cfg.proprio_dim,
      encoder_hidden_shapes=(16,), transformer_params=((1, 32), (1, 32)),
      append_hidden_shapes=(16,), token_dim=16)


def _cfg(num_epochs=2, epoch_frames=4 * NUM_ENVS):
  return PPOConfig(plr=1e-3, vlr=1e-3, opt_epochs=2, batch_size=8,
                   epoch_frames=epoch_frames, num_epochs=num_epochs)


class _NullLogger:
  def __init__(self, work_dir):
    self.work_dir = str(work_dir)

  def add_epoch_info(self, *a, **k):
    pass

  def log(self, *a, **k):
    pass


def _agent(env, save_dir, logger, seed=0, **kw):
  kw.setdefault("cfg", _cfg())
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    return PPOAgent(env=env, ac_module=_net(env), num_envs=NUM_ENVS,
                    seed=seed, logger=logger, save_dir=str(save_dir),
                    obs_norm=True, eval_interval=1, save_interval=2,
                    num_eval_envs=2, eval_horizon=3, device="cpu", **kw)


def _state(agent):
  """Every tensor of the agent's training state, by name."""
  ts = agent.train_state
  out = {f"module.{k}": v for k, v in agent.module.state_dict().items()}
  for side in ("pf_opt", "vf_opt"):
    st = getattr(ts, side)
    out.update({f"{side}.mu.{i}": x for i, x in enumerate(st.mu)})
    out.update({f"{side}.nu.{i}": x for i, x in enumerate(st.nu)})
    out[f"{side}.count"] = torch.tensor(st.count)
  out.update(_flatten(agent.collector_state, "cs", {}))
  out["gen.collect"] = agent.collector_state.gen.get_state()
  out["gen.update"] = agent.update_gen.get_state()
  out["gen.eval"] = agent.eval_gen.get_state()
  return out


@pytest.fixture(scope="module")
def trained(thin_goal, tmp_path_factory):
  """Two epochs of train() through a real Logger, eval every epoch, a
  checkpoint after the second."""
  env, params = thin_goal
  log_dir = tmp_path_factory.mktemp("torch_agent")
  logger = Logger("exp", "A1MoveGround", 0, params, str(log_dir))
  agent = _agent(env, osp.join(logger.work_dir, "model"), logger)
  init = {k: v.clone() for k, v in agent.module.state_dict().items()}
  agent.train()
  return agent, logger, init


def test_train_writes_log_snapshots_and_checkpoint(trained):
  agent, logger, init = trained
  with open(logger.csv_file_path, newline="") as f:
    rows = list(csv.DictReader(f))
  assert [r["EPOCH"] for r in rows] == ["0", "1"]
  assert [r["Total Frames"] for r in rows] == ["16", "32"]
  for r in rows:
    for k, v in r.items():
      assert v not in ("", None), k
      assert np.isfinite(float(v)), (k, v)
    assert float(r["diagnostics/nonfinite_obs"]) == 0.0
    for k in ("Training/policy_loss", "Training/vf_loss", "advs/std",
              "Eval_Rewards_Average", "Explore_Time", "Update_Time"):
      assert k in r
  model_dir = osp.join(logger.work_dir, "model")
  for f in ("model_pf_best.pt", "_obs_normalizer_best.npz",
            "model_pf_2.pt", "model_pf_finish.pt", "checkpoint"):
    assert osp.exists(osp.join(model_dir, f)), f
  assert osp.exists(osp.join(logger.work_dir, "params.json"))
  assert agent.train_state.epoch == 2
  assert agent.train_state.pf_opt.count == 2 * 2 * 2
  changed = [k for k, v in agent.module.state_dict().items()
             if not torch.equal(v, init[k])]
  assert len(changed) == len(init)
  snap = torch.load(osp.join(model_dir, "model_pf_finish.pt"),
                    weights_only=True)
  for k, v in agent.module.state_dict().items():
    assert torch.equal(snap[k], v), k


def test_checkpoint_restores_and_resumes_bit_for_bit(trained, thin_goal):
  agent, logger, _ = trained
  env, _ = thin_goal
  other = _agent(env, agent.save_dir, _NullLogger(logger.work_dir), seed=1)
  before = _state(other)
  assert other.restore_checkpoint() == 2
  assert other.total_frames == agent.total_frames == 32
  assert other.best_eval == agent.best_eval
  a, b = _state(agent), _state(other)
  assert set(a) == set(b)
  assert any(not torch.equal(before[k], b[k]) for k in b)
  for k in a:
    assert torch.equal(a[k], b[k]), k
  # both continue identically
  agent.train_epoch()
  other.train_epoch()
  a, b = _state(agent), _state(other)
  for k in a:
    assert torch.equal(a[k], b[k]), k


def test_checkpoint_swap_survives_a_crash_between_renames(trained,
                                                          thin_goal,
                                                          tmp_path):
  agent, _, _ = trained
  env, _ = thin_goal
  save_dir = tmp_path / "model"
  agent.save_dir = str(save_dir)
  os.makedirs(save_dir)
  try:
    agent.save_checkpoint(epoch=6)
  finally:
    agent.save_dir = str(trained[1].work_dir) + "/model"
  # a crash after the first rename leaves only checkpoint_new
  os.rename(save_dir / "checkpoint", save_dir / "checkpoint_new")
  other = _agent(env, save_dir, _NullLogger(tmp_path), seed=3)
  assert other.restore_checkpoint() == 7
  assert osp.exists(save_dir / "checkpoint")
  for k, v in agent.module.state_dict().items():
    assert torch.equal(other.module.state_dict()[k], v), k


def test_train_resume_continues_the_log(trained, thin_goal, tmp_path):
  """train(resume=True) on a copy of the trained run: restores the
  checkpoint, drops log rows past it and runs the remaining epoch."""
  _, logger, _ = trained
  env, params = thin_goal
  shutil.copytree(osp.dirname(osp.dirname(osp.dirname(logger.work_dir))),
                  tmp_path / "copy")
  logger2 = Logger("exp", "A1MoveGround", 0, params, str(tmp_path / "copy"))
  with open(logger2.csv_file_path, "a") as f:      # a crashed epoch's row
    f.write("2," + ",".join(["0"] * 5) + "\n")
  agent2 = _agent(env, osp.join(logger2.work_dir, "model"), logger2,
                  cfg=_cfg(num_epochs=3))
  agent2.train(resume=True)
  with open(logger2.csv_file_path, newline="") as f:
    rows = list(csv.DictReader(f))
  assert [r["EPOCH"] for r in rows] == ["0", "1", "2"]
  assert rows[2]["Total Frames"] == "48"
  assert rows[2]["Training/vf_loss"] not in ("", "0")


def test_warm_start_from_snapshot(trained, thin_goal, tmp_path):
  agent, _, _ = trained
  env, _ = thin_goal
  work_dir = tmp_path / "run"
  save_dir = work_dir / "model"
  save_dir.mkdir(parents=True)
  nrm = agent.collector_state.normalizer
  saved_dir = agent.save_dir
  agent.save_dir = str(save_dir)
  try:
    agent.snapshot("best")
  finally:
    agent.save_dir = saved_dir
  with open(work_dir / "log.csv", "w") as f:
    f.write("EPOCH,Total Frames,Eval_Rewards_Average\n")
    f.write("0,16,\n1,32,12.5\n2,48,7.0\n")
  other = _agent(env, save_dir, _NullLogger(work_dir), seed=1)
  assert other.restore_checkpoint() == 3
  assert other.total_frames == 48
  assert other.best_eval == 12.5
  for k, v in agent.module.state_dict().items():
    assert torch.equal(other.module.state_dict()[k], v), k
  np.testing.assert_allclose(other.collector_state.normalizer.mean.numpy(),
                             nrm.mean.numpy())
  assert float(other.collector_state.normalizer.count) == float(nrm.count)
  # neither checkpoint nor snapshot: a plain 0
  empty = _agent(env, tmp_path / "empty", _NullLogger(tmp_path), seed=2)
  assert empty.restore_checkpoint() == 0


def test_short_horizon_warning(thin_goal, tmp_path):
  env, _ = thin_goal
  kw = dict(env=env, num_envs=NUM_ENVS, seed=0,
            logger=_NullLogger(tmp_path), save_dir=str(tmp_path),
            device="cpu")
  with pytest.warns(UserWarning, match="GAE horizon"):
    PPOAgent(ac_module=_net(env), cfg=_cfg(epoch_frames=16 * NUM_ENVS),
             **kw)
  with warnings.catch_warnings():
    warnings.simplefilter("error")
    PPOAgent(ac_module=_net(env), cfg=_cfg(epoch_frames=64 * NUM_ENVS),
             **kw)


def test_unported_options_raise(thin_goal, tmp_path):
  """Every option is ported now: a mesh is refused only on another
  device than the agent's (tests/test_torch_parallel.py holds the sharded
  epoch); bf16 collection and a separate eval env are ported
  (tests/test_torch_bf16.py and tests/test_torch_sim2sim.py hold them
  against JAX)."""
  env, _ = thin_goal
  kw = dict(env=env, cfg=_cfg(), num_envs=NUM_ENVS, seed=0,
            logger=_NullLogger(tmp_path), save_dir=str(tmp_path),
            device="cpu")
  with pytest.raises(ValueError, match="mesh on cuda"):
    PPOAgent(ac_module=_net(env), mesh=Mesh(1, 0, torch.device("cuda")),
             **kw)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    agent = PPOAgent(ac_module=_net(env), inference_dtype=torch.bfloat16,
                     eval_env=env, **kw)
  assert agent.eval_env is env and agent.inference_dtype == torch.bfloat16
  assert next(agent.collect_module.parameters()).dtype == torch.bfloat16
  assert next(agent.module.parameters()).dtype == torch.float32


def test_starter_pieces_read_the_thin_goal_config(thin_goal, monkeypatch):
  """The starter's config mapping and network at the config's full
  width (starter/common.py:78-93, ppo_locotransformer.py:27-44)."""
  env, params = thin_goal
  cfg = common.ppo_config(params)
  assert (cfg.plr, cfg.vlr, cfg.opt_epochs, cfg.batch_size,
          cfg.epoch_frames, cfg.entropy_coeff, cfg.num_epochs) == (
              1e-4, 1e-4, 3, 1024, 16384, 0.005, 1500)
  assert common.ppo_config(params, num_epochs=2).num_epochs == 2
  assert common.num_eval_envs(params) == 8
  monkeypatch.setenv("V4L_STRICT_EVAL", "1")
  assert common.num_eval_envs(params) == 2
  net = build_module(env, params)
  assert [l.ff1.out_features for l in net.pf_layers] == [256, 256]
  assert net.pf_layers[0].query.in_features == 64
  assert net.encoder.state_mlp.out_dim == 256
  assert net.max_pool is False
  params = dict(params, net=dict(params["net"], max_pool=True))
  assert build_module(env, params).max_pool is True
