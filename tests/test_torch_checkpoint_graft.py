"""A checkpoint that predates a collector field restores, as the JAX
agent's does (vision4leg_tpu/algo/agent.py:476-502): the field keeps the
restoring agent's fresh value and every other field comes back bit for
bit; a field of the wrong shape or type still raises, and so does a
missing top-level entry.  The thin-goal env at 4 envs on the CPU, its
settle cut to 20 substeps, a narrow LocoTransformer (as
tests/test_torch_agent.py)."""
import dataclasses
import json
import os.path as osp
import warnings

import pytest
import torch

from vision4leg_torch.algo.agent import PPOAgent, _flatten
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.envs.env import A1GymEnv
from vision4leg_torch.envs.get_env import env_config_from_build_params
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "config/rl/static/locotransformer/thin-goal.json")
DROPPED = "cs.env_states.dir_count"


class _Log:
  def __init__(self):
    self.lines = []

  def log(self, msg):
    self.lines.append(msg)

  def add_epoch_info(self, *a, **k):
    pass


@pytest.fixture(scope="module")
def env():
  with open(CONFIG) as f:
    params = json.load(f)
  cfg = dataclasses.replace(
      env_config_from_build_params(params["env"]["env_build"]),
      settle_steps=20)
  return A1GymEnv(cfg, device="cpu")


def _agent(env, save_dir, seed):
  net = LocoTransformerActorCritic(
      action_dim=env.cfg.action_dim, state_input_shape=env.cfg.proprio_dim,
      encoder_hidden_shapes=(16,), transformer_params=((1, 32),),
      append_hidden_shapes=(16,), token_dim=16)
  cfg = PPOConfig(plr=1e-3, vlr=1e-3, opt_epochs=1, batch_size=8,
                  epoch_frames=8, num_epochs=1)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    return PPOAgent(env=env, ac_module=net, cfg=cfg, num_envs=4, seed=seed,
                    logger=_Log(), save_dir=str(save_dir), device="cpu")


def _edit_checkpoint(path, edit):
  ckpt = torch.load(path, weights_only=True)
  edit(ckpt)
  torch.save(ckpt, path)


def test_restore_grafts_a_field_the_checkpoint_lacks(env, tmp_path):
  a = _agent(env, tmp_path, seed=0)
  # a state that differs from a fresh agent's in the dropped field too
  a.collector_state.env_states.dir_count.fill_(7)
  a.save_checkpoint(epoch=0)
  saved = dict(_flatten(a.collector_state, "cs", {}))
  _edit_checkpoint(osp.join(tmp_path, "checkpoint"),
                   lambda c: c["collector"].pop(DROPPED))

  b = _agent(env, tmp_path, seed=1)
  fresh = b.collector_state.env_states.dir_count.clone()
  assert not torch.equal(fresh, saved[DROPPED])
  # train(resume=True) restores it; num_epochs 1 leaves no epoch to run
  b.train(resume=True)
  got = _flatten(b.collector_state, "cs", {})
  assert got.keys() == saved.keys()
  for k, v in saved.items():
    if k == DROPPED:
      assert torch.equal(got[k], fresh)
    else:
      assert torch.equal(got[k], v), k
  for k, v in a.module.state_dict().items():
    assert torch.equal(b.module.state_dict()[k], v), k
  assert any(DROPPED in line for line in b.logger.lines)


def test_restore_still_refuses_a_wrong_field_or_entry(env, tmp_path):
  a = _agent(env, tmp_path, seed=0)
  path = osp.join(tmp_path, "checkpoint")
  a.save_checkpoint(epoch=0)
  key = "cs.env_states.last_action"
  _edit_checkpoint(path, lambda c: c["collector"].__setitem__(
      key, c["collector"][key][:, :6].contiguous()))
  with pytest.raises(ValueError, match="last_action"):
    _agent(env, tmp_path, seed=1).restore_checkpoint()
  a.save_checkpoint(epoch=0)
  _edit_checkpoint(path, lambda c: c["collector"].__setitem__(
      key, c["collector"][key].double()))
  with pytest.raises(ValueError, match="last_action"):
    _agent(env, tmp_path, seed=1).restore_checkpoint()
  a.save_checkpoint(epoch=0)
  _edit_checkpoint(path, lambda c: c.pop("pf_opt"))
  with pytest.raises(KeyError, match="pf_opt"):
    _agent(env, tmp_path, seed=1).restore_checkpoint()
