"""The port's JAX-free reader of flax snapshots (utils/flax_msgpack.py)
against flax.serialization on the trained snapshots committed in runs/,
the policies it converts against the JAX modules on the same weights, and
the agent's warm start from a copy of a committed JAX run.

- The reader: every array bit-equal to `flax.serialization.
  msgpack_restore`'s, with the same dtype and shape, on six runs of four
  model families (LocoTransformer on A1MoveGround, the mountain and MPC;
  vision-only; Nature-CNN; state-only), and the tree the same.
- Each converted module (built by the port's starter from the run's
  params.json) against the JAX module of the JAX starter, applied to the
  flax params, on a seeded batch of 4 observations: rtol 1e-5 / atol 1e-5
  in float32 (the same function; sums in another order).
- The warm start: `PPOAgent.restore_checkpoint` on a tmp_path copy of
  mmdr_moving_10M with no checkpoint and no .pt snapshot takes the .flax
  file: epoch 611, 10,010,624 frames and the best eval of its log.csv,
  the converted weights and the run's normalizer.
Nothing is written under runs/.
"""
import csv
import dataclasses
import importlib
import json
import os.path as osp
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_torch.algo.agent import PPOAgent
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.starter import common
from vision4leg_torch.utils import flax_msgpack

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
# run -> (env name, the starter that trained it)
RUNS = {"mmdr_moving_10M": ("A1MoveGround", "ppo_locotransformer"),
        "mount_10M_r3": ("A1MoveGround", "ppo_locotransformer"),
        "mpc_thin_10M": ("A1MoveGroundMPC", "ppo_locotransformer"),
        "vision_only_thin_5M": ("A1MoveGroundMPC",
                                "ppo_locotransformer_vision_only"),
        "nature_naive_10M": ("A1MoveGround", "ppo_nature_cnn"),
        "state_baseline_10M": ("A1MoveGround", "ppo_state")}
TOL = dict(rtol=1e-5, atol=1e-5)


def _work_dir(run):
  return osp.join(ROOT, "runs", run, RUNS[run][0], "0")


def _snapshot(run):
  return osp.join(_work_dir(run), "model", "model_pf_best.flax")


def _same_tree(a, b, path=""):
  if isinstance(b, dict):
    assert isinstance(a, dict) and list(a) == list(b), path
    return sum(_same_tree(a[k], b[k], f"{path}/{k}") for k in b)
  assert isinstance(a, np.ndarray) and a.flags.writeable, path
  assert a.dtype == b.dtype and a.shape == b.shape, path
  assert a.tobytes() == b.tobytes(), path
  return 1


@pytest.mark.parametrize("run", sorted(RUNS))
def test_reader_is_bit_equal_to_flax(run):
  with open(_snapshot(run), "rb") as f:
    raw = f.read()
  got = flax_msgpack.read_flax_bytes(raw)
  assert _same_tree(got, serialization.msgpack_restore(raw)) > 10
  assert set(got) == {"params"}


def test_reader_raises_on_what_it_does_not_read():
  arr = serialization.msgpack_serialize({"a": np.arange(3.0)})
  np.testing.assert_array_equal(flax_msgpack.read_flax_bytes(arr)["a"],
                                np.arange(3.0))
  with pytest.raises(ValueError, match="complex"):
    flax_msgpack.read_flax_bytes(serialization.msgpack_serialize(
        {"c": 1 + 2j}))
  chunked = serialization.msgpack_serialize(
      {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})
  with pytest.raises(ValueError, match="chunked"):
    flax_msgpack.read_flax_bytes(chunked)
  with pytest.raises(ValueError, match="truncated"):
    flax_msgpack.read_flax_bytes(arr[:-3])
  with pytest.raises(ValueError, match="trailing"):
    flax_msgpack.read_flax_bytes(arr + b"\x00")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_converted_policy_matches_the_jax_module(run):
  """The run's policy through the port (convert + the port starter's
  module) and through JAX (the JAX starter's module on the flax params),
  on 4 seeded observations: pi's mean and logstd, and v."""
  env_name, starter = RUNS[run]
  with open(osp.join(_work_dir(run), "params.json")) as f:
    params = json.load(f)
  jenv, _ = jax_get_env(env_name, params["env"])
  tenv, _ = get_env(env_name, params["env"], device="cpu")
  assert jenv.obs_dim == tenv.obs_dim
  jmod = importlib.import_module(f"starter.{starter}").build_module(
      jenv, params)
  flax_params = serialization.msgpack_restore(open(_snapshot(run),
                                                   "rb").read())
  sd, _ = flax_msgpack.load_jax_run(_work_dir(run))
  tmod = importlib.import_module(
      f"vision4leg_torch.starter.{starter}").build_module(tenv, params)
  tmod.load_state_dict(sd, strict=True)
  rng = np.random.default_rng(sorted(RUNS).index(run))
  obs = rng.normal(size=(4, tenv.obs_dim)).astype(np.float32)
  p = tenv.cfg.proprio_dim
  obs[:, p:] = rng.uniform(0.0, 1.0, obs[:, p:].shape)
  (jmean, _, jlogstd) = jmod.apply(flax_params, jnp.asarray(obs),
                                   method=jmod.pi)
  jv = jmod.apply(flax_params, jnp.asarray(obs), method=jmod.v)
  with torch.no_grad():
    mean, _, logstd = tmod.pi(torch.tensor(obs))
    v = tmod.v(torch.tensor(obs))
  assert mean.shape == (4, tenv.cfg.action_dim)
  np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
  np.testing.assert_allclose(logstd.numpy(), np.asarray(jlogstd), **TOL)
  np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_warm_start_from_a_copy_of_a_jax_run(tmp_path):
  """The port's agent, built from the run's params.json by the starter's
  pieces, resumes a copy of mmdr_moving_10M from its .flax snapshot."""
  src = _work_dir("mmdr_moving_10M")
  work = tmp_path / "mmdr_moving_10M" / "A1MoveGround" / "0"
  shutil.copytree(src, work)
  with open(work / "params.json") as f:
    params = json.load(f)
  env, meta = get_env("A1MoveGround", params["env"], device="cpu")
  env.cfg = dataclasses.replace(env.cfg, settle_steps=20)
  from vision4leg_torch.starter.ppo_locotransformer import build_module

  class Log:
    lines = []

    def log(self, msg):
      self.lines.append(msg)

  logger = Log()
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")     # the short-horizon warning
    agent = PPOAgent(env=env, ac_module=build_module(env, params),
                     cfg=common.ppo_config(params), num_envs=4, seed=0,
                     logger=logger, save_dir=str(work / "model"),
                     obs_norm=meta["obs_norm"], device="cpu")
  assert agent.restore_checkpoint() == 611
  assert agent.total_frames == 10_010_624
  with open(work / "log.csv", newline="") as f:
    evals = [float(r["Eval_Rewards_Average"]) for r in csv.DictReader(f)
             if r["Eval_Rewards_Average"]]
  assert agent.best_eval == max(evals)
  sd, nstate = flax_msgpack.load_jax_run(src)
  for k, v in agent.module.state_dict().items():
    assert torch.equal(v, sd[k]), k
  d = np.load(work / "model" / "_obs_normalizer_best.npz")
  np.testing.assert_array_equal(
      agent.collector_state.normalizer.mean.numpy(), d["mean"])
  np.testing.assert_array_equal(agent.collector_state.normalizer.var.numpy(),
                                d["var"])
  assert "model_pf_best.flax" in logger.lines[-1]
  # a .pt snapshot beside it comes first
  torch.save({k: v + 1 for k, v in sd.items()},
             work / "model" / "model_pf_best.pt")
  assert agent.restore_checkpoint() == 611
  assert torch.equal(agent.module.state_dict()["logstd"], sd["logstd"] + 1)
