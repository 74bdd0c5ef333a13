"""Env-axis data parallelism of the port (vision4leg_torch.parallel) on
the CPU, over gloo ranks spawned by `mesh.run_ranks` (their functions in
tests/parallel_ranks.py):

  * the sharded PPO update of 2 ranks against the JAX package's update
    sharded over 2 of conftest's CPU devices (GSPMD), on one float32
    trajectory from one set of flax weights and permutations, held with
    tests/test_multichip.py:76-91's tolerances (losses rtol 2e-4, atol
    2e-5; parameters rtol 1e-2, atol 5e-4, Adam amplifying reduction-order
    noise where gradients are ~0); the normalizer merged from the ranks'
    rows against JAX's on the whole batch (1e-6);
  * a thin-goal epoch of 2 ranks against the unranked agent: the same
    initial envs (bits), the rollout within float32 rounding of the
    normalizer's merged moments (see `test_two_ranks_match_one_rank`),
    and the learner on one trajectory in float64 within 1e-9;
  * identical parameters on every rank, the checkpoint gathered and
    re-sharded;
  * the starter's choice of ranks, and the dry run.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import parallel_ranks
from test_torch_ppo import CFG, E, OBS, T, WIDTHS, _trajectory
from vision4leg_tpu.algo.ppo import PPOConfig as JPPOConfig
from vision4leg_tpu.algo.ppo import PPOLearner as JPPOLearner
from vision4leg_tpu.collector.rollout import Transition as JTransition
from vision4leg_tpu.data import normalizer as jnorm
from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_tpu.parallel import mesh as jmesh
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.parallel import dryrun
from vision4leg_torch.parallel import mesh as mesh_lib
from vision4leg_torch.starter import common

RANKS = 2
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=1e-2, atol=5e-4)


@pytest.fixture(scope="module")
def jax_sharded():
  """The JAX learner's update and the normalizer's merge with the env axis
  sharded over 2 CPU devices."""
  flax_net = FlaxAC(**WIDTHS)
  params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
  traj = _trajectory(flax_net, params, np.float32)
  last_value = np.random.default_rng(6).normal(size=E).astype(np.float32)
  raw = np.random.default_rng(7).normal(0.5, 2.0, (E, 40)).astype(
      np.float32)
  mesh = jmesh.make_mesh(RANKS)
  env_axis = NamedSharding(mesh, P(None, jmesh.DATA_AXIS))
  learner = JPPOLearner(
      JPPOConfig(**CFG),
      lambda p, x: flax_net.apply(p, x, method=flax_net.pi),
      lambda p, x: flax_net.apply(p, x, method=flax_net.v), params)
  ts = learner.init_state(jax.device_put(params, jmesh.replicated(mesh)))
  jtraj = JTransition(**{k: jax.device_put(jnp.asarray(v), env_axis)
                         for k, v in traj.items()})
  key = jax.random.PRNGKey(100)
  perms = np.stack([np.asarray(jax.random.permutation(k, T))
                    for k in jax.random.split(key, CFG["opt_epochs"])])
  ts, metrics = jax.jit(learner.update_per_epoch)(
      ts, jtraj, jax.device_put(jnp.asarray(last_value),
                                jmesh.env_sharding(mesh)), key)
  nstate = jax.jit(jnorm.update)(
      jnorm.init_normalizer(40),
      jax.device_put(jnp.asarray(raw), jmesh.env_sharding(mesh)))
  np_params = jax.tree.map(np.asarray, params)
  return dict(params=np_params, traj=traj, last_value=last_value, raw=raw,
              perms=perms,
              updated=params_from_flax(jax.tree.map(np.asarray, ts.params)),
              metrics={k: float(v) for k, v in metrics.items()},
              normalizer=(np.asarray(nstate.mean), np.asarray(nstate.var),
                          float(nstate.count)))


def test_sharded_update_matches_jax_sharded_update(jax_sharded):
  j = jax_sharded
  outs = mesh_lib.run_ranks(
      parallel_ranks.sharded_update, RANKS,
      (j["params"], j["traj"], j["last_value"], j["perms"], j["raw"], CFG),
      backend="gloo", timeout_s=300, threads=1)
  (sd, metrics, nstate), (sd1, metrics1, nstate1) = outs
  for k in sd:                       # the ranks hold the same bits
    assert np.array_equal(sd[k], sd1[k]), k
  assert metrics == metrics1
  for k in ("Training/policy_loss", "Training/vf_loss"):
    np.testing.assert_allclose(metrics[k], j["metrics"][k], **LOSS_TOL,
                               err_msg=k)
  for k in ("advs/mean", "advs/std", "advs/max", "advs/min",
            "ratio/max", "ratio/min", "logprob/mean"):
    np.testing.assert_allclose(metrics[k], j["metrics"][k], rtol=1e-5,
                               atol=1e-6, err_msg=k)
  for k, v in j["updated"].items():
    np.testing.assert_allclose(sd[k], v.numpy(), **PARAM_TOL, err_msg=k)
  for got, want in zip(nstate, j["normalizer"]):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
  torch.set_num_threads(2)
  one = parallel_ranks.epoch(None, str(tmp_path_factory.mktemp("one")))
  traj_in = ({k: v.numpy() for k, v in one["traj"].items()},
             one["last_v"].numpy())
  ranks = mesh_lib.run_ranks(
      parallel_ranks.epoch, RANKS,
      (str(tmp_path_factory.mktemp("ranks")), traj_in), backend="gloo",
      timeout_s=400, threads=2)
  return one, ranks


def test_two_ranks_match_one_rank(epochs):
  """The same initial envs bit for bit (every reset draw the global
  draw's rows).  The rollouts part only by float32 rounding: the ranks'
  normalizer merges moments in float64 where the unranked one sums in
  float32 (~1e-7 relative), which moves every normalized observation and
  so the actions, rewards and partial resets' states by ~1e-6; 1e-4 bounds
  that without a fault.  The terminals (episode ends and partial resets)
  are the same.  The learner on one trajectory in float64: parameters
  and metrics within 1e-9."""
  one, ranks = epochs
  r0 = ranks[0]
  for k, v in one["init"].items():
    assert torch.equal(r0["init"][k], v), k
  for k, v in one["traj"].items():
    if v.dtype == torch.bool:
      assert torch.equal(r0["traj"][k], v), k
    else:
      np.testing.assert_allclose(r0["traj"][k], v, rtol=1e-4, atol=1e-4,
                                 err_msg=k)
  assert int(one["traj"]["terminals"].sum()) >= NUM_RESETS
  for got, want in zip(r0["normalizer"], one["normalizer"]):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
  for k, v in one["params64"].items():
    np.testing.assert_allclose(r0["params64"][k], v, rtol=1e-9, atol=1e-9,
                               err_msg=k)
  for k, v in one["metrics64"].items():
    np.testing.assert_allclose(r0["metrics64"][k], v, rtol=1e-9, atol=1e-9,
                               err_msg=k)


NUM_RESETS = parallel_ranks.NUM_ENVS     # every env ends its 3-step episode


def test_ranks_hold_identical_parameters_and_checkpoints(epochs):
  _, ranks = epochs
  for name in ("params", "params64"):
    for k, v in ranks[0][name].items():
      assert torch.equal(ranks[1][name][k], v), (name, k)
  assert ranks[0]["epoch_metrics"] == ranks[1]["epoch_metrics"]
  for r in ranks:
    assert r["restored_equal"]
  # the checkpoint holds the global episode count; rank 0 restores it
  assert ranks[0]["restored_finished"] == sum(r["finished"] for r in ranks)
  assert ranks[1]["restored_finished"] == 0.0


def test_unranked_agent_restores_a_ranked_checkpoint(epochs,
                                                     tmp_path_factory):
  """The ranks' checkpoint (the gathered global collector) restores into
  one unranked agent of all the envs."""
  _, ranks = epochs
  save_dir = None
  for p in tmp_path_factory.getbasetemp().iterdir():
    if p.name.startswith("ranks") and osp.exists(p / "checkpoint"):
      save_dir = str(p)
  agent = parallel_ranks._agent(None, save_dir, seed=3)
  assert agent.restore_checkpoint() == 1
  assert float(agent.collector_state.finished_count) == sum(
      r["finished"] for r in ranks)
  for k, v in ranks[0]["params"].items():
    assert torch.equal(agent.module.state_dict()[k], v), k


def test_mpc_env_shards(tmp_path):
  """The MPC env over 2 ranks (JAX tests/test_multichip.py:160-192 shards
  it too): the same draws (integer fields bit for bit), and states and a
  2-step rollout within float32 rounding.  Unlike A1GymEnv's reset, which
  places a settled template, the MPC reset settles every env through the
  window, whose plain CPU version rounds its batched products differently
  at 2 and at 4 envs (~1e-10 in the quaternions); the rollout adds the
  merged normalizer's rounding (as above)."""
  init, traj = parallel_ranks.mpc_rollout(None, str(tmp_path / "one"))
  ranks = mesh_lib.run_ranks(parallel_ranks.mpc_rollout, RANKS,
                             (str(tmp_path / "ranks"),), backend="gloo",
                             timeout_s=300, threads=2)
  r_init, r_traj = ranks[0]
  for k, v in init.items():
    if v.is_floating_point():
      np.testing.assert_allclose(r_init[k], v, rtol=1e-6, atol=1e-6,
                                 err_msg=k)
    else:
      assert torch.equal(r_init[k], v), k
  for k, v in traj.items():
    np.testing.assert_allclose(r_traj[k].float(), v.float(), rtol=1e-4,
                               atol=1e-4, err_msg=k)


@pytest.mark.parametrize("cards,num_envs,flag,world", [
    (1, 1024, "1", 1), (2, 1024, "1", 2), (4, 1024, "1", 4),
    (2, 1023, "1", 1), (3, 1024, "1", 1), (2, 1024, "0", 1)])
def test_starter_chooses_ranks(monkeypatch, cards, num_envs, flag, world):
  """One rank per card where num_envs divides over the cards; otherwise
  one card, logged (JAX starter/common.py:100-108); V4L_MESH=0 opts
  out."""
  monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
  monkeypatch.setenv("V4L_MESH", flag)
  logged = []
  assert common.choose_world(num_envs, logged.append) == world
  skipped = cards > 1 and flag == "1" and world == 1
  assert bool(logged) == skipped
  if skipped:
    assert f"num_envs={num_envs} not divisible by {cards}" in logged[0]


def test_take_rows_checks_the_env_axis():
  draws = (torch.arange(8).reshape(4, 2), None)
  rows = mesh_lib.take_rows(draws, 1, 2, 4)
  assert torch.equal(rows[0], torch.tensor([[2, 3], [4, 5]]))
  assert rows[1] is None
  with pytest.raises(ValueError, match="expected 5"):
    mesh_lib.take_rows(draws, 0, 1, 5)


def test_dryrun_with_two_gloo_ranks(capsys):
  loss = dryrun.dryrun_multichip(RANKS)
  assert np.isfinite(loss)
  assert "dryrun_multichip(2): one PPO step OK" in capsys.readouterr().out
