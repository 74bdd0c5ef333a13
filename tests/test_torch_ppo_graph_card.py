"""The PPO minibatch replayed as a CUDA graph (algo/step_graph.py) against
the eager step, on the card (skipped without one: run `python -m pytest
--noconftest tests/test_torch_ppo_graph_card.py` there).

At 128 envs of thin-goal (the LocoTransformer at full width, the fused
layer on in collection and update, 48 minibatches of 128 an epoch): two
`update_per_epoch` calls with the graph (the first warms up on its first
minibatch and captures on its second, the second captures on its first)
and two eager ones from the same state, trajectory and permutations give
the same parameters, Adam moments and metrics bit for bit, and leave the
same device memory allocated (cuBLAS's workspaces, one a thread and
stream, dropped on both sides); after `restore_checkpoint` the next
epoch steps from the restored moments; and the eager Adam's division by
a Python scalar is the product with its float32 reciprocal, as the graph
takes it.
"""
import dataclasses
import tempfile

import pytest
import torch

import chip_smoke

ENVS = 128


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = True
  return torch.device("cuda")


def _agent(dev, save_dir):
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.starter import common
  env, meta, params = chip_smoke.build_env(chip_smoke.CONFIG, dev)
  cfg = dataclasses.replace(common.ppo_config(params), batch_size=ENVS,
                            epoch_frames=16 * ENVS)
  net = chip_smoke.actor_critic(env, params, torch.Generator().manual_seed(0))
  return PPOAgent(
      env=env, ac_module=net, cfg=cfg, num_envs=ENVS, seed=3, logger=None,
      save_dir=save_dir, eval_interval=2 ** 62, save_interval=2 ** 62,
      obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"], fused_attention=True,
      fused_update=True, device=dev)


def _state(agent) -> dict:
  """Parameters and both Adams' states, on the host."""
  ts = agent.train_state
  out = {f"module.{k}": v.cpu() for k, v in agent.module.state_dict().items()}
  for side in ("pf_opt", "vf_opt"):
    st = getattr(ts, side)
    out.update({f"{side}.mu.{i}": x.cpu() for i, x in enumerate(st.mu)})
    out.update({f"{side}.nu.{i}": x.cpu() for i, x in enumerate(st.nu)})
    out[f"{side}.count"] = torch.tensor(st.count)
  return out


def _same(a: dict, b: dict):
  assert set(a) == set(b)
  diff = [k for k in a if not torch.equal(a[k], b[k])]
  assert not diff, diff[:8]


@pytest.mark.cuda
def test_scalar_division_is_the_reciprocals_product(cuda):
  """The eager Adam divides by its bias corrections as Python scalars; on
  the card that is the product with their float32 reciprocals, which the
  graph multiplies by, bit for bit, at every count of a long run."""
  from vision4leg_torch.algo.on_policy_base import (bias_corrections,
                                                    inverse_bias_corrections)
  g = torch.Generator(device=cuda).manual_seed(0)
  xs = [torch.rand(4096, generator=g, device=cuda) * 10 ** k
        for k in range(-3, 4)]
  r = torch.empty((), device=cuda)
  for count in list(range(1, 3000)) + [10 ** 5, 10 ** 6]:
    for c, inv in zip(bias_corrections(count),
                      inverse_bias_corrections(count)):
      r.fill_(inv)
      for a, b in zip(torch._foreach_div(xs, c), torch._foreach_mul(xs, r)):
        assert torch.equal(a, b), (count, c)


@pytest.mark.cuda
def test_graph_replays_the_eager_update_bit_for_bit(cuda, monkeypatch):
  from vision4leg_torch.algo.on_policy_base import AdamState
  with tempfile.TemporaryDirectory() as tmp:
    agent = _agent(cuda, tmp)
  learner = agent.learner
  _, traj, last_value = agent.rollout(agent.collector_state)
  T = traj.rewards.shape[0]
  g = torch.Generator().manual_seed(5)
  perms = [torch.randperm(T, generator=g).tolist()
           for _ in range(learner.cfg.opt_epochs)]
  ts0 = agent.train_state
  w0 = {k: v.clone() for k, v in agent.module.state_dict().items()}
  opt0 = {s: getattr(ts0, s) for s in ("pf_opt", "vf_opt")}

  def run():
    agent.module.load_state_dict(w0)
    ts = ts0.replace(**{s: AdamState(o.count, [m.clone() for m in o.mu],
                                     [n.clone() for n in o.nu])
                        for s, o in opt0.items()})
    allocated = lambda: (torch.cuda.synchronize(),
                         torch._C._cuda_clearCublasWorkspaces(),
                         torch.cuda.memory_allocated())[-1]
    before = allocated()
    metrics = []
    for _ in range(2):
      ts, m = learner.update_per_epoch(ts, traj, last_value, perms=perms)
      metrics.append({k: v.cpu() for k, v in m.items()})
    grown = allocated() - before
    agent.train_state = ts
    return _state(agent), metrics, grown

  # what lasts across calls made first: the capture stream, whose pool
  # graph also makes torch's one-time graph RNG state (two small tensors)
  learner._step_graphs(cuda)
  replays = []
  replay = torch.cuda.CUDAGraph.replay
  monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                      lambda self: replays.append(1) or replay(self))
  graphed, graphed_m, graphed_mem = run()
  n = learner.cfg.opt_epochs * T
  assert len(replays) == 2 * n - 1      # all but the warm-up step
  monkeypatch.setattr(type(learner), "_step_graphs", lambda self, dev: None)
  eager, eager_m, eager_mem = run()
  assert len(replays) == 2 * n - 1
  _same(graphed, eager)
  for a, b in zip(graphed_m, eager_m):
    _same(a, b)
  assert graphed["pf_opt.count"] == 2 * n
  assert graphed_mem == eager_mem, (graphed_mem, eager_mem)


@pytest.mark.cuda
def test_epoch_after_restore_steps_from_the_restored_moments(cuda):
  with tempfile.TemporaryDirectory() as tmp:
    agent = _agent(cuda, tmp)
    agent.train_epoch()
    agent.save_checkpoint(0)
    saved = _state(agent)
    agent.train_epoch()
    after = _state(agent)
    assert agent.restore_checkpoint() == 1
    _same(_state(agent), saved)
    agent.train_epoch()
    _same(_state(agent), after)
