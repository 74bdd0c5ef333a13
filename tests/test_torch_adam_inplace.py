"""The Adam step that updates its moments in place (so that a CUDA graph of
the PPO minibatch finds them where it captured them) against the former
step that made new moments every update, kept here as it was; and the
PPO learner's choice of the eager step on the CPU and under a sharded
mesh (algo/step_graph.py graphs the step only on one CUDA device), and
PPO-aux's eager step everywhere.
"""
import pytest
import torch

from vision4leg_torch.algo import on_policy_base
from vision4leg_torch.algo.on_policy_base import (Adam, AdamState,
                                                  MaskedAdam, OnPolicyConfig)
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner
from vision4leg_torch.algo.ppo_aux import PPOAuxConfig, PPOAuxLearner
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.models.actor_critic import StateActorCritic
from vision4leg_torch.parallel import mesh as mesh_lib

STEPS = 5
OBS, A = 10, 3


@torch.no_grad()
def former_adam_step(params, g, state: AdamState, lr: float, eps: float):
  """adam_step as it was: new moment lists every update."""
  b1, b2 = MaskedAdam.B1, MaskedAdam.B2
  mu = torch._foreach_mul(state.mu, b1)
  torch._foreach_add_(mu, g, alpha=1.0 - b1)
  nu = torch._foreach_mul(state.nu, b2)
  torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
  count = state.count + 1
  denom = torch._foreach_div(nu, 1.0 - b2 ** count)
  torch._foreach_sqrt_(denom)
  torch._foreach_add_(denom, eps)
  step = torch._foreach_div(mu, 1.0 - b1 ** count)
  torch._foreach_div_(step, denom)
  torch._foreach_add_(params, step, alpha=-lr)
  return AdamState(count=count, mu=mu, nu=nu)


@torch.no_grad()
def former_masked_update(tx: MaskedAdam, grads, state: AdamState):
  """MaskedAdam.update as it was, on the former step."""
  g = [torch.zeros_like(p) if x is None else x
       for x, p in zip(grads, tx.params)]
  norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
  clip = tx.cfg.grad_clip
  factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
  g = torch._foreach_mul(g, factor)
  return former_adam_step(tx.params, g, state, tx.lr(state.count),
                          tx.cfg.adam_eps)


def _net(seed=0):
  return StateActorCritic(A, OBS, hidden_shapes=(16,),
                          append_hidden_shapes=(16,),
                          generator=torch.Generator().manual_seed(seed))


# 2 updates an epoch and 4 epochs: the linear rate falls at updates 2, 4
CFG = OnPolicyConfig(plr=3e-3, vlr=4e-3, batch_size=4, epoch_frames=8,
                     opt_epochs=1, num_epochs=4, grad_clip=0.5)


def _optimizers(kind, module):
  """(new, former update) over `module`'s parameters."""
  if kind == "masked":
    tx = MaskedAdam(CFG, module, "pf", CFG.plr)
    return tx, lambda g, s: former_masked_update(tx, g, s)
  tx = Adam(module.parameters(), 1e-2, eps=1e-8)
  return tx, lambda g, s: former_adam_step(
      tx.params, [torch.zeros_like(p) if x is None else x
                  for x, p in zip(g, tx.params)], s, tx.lr, tx.eps)


@pytest.mark.parametrize("kind", ["masked", "adam"])
def test_in_place_step_gives_the_former_bits(kind):
  """Five steps from one state: the parameters and both moments of the
  in-place step equal the former step's bit for bit, the global-norm clip
  engaged and (MaskedAdam) the linear rate crossing two epochs; the
  moment tensors stay the same objects."""
  new_net, old_net = _net(), _net()
  new_tx, _ = _optimizers(kind, new_net)
  _, old_update = _optimizers(kind, old_net)
  new_state, old_state = new_tx.init(), new_tx.init()
  old_state = AdamState(0, [m.clone() for m in old_state.mu],
                        [n.clone() for n in old_state.nu])
  moments = list(new_state.mu) + list(new_state.nu)
  gen = torch.Generator().manual_seed(1)
  rates = set()
  for k in range(STEPS):
    grads = [torch.randn(p.shape, generator=gen) * (k + 1)
             for p in new_tx.params]
    grads[-1] = None                       # a parameter the loss misses
    if kind == "masked":
      norm = torch.linalg.vector_norm(
          torch.stack([g.norm() for g in grads[:-1]]))
      assert norm > CFG.grad_clip          # the clip engages
      rates.add(new_tx.lr(new_state.count))
    new_state = new_tx.update(grads, new_state)
    old_state = old_update(grads, old_state)
    assert new_state.count == old_state.count == k + 1
    for a, b in zip(new_tx.params, old_net.parameters()):
      assert torch.equal(a, b)
    for a, b in zip(new_state.mu + new_state.nu,
                    old_state.mu + old_state.nu):
      assert torch.equal(a, b)
  assert all(a is b for a, b in zip(new_state.mu + new_state.nu, moments))
  if kind == "masked":
    assert len(rates) == 3


def _learner(mesh=mesh_lib.ONE):
  net = _net()
  cfg = PPOConfig(batch_size=8, epoch_frames=16, opt_epochs=2, num_epochs=4)
  learner = PPOLearner(cfg, lambda m, x: m.pi(x), lambda m, x: m.v(x), net,
                       mesh)
  return learner, net


def _traj(T=4, E=4):
  g = torch.Generator().manual_seed(2)
  r = lambda *s: torch.randn(*s, generator=g)
  no = torch.zeros(T, E, 1, dtype=torch.bool)
  return Transition(obs=r(T, E, OBS), acts=r(T, E, A), log_probs=r(T, E, 1),
                    values=r(T, E, 1), rewards=r(T, E, 1), terminals=no,
                    time_limits=no, means=r(T, E, A),
                    stds=torch.ones(T, E, A))


def test_cpu_and_sharded_learners_step_eagerly(monkeypatch):
  """PPO on the CPU, or under a sharded mesh on a card, takes no graph:
  no step graphs, every MaskedAdam update with Python-scalar bias
  corrections, and no CUDA graph made."""
  cpu, _ = _learner()
  assert cpu._step_graphs(torch.device("cpu")) is None
  sharded, _ = _learner(mesh_lib.Mesh(world=2, rank=0))
  assert sharded._step_graphs(torch.device("cuda", 0)) is None

  def no_graph(*a, **kw):
    raise AssertionError("a CUDA graph on the eager path")
  monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
  seen = []
  step = on_policy_base.adam_step
  learner, net = _learner()

  def adam_step(params, g, state, lr, eps, inv_bias=None):
    seen.append((inv_bias, learner._graphs))
    return step(params, g, state, lr, eps, inv_bias)
  monkeypatch.setattr(on_policy_base, "adam_step", adam_step)
  ts, _ = learner.update_per_epoch(learner.init_state(net), _traj(),
                                   torch.zeros(4),
                                   perms=[[0, 1, 2, 3], [3, 2, 1, 0]])
  # 2 opt epochs x 2 minibatches, two optimizers each
  assert len(seen) == 8 and all(b is None and g is None for b, g in seen)
  assert ts.pf_opt.count == ts.vf_opt.count == 4
  assert learner._graphs is None


def test_ppo_aux_takes_no_step_graphs_on_a_card():
  """PPO-aux inherits PPO's learner but steps with its own minibatch
  update, which is not the graphed one: no step graphs on a card either."""
  cfg = PPOAuxConfig(batch_size=8, epoch_frames=16, opt_epochs=2,
                     num_epochs=4)
  aux = PPOAuxLearner(cfg, lambda m, x: m.pi(x), lambda m, x: m.v(x), _net())
  assert aux._step_graphs(torch.device("cuda", 0)) is None
  assert aux._step_graphs(torch.device("cpu")) is None


def test_gather_into_one_batch_keeps_the_eager_update():
  """update_per_epoch gathers each minibatch into one batch of the call:
  the update equals minibatch steps on freshly indexed batches."""
  learner, net = _learner()
  other, other_net = _learner()
  traj = _traj()
  perms = [[2, 0, 3, 1], [1, 3, 0, 2]]
  ts, metrics = learner.update_per_epoch(learner.init_state(net), traj,
                                         torch.zeros(4), perms=perms)
  ts2 = other.init_state(other_net)
  advs, rets = other.compute_advantages(traj, torch.zeros(4))
  seen = {}
  for perm in perms:
    for i in range(2):
      idx = torch.tensor(perm[2 * i:2 * i + 2])
      take = lambda x: x[idx].reshape((8,) + x.shape[2:])
      batch = (take(traj.obs), take(traj.acts), take(advs[..., None]),
               take(rets[..., None]), take(traj.values),
               take(traj.log_probs), take(traj.means), take(traj.stds))
      ts2, m = other._minibatch_update(ts2, batch)
      for k, v in m.items():
        seen.setdefault(k, []).append(v)
  for a, b in zip(net.parameters(), other_net.parameters()):
    assert torch.equal(a, b)
  for k, v in seen.items():
    assert torch.equal(metrics[k], torch.stack(v).mean()), k
