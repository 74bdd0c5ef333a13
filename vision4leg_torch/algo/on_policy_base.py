"""Shared scaffolding for on-policy learners (torch mirror of
vision4leg_tpu.algo.on_policy_base).

Reference: torchrl/algo/on_policy/on_rl_algo.py (process_epoch_samples +
minibatch sweeps): GAE over the (T, E) trajectory, then opt_epochs x
shuffled time-row minibatches (replay_buffers/on_policy.py:73-97), with
the per-algorithm `_minibatch_update` supplied by subclasses.

The parameters live in the actor-critic module (`TrainState.params`); the
two optimizers are `MaskedAdam`s over its pf and vf parameter sets and
update them in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.parallel import mesh as mesh_lib
from vision4leg_torch.data import gae as gae_lib
from vision4leg_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class OnPolicyConfig:
  """Maps onto the reference JSON `ppo`/`general_setting` sections."""
  plr: float = 3e-4
  vlr: float = 3e-4
  entropy_coeff: float = 0.001
  discount: float = 0.99
  tau: float = 0.95          # GAE lambda
  gae: bool = True
  shuffle: bool = True
  batch_size: int = 1024
  num_epochs: int = 1500
  epoch_frames: int = 16384
  max_episode_frames: int = 999
  time_limit_filter: bool = True
  grad_clip: float = 0.5
  adam_eps: float = 1e-5
  opt_epochs: int = 1
  lr_decay: bool = True      # linear schedule (PPO/TRPO yes, VMPO no)


def param_labels(module: nn.Module, vf_prefixes=("vf",),
                 shared_prefixes=("encoder", "base", "backbone",
                                  "visual_base", "visual_proj",
                                  "state_mlp")) -> Dict[str, str]:
  """Label each top-level parameter group as pf / vf / both: the shared
  encoder belongs to both optimizers, as in the reference (each torch
  optimizer is built over the full pf.parameters()/vf.parameters(), and a
  shared encoder appears in both); heads stay single-owner.  On the
  LocoTransformer: encoder -> both; vf_layers, vf_mlp -> vf; pf_layers,
  pf_mlp, logstd -> pf."""
  def label(name):
    if any(name.startswith(p) for p in vf_prefixes):
      return "vf"
    if any(name.startswith(p) for p in shared_prefixes):
      return "both"
    return "pf"
  tops = dict.fromkeys(n.split(".")[0] for n, _ in module.named_parameters())
  return {k: label(k) for k in tops}


@dataclasses.dataclass
class AdamState:
  count: int                 # updates taken
  mu: List[torch.Tensor]
  nu: List[torch.Tensor]


class MaskedAdam:
  """One optimizer over the parameters labelled `which` or "both": optax's
  masked(chain(clip_by_global_norm(grad_clip), scale_by_adam(eps=adam_eps),
  scale_by_learning_rate(schedule))) of the JAX package
  (`make_masked_adam`).  Each step clips the global norm of the set's
  gradients, applies Adam (eps outside the square root, bias-corrected
  moments) and, with cfg.lr_decay, the linear schedule
  base_lr * (1 - (count // updates_per_epoch) / num_epochs); without it
  the base rate."""

  B1, B2 = 0.9, 0.999

  def __init__(self, cfg: OnPolicyConfig, module: nn.Module, which: str,
               base_lr: float, mesh: mesh_lib.Mesh = mesh_lib.ONE):
    self.mesh = mesh
    self.span = f"v4l.learner.{which}_adam"
    labels = param_labels(module)
    named = [(n, p) for n, p in module.named_parameters()
             if labels[n.split(".")[0]] in (which, "both")]
    self.names = [n for n, _ in named]
    self.params = [p for _, p in named]
    self.cfg = cfg
    self.base_lr = base_lr
    self.updates_per_epoch = max(
        cfg.opt_epochs * (cfg.epoch_frames // cfg.batch_size), 1)
    # the reciprocals of the bias corrections as device tensors while a
    # graph is captured (algo/step_graph.py), else None
    self.inv_bias: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

  def lr(self, count: int) -> float:
    if not self.cfg.lr_decay:
      return self.base_lr
    epoch = count // self.updates_per_epoch
    return self.base_lr * (1.0 - epoch / self.cfg.num_epochs)

  def init(self) -> AdamState:
    return AdamState(count=0,
                     mu=[torch.zeros_like(p) for p in self.params],
                     nu=[torch.zeros_like(p) for p in self.params])

  @torch.no_grad()
  def update(self, grads, state: AdamState) -> AdamState:
    """Apply one step to the parameters in place; `grads` follows
    `self.params` (None for a parameter the loss does not reach).  Under a
    sharded mesh, the gradients are first all-reduced to their mean over
    the ranks."""
    with profiling.span(self.span):
      grads = self.mesh.mean_grads(grads)
      g = [torch.zeros_like(p) if x is None else x
           for x, p in zip(grads, self.params)]
      norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
      clip = self.cfg.grad_clip
      factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
      g = torch._foreach_mul(g, factor)
      return adam_step(self.params, g, state, self.lr(state.count),
                       self.cfg.adam_eps, self.inv_bias)


def bias_corrections(count: int) -> Tuple[float, float]:
  """Adam's two bias corrections after `count` updates."""
  return 1.0 - MaskedAdam.B1 ** count, 1.0 - MaskedAdam.B2 ** count


def inverse_bias_corrections(count: int) -> Tuple[float, float]:
  """The bias corrections' reciprocals as the card's division of float32
  tensors by a Python scalar takes them: 1 / c in double precision,
  rounded to float32."""
  return tuple(float(np.float32(1.0 / c)) for c in bias_corrections(count))


@torch.no_grad()
def adam_step(params, g, state: AdamState, lr: float, eps: float,
              inv_bias: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> AdamState:
  """optax's scale_by_adam(b1 0.9, b2 0.999, eps) then -lr, applied to
  `params` in place: eps outside the square root, bias-corrected
  moments.  The moments are updated in place too (their addresses stay
  fixed, as a captured graph needs), so the returned state shares them
  with `state`.  The bias corrections are Python scalars, or, where
  `inv_bias` is given (a graph's, filled before each replay), their
  reciprocals in float32 0-d tensors, multiplied by: on the card the
  scalar division is that product, bit for bit."""
  b1, b2 = MaskedAdam.B1, MaskedAdam.B2
  mu, nu = state.mu, state.nu
  torch._foreach_mul_(mu, b1)
  torch._foreach_add_(mu, g, alpha=1.0 - b1)
  torch._foreach_mul_(nu, b2)
  torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
  count = state.count + 1
  if inv_bias is None:
    c1, c2 = bias_corrections(count)
    denom, step = torch._foreach_div(nu, c2), torch._foreach_div(mu, c1)
  else:
    denom = torch._foreach_mul(nu, inv_bias[1])
    step = torch._foreach_mul(mu, inv_bias[0])
  torch._foreach_sqrt_(denom)
  torch._foreach_add_(denom, eps)
  torch._foreach_div_(step, denom)
  torch._foreach_add_(params, step, alpha=-lr)
  return AdamState(count=count, mu=mu, nu=nu)


class Adam:
  """optax.adam(lr, eps) over a list of tensors, updated in place; no
  clipping, no schedule (the V-MPO duals, the off-policy learners)."""

  def __init__(self, params, lr: float, eps: float = 1e-8):
    self.params = list(params)
    self.lr, self.eps = lr, eps

  def init(self) -> AdamState:
    return AdamState(count=0,
                     mu=[torch.zeros_like(p) for p in self.params],
                     nu=[torch.zeros_like(p) for p in self.params])

  def update(self, grads, state: AdamState) -> AdamState:
    g = [torch.zeros_like(p) if x is None else x
         for x, p in zip(grads, self.params)]
    return adam_step(self.params, g, state, self.lr, self.eps)


@dataclasses.dataclass
class TrainState:
  params: nn.Module            # the actor-critic; its parameters
  pf_opt: AdamState
  vf_opt: AdamState
  epoch: int
  extras: Any = None           # algo-specific (the V-MPO duals)

  def replace(self, **kw) -> "TrainState":
    return dataclasses.replace(self, **kw)


def minibatches(cfg: OnPolicyConfig, T: int, E: int) -> Tuple[int, int]:
  """(time rows per minibatch, minibatches per opt epoch) of a (T, E)
  trajectory: a minibatch takes whole time rows, batch_size // E of them
  and at least one, as the JAX learner does.  So with E >= batch_size a
  minibatch holds E samples (at 1024 envs the MPC config's batch_size 512
  gives minibatches of 1024, 8 an opt epoch at T = 8), with fewer envs
  batch_size // E * E."""
  rows = max(cfg.batch_size // E, 1)
  return rows, T // rows


class OnPolicyLearner:
  """Base learner; subclasses implement `_minibatch_update(ts, batch)`.

  apply_pi(module, obs) -> (mean, std, logstd); apply_v(module, obs) ->
  (B, 1).  batch = (obs, acts, advs, est_rets, old_values, old_logp,
  means, stds), all flattened (B, ...).

  mesh (parallel.mesh.Mesh): the trajectory holds this rank's envs of the
  global one; minibatches are counted on the global env count, gradients
  all-reduced, and batch statistics and metrics merged over the ranks.
  """

  def __init__(self, cfg: OnPolicyConfig, apply_pi: Callable,
               apply_v: Callable, module: nn.Module,
               mesh: mesh_lib.Mesh = mesh_lib.ONE):
    self.cfg = cfg
    self.apply_pi = apply_pi
    self.apply_v = apply_v
    self.mesh = mesh
    self.pf_tx = MaskedAdam(cfg, module, "pf", cfg.plr, self.mesh)
    self.vf_tx = MaskedAdam(cfg, module, "vf", cfg.vlr, self.mesh)

  def init_state(self, module: nn.Module) -> TrainState:
    return TrainState(params=module, pf_opt=self.pf_tx.init(),
                      vf_opt=self.vf_tx.init(), epoch=0,
                      extras=self.init_extras())

  def init_extras(self):
    return None

  def _minibatch_update(self, ts: TrainState, batch):
    raise NotImplementedError

  # the CUDA graphs of the minibatch step while `update_per_epoch` runs
  _graphs = None

  def _step_graphs(self, dev: torch.device):
    """The CUDA graphs that replay this learner's minibatch step through
    one `update_per_epoch` call on `dev` (algo/step_graph.py), or None
    where the step runs eagerly: here, always."""
    return None

  # ------------------------------------------------------------------
  def compute_advantages(self, traj: Transition, last_value):
    cfg = self.cfg
    args = (traj.rewards[..., 0], traj.values[..., 0],
            traj.terminals[..., 0].float(), traj.time_limits[..., 0].float(),
            last_value)
    if cfg.gae:
      return gae_lib.gae(*args, gamma=cfg.discount, tau=cfg.tau,
                         time_limit_filter=cfg.time_limit_filter)
    return gae_lib.discounted_returns(
        *args, gamma=cfg.discount, time_limit_filter=cfg.time_limit_filter)

  def update_per_epoch(self, ts: TrainState, traj: Transition, last_value,
                       gen: Optional[torch.Generator] = None, perms=None):
    """GAE, then opt_epochs sweeps of shuffled time-row minibatches.

    The permutation of the T time rows of each sweep is drawn from `gen`
    (a generator on the trajectory's device), or taken from `perms`
    ((opt_epochs, T) integers) when given.  Returns (ts, metrics), the
    metrics averaged over all minibatches plus the advantage statistics.
    """
    cfg = self.cfg
    T, E = traj.rewards.shape[:2]
    dev = traj.rewards.device
    mesh = self.mesh
    rows_per_batch, n_batches = minibatches(cfg, T, E * mesh.world)
    with profiling.span("v4l.learner.gae"):
      advs, rets = self.compute_advantages(traj, last_value)
      a_mean, a_var = mesh.moments(advs.reshape(-1))
      adv_metrics = {
          "advs/mean": a_mean, "advs/std": torch.sqrt(a_var),
          "advs/max": mesh.all_reduce(advs.max(), dist.ReduceOp.MAX),
          "advs/min": mesh.all_reduce(advs.min(), dist.ReduceOp.MIN)}
    fields = (traj.obs, traj.acts, advs[..., None], rets[..., None],
              traj.values, traj.log_probs, traj.means, traj.stds)
    # one batch for the call, each minibatch gathered into it: a captured
    # step reads its inputs where its capture found them
    batch = tuple(torch.empty((rows_per_batch * E,) + x.shape[2:],
                              dtype=x.dtype, device=dev) for x in fields)
    collected: Dict[str, list] = {}
    self._graphs = self._step_graphs(dev)
    try:
      for e in range(cfg.opt_epochs):
        if perms is not None:
          perm = torch.as_tensor(perms[e], device=dev).long()
        elif cfg.shuffle:
          perm = torch.randperm(T, generator=gen, device=dev)
        else:
          perm = torch.arange(T, device=dev)
        for i in range(n_batches):
          with profiling.span("v4l.learner.minibatch"):
            idx = perm[i * rows_per_batch:(i + 1) * rows_per_batch]
            with profiling.span("v4l.learner.gather"):
              for x, b in zip(fields, batch):
                torch.index_select(
                    x, 0, idx, out=b.view((rows_per_batch,) + x.shape[1:]))
            ts, m = self._minibatch_update(ts, batch)
            for k, v in m.items():
              collected.setdefault(k, []).append(v)
    finally:
      self._graphs = None
    with profiling.span("v4l.learner.metrics"):
      stacked = mesh.reduce_metrics(
          {k: torch.stack(v) for k, v in collected.items()})
      metrics = {k: v.mean() for k, v in stacked.items()}
    metrics.update(adv_metrics)
    return ts.replace(epoch=ts.epoch + 1), metrics

  def normalize_advantages(self, advs):
    """(advs - mean) / (std + 1e-5) over the minibatch, the global one
    under a sharded mesh (ppo.py:148; the std with Bessel's
    correction)."""
    mean, var = self.mesh.moments(advs.reshape(-1), correction=1)
    return (advs - mean) / (torch.sqrt(var) + 1e-5)


_LOG_2PI = math.log(2 * math.pi)


def normal_log_prob(mean, std, acts):
  return torch.sum(-0.5 * ((acts - mean) / std) ** 2 - torch.log(std)
                   - 0.5 * _LOG_2PI, dim=-1, keepdim=True)


def normal_entropy(std):
  return torch.sum(0.5 + 0.5 * _LOG_2PI + torch.log(std), dim=-1,
                   keepdim=True)



def normal_kl(mean_old, std_old, mean_new, std_new):
  """KL(old || new) per sample, summed over action dims."""
  return torch.sum(
      torch.log(std_new) - torch.log(std_old)
      + (std_old ** 2 + (mean_old - mean_new) ** 2) / (2.0 * std_new ** 2)
      - 0.5, dim=-1, keepdim=True)
