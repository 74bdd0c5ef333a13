"""TRPO learner (torch mirror of vision4leg_tpu.algo.trpo; reference
torchrl/algo/on_policy/trpo.py:13-287).

Full-batch natural policy gradient: a conjugate-gradient solve of
F^-1 g with Fisher-vector products as Hessian-of-KL times v (here a
double backward; in JAX forward-over-reverse, the same matrix), a
sqrt-scaled step to the max_kl trust region, a 10-halving line search on
the surrogate, then v_opt_times minibatch value sweeps.

The policy-parameter subset (everything the pf optimizer owns: the shared
trunk, the policy head and logstd) is flattened in the module's parameter
order for the vector algebra.  The fused transformer layer has no second
derivative (its backward runs on saved residuals), so TRPO runs the layer
unfused and refuses a fused update.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vision4leg_torch.algo.on_policy_base import (OnPolicyConfig,
                                                  OnPolicyLearner, TrainState,
                                                  minibatches, normal_entropy,
                                                  normal_kl, normal_log_prob,
                                                  param_labels)


@dataclasses.dataclass(frozen=True)
class TRPOConfig(OnPolicyConfig):
  max_kl: float = 0.01
  cg_damping: float = 0.1
  cg_iters: int = 10
  residual_tol: float = 1e-10
  v_opt_times: int = 10
  opt_epochs: int = 1


LINE_SEARCH_HALVINGS = 10


def _flat(tensors, like):
  return torch.cat([torch.zeros_like(p).reshape(-1) if t is None
                    else t.reshape(-1) for t, p in zip(tensors, like)])


@torch.no_grad()
def _assign(params, theta):
  i = 0
  for p in params:
    n = p.numel()
    p.copy_(theta[i:i + n].view_as(p))
    i += n


class TRPOLearner(OnPolicyLearner):
  """`last_search` after an update: the accepted step fraction (0 when
  the line search kept the old parameters) and the full step, flat over
  `pf_params`."""

  def __init__(self, cfg: TRPOConfig, apply_pi, apply_v, module,
               fused_update: bool = False):
    if fused_update:
      raise NotImplementedError(
          "TRPO: the fused transformer layer has no second derivative (its "
          "backward runs on saved residuals), and the Fisher-vector product "
          "needs one; run TRPO with the layer unfused")
    super().__init__(cfg, apply_pi, apply_v, module)
    labels = param_labels(module)
    self.pf_names = [n for n, _ in module.named_parameters()
                     if labels[n.split(".")[0]] != "vf"]
    self.pf_params = [p for n, p in module.named_parameters()
                      if labels[n.split(".")[0]] != "vf"]
    self.last_search = {}

  def update_per_epoch(self, ts: TrainState, traj, last_value,
                       gen: Optional[torch.Generator] = None, perms=None):
    """The natural-gradient step, then the value sweeps; `perms`
    ((v_opt_times, T) integers) or `gen` orders the sweeps' time rows."""
    cfg = self.cfg
    module = ts.params
    T, E = traj.rewards.shape[:2]
    dev = traj.rewards.device
    advs, rets = self.compute_advantages(traj, last_value)
    flat = lambda x: x.reshape((T * E,) + x.shape[2:])
    obs, acts = flat(traj.obs), flat(traj.acts)
    advs_f = flat(advs[..., None])
    # ddof=1 as the reference's torch .std() (trpo.py:172)
    advs_n = (advs_f - advs_f.mean()) / (advs_f.std(correction=1) + 1e-4)
    P = self.pf_params
    theta0 = torch.cat([p.detach().reshape(-1) for p in P]).clone()

    with torch.no_grad():
      mean0, std0, _ = self.apply_pi(module, obs)
      logp0 = normal_log_prob(mean0, std0, acts)

    def ls_surrogate():
      # the reference's line-search objective has no entropy term
      # (trpo.py:114-131), though the gradient g it searches along has one
      mean, std, _ = self.apply_pi(module, obs)
      ratio = torch.exp(normal_log_prob(mean, std, acts) - logp0)
      return -torch.mean(ratio * advs_n)

    def mean_kl():
      # KL(current || frozen) with the reference's axis quirk: its sum runs
      # over the env axis of the unflattened (T, E, A) batch, so the mean
      # is sum_all / (T * A) (trpo.py:37-40, 159-163)
      mean, std, _ = self.apply_pi(module, obs)
      return torch.sum(normal_kl(mean, std, mean0, std0)) / (
          T * acts.shape[-1])

    mean, std, _ = self.apply_pi(module, obs)
    ratio = torch.exp(normal_log_prob(mean, std, acts) - logp0)
    surr = (-torch.mean(ratio * advs_n)
            - cfg.entropy_coeff * normal_entropy(std).mean())
    g = _flat(torch.autograd.grad(surr, P, allow_unused=True), P)
    fval0 = surr.detach()

    kl_grads = _flat(torch.autograd.grad(mean_kl(), P, create_graph=True,
                                         allow_unused=True), P)

    def fvp(v):
      # Hessian of the mean KL at theta0 times v, + damping (trpo.py:66-87)
      hv = torch.autograd.grad(kl_grads @ v, P, retain_graph=True,
                               allow_unused=True)
      return _flat(hv, P) + cfg.cg_damping * v

    # conjugate gradient on F x = -g (trpo.py:89-113), cg_iters steps
    b = -g
    x = torch.zeros_like(b)
    r, p_dir, rdotr = b.clone(), b.clone(), b @ b
    for _ in range(cfg.cg_iters):
      z = fvp(p_dir)
      alpha = rdotr / (p_dir @ z)
      x = x + alpha * p_dir
      r = r - alpha * z
      new_rdotr = r @ r
      p_dir = r + (new_rdotr / rdotr) * p_dir
      rdotr = new_rdotr
    step_dir = x
    shs = 0.5 * (step_dir @ fvp(step_dir))
    del kl_grads
    lm = torch.sqrt(shs / cfg.max_kl)
    fullstep = (step_dir / lm).detach()
    expected_rate = ((-g) @ step_dir / lm).detach()

    # backtracking line search (trpo.py:133-152): the first of 10 halvings
    # whose improvement passes
    with torch.no_grad():
      ls_fval0 = ls_surrogate()
      theta_new, frac_taken = theta0, 0.0
      for k in range(LINE_SEARCH_HALVINGS):
        frac = 0.5 ** k
        cand = theta0 + frac * fullstep
        _assign(P, cand)
        improve = ls_fval0 - ls_surrogate()
        if bool((improve / (expected_rate * frac) > 0.1) & (improve > 0)):
          theta_new, frac_taken = cand, frac
          break
      if bool(torch.isnan(theta_new).any()):
        theta_new, frac_taken = theta0, 0.0
      _assign(P, theta_new)
      kl_after = mean_kl()
    self.last_search = dict(step_frac=frac_taken, fullstep=fullstep)

    metrics = {
        "Training/policy_loss": fval0,
        "Training/kl_after": kl_after,
        "advs/mean": advs_f.mean(), "advs/std": advs_f.std(correction=0),
    }

    # --- value sweeps (trpo.py:236-276) ---
    rows_per_batch, n_batches = minibatches(cfg, T, E)
    vf_losses = []
    vf_opt = ts.vf_opt
    for e in range(cfg.v_opt_times):
      if perms is not None:
        perm = torch.as_tensor(perms[e], device=dev).long()
      elif cfg.shuffle:
        perm = torch.randperm(T, generator=gen, device=dev)
      else:
        perm = torch.arange(T, device=dev)
      for i in range(n_batches):
        idx = perm[i * rows_per_batch:(i + 1) * rows_per_batch]
        ob = traj.obs[idx].reshape((rows_per_batch * E,)
                                   + traj.obs.shape[2:])
        rt = rets[idx].reshape(rows_per_batch * E, 1)
        vf_loss = 0.5 * torch.mean((self.apply_v(module, ob) - rt) ** 2)
        grads = torch.autograd.grad(vf_loss, self.vf_tx.params,
                                    allow_unused=True)
        vf_opt = self.vf_tx.update(grads, vf_opt)
        vf_losses.append(vf_loss.detach())
    metrics["Training/vf_loss"] = torch.stack(vf_losses).mean()
    return ts.replace(vf_opt=vf_opt, epoch=ts.epoch + 1), metrics
