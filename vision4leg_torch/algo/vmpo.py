"""V-MPO learner (torch mirror of vision4leg_tpu.algo.vmpo; reference
torchrl/algo/on_policy/v_mpo.py:11-192).

EM-style on-policy MPO: top-half advantage filtering, learnable
temperature eta and KL-penalty alpha duals (clamped >= 1e-8), KL against
the behavior-policy distribution stored by the collector, no LR decay.
"""
from __future__ import annotations

import dataclasses

import torch

from vision4leg_torch.algo.on_policy_base import (Adam, OnPolicyConfig,
                                                  OnPolicyLearner, TrainState,
                                                  normal_kl, normal_log_prob)


@dataclasses.dataclass(frozen=True)
class VMPOConfig(OnPolicyConfig):
  opt_epochs: int = 10
  eta_eps: float = 0.02
  alpha_eps: float = 0.1
  lr_decay: bool = False  # v_mpo.py:46-49 (schedule commented out)


class VMPOLearner(OnPolicyLearner):
  """ts.extras = {"duals": [eta, alpha], "dual_opt": AdamState}: the duals
  are 0-dim tensors of the module's dtype on its device, stepped by plain
  Adam(eps=adam_eps) at plr with no clipping and no schedule
  (v_mpo.py:35-39)."""

  def __init__(self, cfg: VMPOConfig, apply_pi, apply_v, module):
    p = next(module.parameters())
    self._dual_like = dict(dtype=p.dtype, device=p.device)
    super().__init__(cfg, apply_pi, apply_v, module)

  def init_extras(self):
    duals = [torch.tensor(1.0, **self._dual_like),
             torch.tensor(0.1, **self._dual_like)]
    return {"duals": duals,
            "dual_opt": Adam(duals, self.cfg.plr, self.cfg.adam_eps).init()}

  def _minibatch_update(self, ts: TrainState, batch):
    cfg = self.cfg
    obs, acts, advs, est_rets, _, _, b_means, b_stds = batch
    module = ts.params
    advs = (advs - advs.mean()) / (advs.std(correction=1) + 1e-5)

    # --- critic first (v_mpo.py:185) ---
    values = self.apply_v(module, obs)
    vf_loss = torch.mean((values - est_rets) ** 2)
    grads = torch.autograd.grad(vf_loss, self.vf_tx.params,
                                allow_unused=True)
    vf_opt = self.vf_tx.update(grads, ts.vf_opt)

    # --- top-half advantage filter (v_mpo.py:64-73), stable as jnp's ---
    half = advs.shape[0] // 2
    idx = torch.argsort(-advs[:, 0], stable=True)[:half]
    obs_h, acts_h, advs_h = obs[idx], acts[idx], advs[idx]
    bm_h, bs_h = b_means[idx], b_stds[idx]

    duals = [d.detach().clone().requires_grad_(True)
             for d in ts.extras["duals"]]
    eta, alpha = duals
    mean, std, _ = self.apply_pi(module, obs_h)
    log_prob = normal_log_prob(mean, std, acts_h)
    phis = torch.softmax(advs_h / eta.detach(), dim=0)
    policy_loss = -phis * log_prob
    eta_loss = eta * cfg.eta_eps + eta * torch.log(
        torch.mean(torch.exp(advs_h / eta)))
    # KL(new || behavior) per v_mpo.py:94-96
    kl = normal_kl(mean, std, bm_h, bs_h)
    alpha_loss = alpha * cfg.alpha_eps - alpha * kl.mean().detach()
    policy_loss = policy_loss + alpha.detach() * kl
    total = policy_loss.mean() + eta_loss + alpha_loss
    grads = torch.autograd.grad(total, [*self.pf_tx.params, eta, alpha],
                                allow_unused=True)
    n = len(self.pf_tx.params)
    pf_opt = self.pf_tx.update(grads[:n], ts.pf_opt)
    duals = [d.detach() for d in duals]
    dual_opt = Adam(duals, cfg.plr, cfg.adam_eps).update(
        grads[n:], ts.extras["dual_opt"])
    duals = [torch.clamp(d, min=1e-8) for d in duals]

    metrics = {
        "Training/policy_loss": policy_loss.detach().mean(),
        "Training/vf_loss": vf_loss.detach(),
        "Training/alpha_loss": alpha_loss.detach(),
        "Training/alpha": duals[1],
        "Training/eta": duals[0],
        "logprob/mean": log_prob.detach().mean(),
        "KL/mean": kl.detach().mean(),
    }
    return (ts.replace(pf_opt=pf_opt, vf_opt=vf_opt,
                       extras={"duals": duals, "dual_opt": dual_opt}),
            metrics)
