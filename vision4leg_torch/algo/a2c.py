"""A2C and REINFORCE learners (torch mirror of vision4leg_tpu.algo.a2c;
reference torchrl/algo/on_policy/a2c.py:8-114 and reinforce.py:7-82).

A2C: policy gradient -logp * normalized-adv with an entropy bonus, value
MSE; both gradients are taken at the pre-update parameters, then the pf
step, then the vf step.  The optimizers update the module in place, so
both gradients are computed before either step (the shared encoder would
otherwise have moved under the vf gradient).
"""
from __future__ import annotations

import dataclasses

import torch

from vision4leg_torch.algo.on_policy_base import (OnPolicyConfig,
                                                  OnPolicyLearner, TrainState,
                                                  normal_entropy,
                                                  normal_log_prob)


@dataclasses.dataclass(frozen=True)
class A2CConfig(OnPolicyConfig):
  opt_epochs: int = 1
  lr_decay: bool = False  # A2C has no schedule in the reference


def _normalized(advs):
  return (advs - advs.mean()) / (advs.std(correction=1) + 1e-5)


class A2CLearner(OnPolicyLearner):

  def _minibatch_update(self, ts: TrainState, batch):
    cfg = self.cfg
    obs, acts, advs, est_rets, _, _, _, _ = batch
    module = ts.params
    advs = _normalized(advs)

    mean, std, _ = self.apply_pi(module, obs)
    log_prob = normal_log_prob(mean, std, acts)
    ent = normal_entropy(std)
    pf_loss = torch.mean(-log_prob * advs) - cfg.entropy_coeff * ent.mean()
    values = self.apply_v(module, obs)
    vf_loss = torch.mean((values - est_rets) ** 2)
    pf_grads = torch.autograd.grad(pf_loss, self.pf_tx.params,
                                   allow_unused=True)
    vf_grads = torch.autograd.grad(vf_loss, self.vf_tx.params,
                                   allow_unused=True)
    pf_opt = self.pf_tx.update(pf_grads, ts.pf_opt)
    vf_opt = self.vf_tx.update(vf_grads, ts.vf_opt)

    metrics = {
        "Training/policy_loss": pf_loss.detach(),
        "Training/vf_loss": vf_loss.detach(),
        "v_pred/mean": values.detach().mean(),
        "std/mean": std.detach().mean(),
        "ent": ent.detach().mean(),
        "log_prob": log_prob.detach().mean(),
    }
    return ts.replace(pf_opt=pf_opt, vf_opt=vf_opt), metrics


class ReinforceLearner(OnPolicyLearner):
  """Vanilla policy gradient (reinforce.py:7-82): -logp * adv with
  per-minibatch advantage normalization, adv the discounted return minus
  the collected values.  The reference forces gae=False and, like A2C,
  has no lr decay; both are forced here."""

  def __init__(self, cfg, apply_pi, apply_v, module):
    cfg = dataclasses.replace(cfg, gae=False, lr_decay=False)
    super().__init__(cfg, apply_pi, apply_v, module)

  def _minibatch_update(self, ts: TrainState, batch):
    cfg = self.cfg
    obs, acts, advs, _, _, _, _, _ = batch
    advs = _normalized(advs)
    mean, std, _ = self.apply_pi(ts.params, obs)
    log_prob = normal_log_prob(mean, std, acts)
    ent = normal_entropy(std)
    pf_loss = torch.mean(-log_prob * advs) - cfg.entropy_coeff * ent.mean()
    grads = torch.autograd.grad(pf_loss, self.pf_tx.params,
                                allow_unused=True)
    pf_opt = self.pf_tx.update(grads, ts.pf_opt)
    return (ts.replace(pf_opt=pf_opt),
            {"Training/policy_loss": pf_loss.detach()})
