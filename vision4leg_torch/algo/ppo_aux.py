"""PPO with an auxiliary self-supervised loss (torch mirror of
vision4leg_tpu.algo.ppo_aux; reference torchrl/algo/on_policy/ppo_aux.py).

PPO's update, with the actor loss adding `aux_coeff * aux_loss` from the
policy network's displacement prediction (nets.py:488-530): the critic
first, then the actor on the updated parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from vision4leg_torch.algo.on_policy_base import (TrainState, normal_entropy,
                                                  normal_log_prob)
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner


@dataclasses.dataclass(frozen=True)
class PPOAuxConfig(PPOConfig):
  aux_coeff: float = 1.0


class PPOAuxLearner(PPOLearner):
  """apply_pi_aux(module, obs) -> ((mean, std, logstd), aux_loss)."""

  def __init__(self, cfg: PPOAuxConfig, apply_pi: Callable,
               apply_v: Callable, module, apply_pi_aux: Callable = None):
    super().__init__(cfg, apply_pi, apply_v, module)
    self.apply_pi_aux = apply_pi_aux

  def _minibatch_update(self, ts: TrainState, batch):
    cfg = self.cfg
    obs, acts, advs, est_rets, old_values, old_logp, _, _ = batch
    module = ts.params
    advs = (advs - advs.mean()) / (advs.std(correction=1) + 1e-5)

    values = self.apply_v(module, obs)
    if cfg.clipped_value_loss:   # ppo_aux.py:110-120, same form as PPO
      clipped = old_values + torch.clamp(values - old_values,
                                         -cfg.clip_para, cfg.clip_para)
      vf_loss = 0.5 * torch.maximum((values - est_rets) ** 2,
                                    (clipped - est_rets) ** 2).mean()
    else:
      vf_loss = torch.mean((values - est_rets) ** 2)
    grads = torch.autograd.grad(vf_loss, self.vf_tx.params,
                                allow_unused=True)
    vf_opt = self.vf_tx.update(grads, ts.vf_opt)

    (mean, std, _), aux_loss = self.apply_pi_aux(module, obs)
    log_prob = normal_log_prob(mean, std, acts)
    ent = normal_entropy(std)
    ratio = torch.exp(log_prob - old_logp)
    surr = ratio * advs
    surr_clip = torch.clamp(ratio, 1.0 - cfg.clip_para,
                            1.0 + cfg.clip_para) * advs
    pf_loss = (-torch.mean(torch.minimum(surr, surr_clip))
               - cfg.entropy_coeff * ent.mean()
               + cfg.aux_coeff * aux_loss)   # ppo_aux.py:74-76
    grads = torch.autograd.grad(pf_loss, self.pf_tx.params,
                                allow_unused=True)
    pf_opt = self.pf_tx.update(grads, ts.pf_opt)

    metrics = {
        "Training/policy_loss": pf_loss.detach(),
        "Training/vf_loss": vf_loss.detach(),
        "Training/aux_loss": aux_loss.detach(),
    }
    return ts.replace(pf_opt=pf_opt, vf_opt=vf_opt), metrics
