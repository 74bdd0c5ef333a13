"""PPO learner (torch mirror of vision4leg_tpu.algo.ppo).

Reference: torchrl/algo/on_policy/ppo.py (+ a2c.py, on_rl_algo.py).
Semantics reproduced:
  * separate Adam(eps=1e-5) optimizers for the pf and vf parameter sets;
    the shared encoder belongs to both,
  * critic step first, then the actor step on the updated params
    (ppo.py:152-153),
  * ratio against the behavior log-probs stored by the collector,
  * per-minibatch advantage normalization (ppo.py:148),
  * clipped surrogate + entropy bonus, optional clipped value loss,
  * per-optimizer grad-norm clip 0.5, linear LR decay per epoch.
"""
from __future__ import annotations

import dataclasses

import torch

from vision4leg_torch.algo import step_graph
from vision4leg_torch.algo.on_policy_base import (OnPolicyConfig,
                                                  OnPolicyLearner, TrainState,
                                                  normal_entropy,
                                                  normal_log_prob)
from vision4leg_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class PPOConfig(OnPolicyConfig):
  clip_para: float = 0.2
  opt_epochs: int = 10
  clipped_value_loss: bool = False


class PPOLearner(OnPolicyLearner):

  # what the step's graphs share across update_per_epoch calls
  _capture_stream = None

  def _step_graphs(self, dev: torch.device):
    """On one CUDA device the step is replayed as a CUDA graph
    (algo/step_graph.py); on the CPU, or under a sharded mesh (whose
    all-reduces the host makes), it runs eagerly."""
    if dev.type != "cuda" or self.mesh.sharded:
      return None
    if self._capture_stream is None:
      self._capture_stream = step_graph.CaptureStream(dev)
    return step_graph.StepGraphs(self._capture_stream,
                                 {"vf_opt": self.vf_tx, "pf_opt": self.pf_tx})

  def _minibatch_update(self, ts: TrainState, batch):
    if self._graphs is None:
      return self._step(ts, batch)
    return self._graphs.step(self._step, ts, batch)

  def _step(self, ts: TrainState, batch):
    cfg = self.cfg
    obs, acts, advs, est_rets, old_values, old_logp, _, _ = batch
    module = ts.params

    # --- critic first (ppo.py:152) ---
    with profiling.span("v4l.learner.vf_forward"):
      # per-minibatch advantage normalization (ppo.py:148)
      advs = self.normalize_advantages(advs)
      values = self.apply_v(module, obs)
      if cfg.clipped_value_loss:
        clipped = old_values + torch.clamp(values - old_values,
                                           -cfg.clip_para, cfg.clip_para)
        vf_loss = 0.5 * torch.maximum((values - est_rets) ** 2,
                                      (clipped - est_rets) ** 2).mean()
      else:
        vf_loss = torch.mean((values - est_rets) ** 2)
    with profiling.span("v4l.learner.vf_backward"):
      grads = torch.autograd.grad(vf_loss, self.vf_tx.params,
                                  allow_unused=True)
    vf_opt = self.vf_tx.update(grads, ts.vf_opt)

    # --- actor on the updated params (ppo.py:153) ---
    with profiling.span("v4l.learner.pf_forward"):
      mean, std, logstd = self.apply_pi(module, obs)
      log_prob = normal_log_prob(mean, std, acts)
      ent = normal_entropy(std)
      ratio = torch.exp(log_prob - old_logp)
      surr = ratio * advs
      surr_clip = torch.clamp(ratio, 1.0 - cfg.clip_para,
                              1.0 + cfg.clip_para) * advs
      pf_loss = -torch.mean(torch.minimum(surr, surr_clip))
      pf_loss = pf_loss - cfg.entropy_coeff * ent.mean()
    with profiling.span("v4l.learner.pf_backward"):
      grads = torch.autograd.grad(pf_loss, self.pf_tx.params,
                                  allow_unused=True)
    pf_opt = self.pf_tx.update(grads, ts.pf_opt)

    with profiling.span("v4l.learner.metrics"):
      metrics = {
          "Training/policy_loss": pf_loss.detach(),
          "Training/vf_loss": vf_loss.detach(),
          "logprob/mean": log_prob.detach().mean(),
          "log_std/mean": logstd.detach().mean(),
          "ratio/max": ratio.detach().max(),
          "ratio/min": ratio.detach().min(),
      }
    return ts.replace(pf_opt=pf_opt, vf_opt=vf_opt), metrics
