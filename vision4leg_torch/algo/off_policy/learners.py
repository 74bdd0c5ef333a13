"""Off-policy learners: the SAC family, TD3, DDPG and the DQN family (torch
mirror of vision4leg_tpu.algo.off_policy.learners; reference
torchrl/algo/off_policy/*.py).

Each learner's `update(state, batch, gen=None, draws=None) -> (state,
metrics)` takes one replay batch (obs, acts, rewards, next_obs,
terminals), every gradient at the parameters the JAX learner takes it
at, then the Adam steps (optax.adam: eps 1e-8, no clipping) and the
target updates (soft every step, or a hard copy on a period:
algo/utils.py:16-26, off_rl_algo.py:38-52).  The networks are modules
updated in place; their target copies are modules of their own.

The learners' Gaussian draws come from `gen` (a generator on the batch's
device) or are given in `draws`: SAC's "noise" (and TwinSACQ's
"next_noise" for the next observations), TD3's target "noise", each
standard normal of the batch's (B, action_dim).

All continuous-control learners act in tanh-squashed [-1, 1] space (the
reference pairs them with the NormAct wrapper).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict

import torch

from vision4leg_torch.algo.on_policy_base import Adam, AdamState
from vision4leg_torch.models import distributions as tanh_normal


@dataclasses.dataclass(frozen=True)
class OffPolicyConfig:
  plr: float = 3e-4
  qlr: float = 3e-4
  discount: float = 0.99
  batch_size: int = 256
  # target updates (off_rl_algo.py:27-31)
  use_soft_update: bool = True
  tau: float = 0.001
  target_hard_update_period: int = 1000
  opt_times: int = 1
  # SAC
  automatic_entropy_tuning: bool = True
  target_entropy: float | None = None
  policy_std_reg_weight: float = 1e-3
  policy_mean_reg_weight: float = 1e-3
  # TD3 (td3.py)
  policy_update_delay: int = 2
  norm_std_policy: float = 0.2
  noise_clip: float = 0.5
  grad_clip: float | None = None
  # DQN
  epsilon: float = 0.05
  num_quantiles: int = 32    # QRDQN
  num_heads: int = 10        # BootstrappedDQN


@dataclasses.dataclass
class OffPolicyState:
  params: Dict[str, torch.nn.Module]         # the online networks
  target_params: Dict[str, torch.nn.Module]  # their target copies
  opt_states: Dict[str, AdamState]
  extras: Any                                # log_alpha + its Adam state
  update_count: int

  def replace(self, **kw) -> "OffPolicyState":
    return dataclasses.replace(self, **kw)


def _target(module):
  t = copy.deepcopy(module)
  t.requires_grad_(False)
  return t


@torch.no_grad()
def soft_update(target: torch.nn.Module, online: torch.nn.Module,
                tau: float):
  """target <- (1 - tau) target + tau online, in place."""
  for t, o in zip(target.parameters(), online.parameters()):
    t.mul_(1 - tau).add_(o, alpha=tau)


@torch.no_grad()
def maybe_update_targets(cfg: OffPolicyConfig, state: OffPolicyState,
                         keys, gate: bool = True) -> OffPolicyState:
  """A soft update every step, or a hard copy when update_count divides by
  target_hard_update_period (rl_algo.py:173-186); nothing when `gate` is
  False (TD3 touches its targets only in the delayed policy branch,
  td3.py:143)."""
  if not gate:
    return state
  for k in keys:
    if cfg.use_soft_update:
      soft_update(state.target_params[k], state.params[k], cfg.tau)
    elif state.update_count % cfg.target_hard_update_period == 0:
      for t, o in zip(state.target_params[k].parameters(),
                      state.params[k].parameters()):
        t.copy_(o)
  return state


def _params(module):
  return list(module.parameters())


def _grads(loss, module):
  return torch.autograd.grad(loss, _params(module), allow_unused=True)


def _draw(draws, name, like, gen):
  return tanh_normal.standard_normal(
      like, gen, None if draws is None else draws.get(name))


class _Learner:
  """The Adam optimizers of the networks in `state.params` (built by
  init_state), applied in place."""

  def _make_state(self, params, target_keys, lrs, extras=None):
    self.tx = {k: Adam(_params(m), lrs[k]) for k, m in params.items()}
    return OffPolicyState(
        params=params,
        target_params={k: _target(params[k]) for k in target_keys},
        opt_states={k: tx.init() for k, tx in self.tx.items()},
        extras=extras, update_count=0)

  def _step(self, state, grads) -> Dict[str, AdamState]:
    opts = dict(state.opt_states)
    for name, g in grads.items():
      opts[name] = self.tx[name].update(g, opts[name])
    return opts

  def _alpha_init(self, like):
    log_alpha = torch.zeros((), dtype=like.dtype, device=like.device)
    self.alpha_tx = Adam([log_alpha], self.cfg.plr)
    return {"log_alpha": log_alpha, "alpha_opt": self.alpha_tx.init()}

  def _alpha_step(self, state, log_probs):
    """One Adam step of log_alpha on -(log_alpha (logp + H)).mean()."""
    a_grad = -(log_probs.detach() + self.target_entropy).mean()
    opt = self.alpha_tx.update([a_grad], state.extras["alpha_opt"])
    return {"log_alpha": state.extras["log_alpha"], "alpha_opt": opt}


class TwinSACQLearner(_Learner):
  """Twin SAC without V (twin_sac_q.py:10-215)."""

  def __init__(self, cfg: OffPolicyConfig, apply_pf: Callable,
               apply_qf: Callable, action_dim: int):
    self.cfg = cfg
    self.apply_pf = apply_pf    # (module, obs) -> (mean, std, logstd)
    self.apply_qf = apply_qf    # (module, obs, act) -> (B, 1)
    self.target_entropy = (cfg.target_entropy if cfg.target_entropy
                           is not None else -float(action_dim))

  def init_state(self, pf, qf1, qf2) -> OffPolicyState:
    p = next(pf.parameters())
    return self._make_state(
        {"pf": pf, "qf1": qf1, "qf2": qf2}, ("qf1", "qf2"),
        {"pf": self.cfg.plr, "qf1": self.cfg.qlr, "qf2": self.cfg.qlr},
        self._alpha_init(p))

  def update(self, state: OffPolicyState, batch, gen=None, draws=None):
    cfg = self.cfg
    obs, acts = batch["obs"], batch["acts"]
    next_obs = batch["next_obs"]
    rewards, terminals = batch["rewards"], batch["terminals"]
    p = state.params

    mean, std, logstd = self.apply_pf(p["pf"], obs)
    noise = _draw(draws, "noise", mean, gen)
    _, _, log_probs = tanh_normal.sample_with_log_prob(mean, std,
                                                       noise=noise)
    # alpha (twin_sac_q.py:113-121)
    if cfg.automatic_entropy_tuning:
      extras = self._alpha_step(state, log_probs)
      alpha = torch.exp(extras["log_alpha"]).detach()
    else:
      alpha, extras = 1.0, state.extras

    # targets (twin_sac_q.py:125-143)
    with torch.no_grad():
      t_mean, t_std, _ = self.apply_pf(p["pf"], next_obs)
      t_act, _, t_logp = tanh_normal.sample_with_log_prob(
          t_mean, t_std, noise=_draw(draws, "next_noise", t_mean, gen))
      tq = torch.minimum(
          self.apply_qf(state.target_params["qf1"], next_obs, t_act),
          self.apply_qf(state.target_params["qf2"], next_obs, t_act))
      q_target = rewards + (1.0 - terminals) * cfg.discount * (
          tq - alpha * t_logp)

    q1_loss = torch.mean((self.apply_qf(p["qf1"], obs, acts)
                          - q_target) ** 2)
    q2_loss = torch.mean((self.apply_qf(p["qf2"], obs, acts)
                          - q_target) ** 2)
    new_act, _, logp = tanh_normal.sample_with_log_prob(mean, std,
                                                        noise=noise)
    q_new = torch.minimum(self.apply_qf(p["qf1"], obs, new_act),
                          self.apply_qf(p["qf2"], obs, new_act))
    pf_loss = (alpha * logp - q_new).mean()
    pf_loss = pf_loss + cfg.policy_std_reg_weight * (logstd ** 2).mean()
    pf_loss = pf_loss + cfg.policy_mean_reg_weight * (mean ** 2).mean()
    grads = {"pf": _grads(pf_loss, p["pf"]),
             "qf1": _grads(q1_loss, p["qf1"]),
             "qf2": _grads(q2_loss, p["qf2"])}
    state = state.replace(opt_states=self._step(state, grads),
                          extras=extras,
                          update_count=state.update_count + 1)
    state = maybe_update_targets(cfg, state, ("qf1", "qf2"))
    metrics = {
        "Training/policy_loss": pf_loss.detach(),
        "Training/qf1_loss": q1_loss.detach(),
        "Training/qf2_loss": q2_loss.detach(),
        "Alpha": (alpha if cfg.automatic_entropy_tuning
                  else torch.ones((), device=obs.device)),
        "log_probs/mean": log_probs.detach().mean(),
        "Reward_Mean": rewards.mean(),
    }
    return state, metrics


class TD3Learner(_Learner):
  """TD3 (td3.py:10-180): twin critics, target policy smoothing, delayed
  deterministic actor updates."""

  def __init__(self, cfg: OffPolicyConfig, apply_pf: Callable,
               apply_qf: Callable):
    self.cfg = cfg
    self.apply_pf = apply_pf   # (module, obs) -> tanh action
    self.apply_qf = apply_qf

  def init_state(self, pf, qf1, qf2) -> OffPolicyState:
    return self._make_state(
        {"pf": pf, "qf1": qf1, "qf2": qf2}, ("pf", "qf1", "qf2"),
        {"pf": self.cfg.plr, "qf1": self.cfg.qlr, "qf2": self.cfg.qlr})

  def update(self, state: OffPolicyState, batch, gen=None, draws=None):
    cfg = self.cfg
    obs, acts = batch["obs"], batch["acts"]
    next_obs = batch["next_obs"]
    rewards, terminals = batch["rewards"], batch["terminals"]
    p = state.params

    with torch.no_grad():
      t_act = self.apply_pf(state.target_params["pf"], next_obs)
      noise = torch.clamp(
          cfg.norm_std_policy * _draw(draws, "noise", t_act, gen),
          -cfg.noise_clip, cfg.noise_clip)
      t_act = torch.clamp(t_act + noise, -1.0, 1.0)
      tq = torch.minimum(
          self.apply_qf(state.target_params["qf1"], next_obs, t_act),
          self.apply_qf(state.target_params["qf2"], next_obs, t_act))
      q_target = rewards + (1.0 - terminals) * cfg.discount * tq

    q1_loss = torch.mean((self.apply_qf(p["qf1"], obs, acts)
                          - q_target) ** 2)
    q2_loss = torch.mean((self.apply_qf(p["qf2"], obs, acts)
                          - q_target) ** 2)
    opts = self._step(state, {"qf1": _grads(q1_loss, p["qf1"]),
                              "qf2": _grads(q2_loss, p["qf2"])})

    # delayed policy update on the updated critic (td3.py:58+124: the
    # count increments before the `num % policy_update_delay` check, so
    # the first update steps the policy and every delay-th one skips it)
    count = state.update_count + 1
    do_pf = (count % cfg.policy_update_delay) != 0
    pf_loss = -self.apply_qf(p["qf1"], obs, self.apply_pf(p["pf"], obs)
                             ).mean()
    if do_pf:
      opts["pf"] = self.tx["pf"].update(_grads(pf_loss, p["pf"]),
                                        opts["pf"])
    state = state.replace(opt_states=opts, update_count=count)
    # the targets move only when the policy stepped (td3.py:143)
    state = maybe_update_targets(cfg, state, ("pf", "qf1", "qf2"),
                                 gate=do_pf)
    return state, {
        "Training/policy_loss": pf_loss.detach(),
        "Training/qf1_loss": q1_loss.detach(),
        "Training/qf2_loss": q2_loss.detach(),
        "Reward_Mean": rewards.mean(),
    }


class DDPGLearner(_Learner):
  """DDPG (ddpg.py): a single critic, a deterministic actor."""

  def __init__(self, cfg: OffPolicyConfig, apply_pf, apply_qf):
    self.cfg = cfg
    self.apply_pf = apply_pf
    self.apply_qf = apply_qf

  def init_state(self, pf, qf) -> OffPolicyState:
    return self._make_state({"pf": pf, "qf": qf}, ("pf", "qf"),
                            {"pf": self.cfg.plr, "qf": self.cfg.qlr})

  def update(self, state: OffPolicyState, batch, gen=None, draws=None):
    del gen, draws
    cfg = self.cfg
    obs, acts = batch["obs"], batch["acts"]
    next_obs = batch["next_obs"]
    rewards, terminals = batch["rewards"], batch["terminals"]
    p = state.params
    with torch.no_grad():
      t_act = self.apply_pf(state.target_params["pf"], next_obs)
      tq = self.apply_qf(state.target_params["qf"], next_obs, t_act)
      q_target = rewards + (1.0 - terminals) * cfg.discount * tq
    qf_loss = torch.mean((self.apply_qf(p["qf"], obs, acts)
                          - q_target) ** 2)
    pf_loss = -self.apply_qf(p["qf"], obs, self.apply_pf(p["pf"], obs)
                             ).mean()
    grads = {"qf": _grads(qf_loss, p["qf"]), "pf": _grads(pf_loss, p["pf"])}
    state = state.replace(opt_states=self._step(state, grads),
                          update_count=state.update_count + 1)
    state = maybe_update_targets(cfg, state, ("pf", "qf"))
    return state, {"Training/policy_loss": pf_loss.detach(),
                   "Training/qf_loss": qf_loss.detach(),
                   "Reward_Mean": rewards.mean()}


class DQNLearner(_Learner):
  """DQN (dqn.py) / QRDQN (qrdqn.py) / Bootstrapped DQN
  (bootstrapped_dqn.py), by `mode`: the network's output is (B, A),
  (B, A, Q) or (B, K, A)."""

  def __init__(self, cfg: OffPolicyConfig, apply_qf, mode: str = "dqn"):
    if mode not in ("dqn", "qrdqn", "bootstrapped"):
      raise ValueError(f"DQNLearner: unknown mode {mode!r}")
    self.cfg = cfg
    self.apply_qf = apply_qf
    self.mode = mode

  def init_state(self, qf) -> OffPolicyState:
    return self._make_state({"qf": qf}, ("qf",), {"qf": self.cfg.qlr})

  def _loss(self, q, tq, acts, rewards, terminals, masks):
    cfg = self.cfg
    if self.mode == "dqn":
      target = rewards[:, 0] + (1 - terminals[:, 0]) * cfg.discount * (
          tq.amax(dim=-1))
      pred = torch.gather(q, -1, acts[:, None])[:, 0]
      return torch.mean((pred - target) ** 2)
    if self.mode == "bootstrapped":
      # per-head TD loss weighted by the bootstrap masks stored at
      # collection, (mse * masks).mean() (bootstrapped_dqn.py:73-90)
      target = rewards[:, None, 0:1] + (
          1 - terminals[:, None, 0:1]) * cfg.discount * tq.amax(
              dim=-1, keepdim=True)
      pred = torch.gather(q, -1, acts[:, None, None].expand(
          -1, q.shape[1], 1))
      mse = (pred - target) ** 2
      if masks is not None:
        mse = mse * masks.reshape(mse.shape[0], mse.shape[1], 1)
      return torch.mean(mse)
    # QRDQN (qrdqn.py:23+): quantile regression Huber loss, the full mean
    # over (B, Q, Q') (utils.py:5-9)
    nq = cfg.num_quantiles
    taus = (torch.arange(nq, dtype=q.dtype, device=q.device) + 0.5) / nq
    next_best = torch.argmax(tq.mean(dim=-1), dim=-1)
    t_quant = torch.gather(tq, 1, next_best[:, None, None].expand(
        -1, 1, nq))[:, 0]
    target = rewards + (1 - terminals) * cfg.discount * t_quant
    pred = torch.gather(q, 1, acts[:, None, None].expand(-1, 1, nq))[:, 0]
    u = target[:, None, :] - pred[:, :, None]
    huber = torch.where(u.abs() <= 1.0, 0.5 * u ** 2, u.abs() - 0.5)
    weight = torch.abs(taus[None, :, None] - (u < 0).to(q.dtype))
    return torch.mean(weight * huber)

  def update(self, state: OffPolicyState, batch, gen=None, draws=None):
    del gen, draws
    acts = batch["acts"].long().reshape(-1)
    with torch.no_grad():
      tq = self.apply_qf(state.target_params["qf"], batch["next_obs"])
    q = self.apply_qf(state.params["qf"], batch["obs"])
    qf_loss = self._loss(q, tq, acts, batch["rewards"], batch["terminals"],
                         batch.get("masks"))
    grads = {"qf": _grads(qf_loss, state.params["qf"])}
    state = state.replace(opt_states=self._step(state, grads),
                          update_count=state.update_count + 1)
    state = maybe_update_targets(self.cfg, state, ("qf",))
    return state, {"Training/qf_loss": qf_loss.detach(),
                   "Reward_Mean": batch["rewards"].mean()}


class SACLearner(_Learner):
  """Original SAC with a state-value function (sac.py:10-180): a V target
  network, Q + V + policy updates, optional entropy tuning; twin=True is
  TwinSAC (twin_sac.py): the min over two Qs."""

  def __init__(self, cfg: OffPolicyConfig, apply_pf: Callable,
               apply_qf: Callable, apply_vf: Callable, action_dim: int,
               twin: bool = False):
    self.cfg = cfg
    self.apply_pf = apply_pf
    self.apply_qf = apply_qf   # (module, obs, act) -> (B, 1)
    self.apply_vf = apply_vf   # (module, obs) -> (B, 1)
    self.twin = twin
    self.target_entropy = (cfg.target_entropy if cfg.target_entropy
                           is not None else -float(action_dim))

  def init_state(self, pf, qf, vf, qf2=None) -> OffPolicyState:
    params = {"pf": pf, "qf": qf, "vf": vf}
    lrs = {"pf": self.cfg.plr, "qf": self.cfg.qlr, "vf": self.cfg.qlr}
    if self.twin:
      params["qf2"], lrs["qf2"] = qf2, self.cfg.qlr
    return self._make_state(params, ("vf",), lrs,
                            self._alpha_init(next(pf.parameters())))

  def _q_min(self, p, obs, act):
    q = self.apply_qf(p["qf"], obs, act)
    if self.twin:
      q = torch.minimum(q, self.apply_qf(p["qf2"], obs, act))
    return q

  def update(self, state: OffPolicyState, batch, gen=None, draws=None):
    cfg = self.cfg
    obs, acts = batch["obs"], batch["acts"]
    next_obs = batch["next_obs"]
    rewards, terminals = batch["rewards"], batch["terminals"]
    p = state.params

    mean, std, logstd = self.apply_pf(p["pf"], obs)
    noise = _draw(draws, "noise", mean, gen)
    new_actions, _, log_probs = tanh_normal.sample_with_log_prob(
        mean, std, noise=noise)
    if cfg.automatic_entropy_tuning:
      extras = self._alpha_step(state, log_probs)
      alpha = torch.exp(extras["log_alpha"]).detach()
    else:
      alpha, extras = 1.0, state.extras

    with torch.no_grad():
      # the Q target from the V target network (sac.py:121-125)
      target_v = self.apply_vf(state.target_params["vf"], next_obs)
      q_target = rewards + (1.0 - terminals) * cfg.discount * target_v
      # V <- Q(s, a_new) - alpha logp (sac.py:127-133)
      v_target = self._q_min(p, obs, new_actions) - alpha * log_probs
    grads = {}
    qf_loss = torch.mean((self.apply_qf(p["qf"], obs, acts)
                          - q_target) ** 2)
    grads["qf"] = _grads(qf_loss, p["qf"])
    if self.twin:
      qf2_loss = torch.mean((self.apply_qf(p["qf2"], obs, acts)
                             - q_target) ** 2)
      grads["qf2"] = _grads(qf2_loss, p["qf2"])
    vf_loss = torch.mean((self.apply_vf(p["vf"], obs) - v_target) ** 2)
    grads["vf"] = _grads(vf_loss, p["vf"])
    # the reparameterized policy loss (sac.py:135-150)
    q = self._q_min(p, obs, new_actions)
    pf_loss = (alpha * log_probs - q).mean()
    pf_loss = pf_loss + cfg.policy_std_reg_weight * (logstd ** 2).mean()
    pf_loss = pf_loss + cfg.policy_mean_reg_weight * (mean ** 2).mean()
    grads["pf"] = _grads(pf_loss, p["pf"])

    state = state.replace(opt_states=self._step(state, grads),
                          extras=extras,
                          update_count=state.update_count + 1)
    state = maybe_update_targets(cfg, state, ("vf",))
    metrics = {
        "Training/policy_loss": pf_loss.detach(),
        "Training/qf_loss": qf_loss.detach(),
        "Training/vf_loss": vf_loss.detach(),
        "log_probs/mean": log_probs.detach().mean(),
        "Reward_Mean": rewards.mean(),
    }
    if cfg.automatic_entropy_tuning:
      metrics["Alpha"] = alpha
    return state, metrics
