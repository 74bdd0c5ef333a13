"""On-device rollout collector (torch mirror of
vision4leg_tpu.collector.rollout).

Collection semantics of the reference's VecOnPolicyCollector
(torchrl/collector/on_policy.py:90-152):
  * the policy samples from Normal(mean, std); the value is evaluated on
    the normalized obs;
  * NormAct maps tanh(action) affinely into the env's action bounds
    (continuous_wrapper.py:19-22);
  * at `done or step >= max_episode_frames`: terminal := done | surpass,
    reward += discount * V(next_obs) * surpass (time-limit bootstrap,
    on_policy.py:128-143), then the finished envs are reset;
  * the obs normalizer updates on every step of training collection, on
    the proprio head only (NormObsWithImg, get_env.py:41-67).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from vision4leg_torch.data import normalizer as norm
from vision4leg_torch.parallel import mesh as mesh_lib
from vision4leg_torch.parallel.mesh import take_rows


class Transition(NamedTuple):
  obs: torch.Tensor          # (T, E, D) normalized obs fed to the policy
  acts: torch.Tensor         # (T, E, A) raw policy output (pre-NormAct)
  log_probs: torch.Tensor    # (T, E, 1)
  values: torch.Tensor       # (T, E, 1)
  rewards: torch.Tensor      # (T, E, 1)
  terminals: torch.Tensor    # (T, E, 1) bool
  time_limits: torch.Tensor  # (T, E, 1) bool
  means: torch.Tensor        # (T, E, A)
  stds: torch.Tensor         # (T, E, A)


@dataclasses.dataclass
class CollectorState:
  env_states: Any
  raw_obs: torch.Tensor      # (E, D)
  ep_steps: torch.Tensor     # (E,) int32
  ep_return: torch.Tensor    # (E,)
  normalizer: norm.NormalizerState
  finished_returns_sum: torch.Tensor
  finished_count: torch.Tensor
  finished_len_sum: torch.Tensor
  gen: torch.Generator       # env and action randomness

  def replace(self, **kw) -> "CollectorState":
    return dataclasses.replace(self, **kw)


def init_collector(env, num_envs: int, gen: torch.Generator,
                   mesh: mesh_lib.Mesh = mesh_lib.ONE) -> CollectorState:
  """Reset num_envs envs on the env's device; randomness from `gen` (a
  generator on that device).  Under a sharded `mesh`, the rank's part of
  them: the global reset's draws, its rows kept."""
  num_envs = mesh.local_envs(num_envs)
  env_states, raw_obs = env.reset_from(num_envs, mesh.own_rows(
      lambda n: env.draw_for_reset(n, gen), num_envs))
  dev = raw_obs.device
  zero = torch.zeros((), device=dev)
  return CollectorState(
      env_states=env_states, raw_obs=raw_obs,
      ep_steps=torch.zeros(num_envs, dtype=torch.int32, device=dev),
      ep_return=torch.zeros(num_envs, device=dev),
      normalizer=norm.init_normalizer(env.cfg.proprio_dim, dev),
      finished_returns_sum=zero.clone(), finished_count=zero.clone(),
      finished_len_sum=zero.clone(), gen=gen)


def make_rollout_fn(env, apply_pi_v: Callable, apply_v: Callable,
                    horizon: int, max_episode_frames: int, discount: float,
                    proprio_dim: int, obs_norm: bool = True,
                    action_low=None, action_high=None,
                    env_time_limit: int = 1000, reward_scale: float = 1.0,
                    act_fn: Callable = None, inference_dtype=None,
                    weights=None, mesh: mesh_lib.Mesh = mesh_lib.ONE):
  """Build `rollout(cs, max_ep=None) -> (cs, Transition, last_v)`.

  apply_pi_v(obs) -> ((mean, std, logstd), value) runs policy and value
  over one tokenization; apply_v(obs) -> (E, 1) serves the bootstraps.
  act_fn(obs, gen) -> (act, logp, env_act, mean, std) replaces the
  Gaussian sample + NormAct (the hierarchical collector's hook in the JAX
  package; tests feed pre-drawn noise through it).
  inference_dtype (torch.bfloat16): the collection forward in reduced
  precision (JAX rollout.py:105-139).  weights = (module, twin): apply_pi_v
  and apply_v run `twin`, whose weights are the float32 `module`'s cast
  down once per rollout; each observation is cast down, and (mean, std,
  value) come back in float32, so sampling, log-probs and the stored
  behaviour stats stay float32.  The PPO update stays float32.
  mesh (parallel.mesh.Mesh): `cs` holds this rank's envs; every draw is
  the global draw's rows for them, the partial resets' too (each rank
  learns how many envs every rank resets), and the normalizer merges the
  global batch's statistics.  The env steps and resets from given draws
  (`step_from`, `reset_from`).
  """
  if mesh.sharded and act_fn is not None:
    raise NotImplementedError("act_fn draws its own noise: no sharded "
                              "rollout takes it")

  def normalize(nstate, raw):
    if not obs_norm:
      return raw
    return norm.filt_with_img_tail(nstate, raw, proprio_dim)

  if inference_dtype is not None:
    _pi_v, _v = apply_pi_v, apply_v

    def apply_pi_v(x):  # noqa: F811 (the reduced-precision forward)
      (mean, std, logstd), value = _pi_v(x.to(inference_dtype))
      return (mean.float(), std.float(), logstd.float()), value.float()

    def apply_v(x):  # noqa: F811
      return _v(x.to(inference_dtype)).float()

  @torch.no_grad()
  def step_fn(cs: CollectorState, max_ep: int):
    nstate = cs.normalizer
    if obs_norm:
      nstate = norm.update(nstate, cs.raw_obs[..., :proprio_dim], mesh)
    obs = normalize(nstate, cs.raw_obs)

    if act_fn is not None:
      act, log_prob, env_act, mean, std = act_fn(obs, cs.gen)
      value = apply_v(obs)
    else:
      (mean, std, _), value = apply_pi_v(obs)
      noise = mesh.own_rows(lambda n: torch.randn(
          (n,) + mean.shape[1:], generator=cs.gen, device=mean.device),
          mean.shape[0])
      act = mean + std * noise
      log_prob = torch.sum(
          -0.5 * noise ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi),
          dim=-1, keepdim=True)
      env_act = action_low + (torch.tanh(act) + 1.0) * 0.5 * (
          action_high - action_low)

    env_states, next_raw, rew, done, _ = env.step_from(
        cs.env_states, env_act, mesh.own_rows(
            lambda n: env.draw_for_step(n, cs.env_states, cs.gen),
            env_act.shape[0]))
    rew = rew * reward_scale
    ep_steps = cs.ep_steps + 1
    tl_done = ep_steps >= env_time_limit
    done = done | tl_done
    surpass = ep_steps >= max_ep
    terminal = done | surpass
    ep_return = cs.ep_return + rew
    if bool(surpass.any()):
      last_value = apply_v(normalize(nstate, next_raw))[..., 0]
      rew = rew + discount * last_value * surpass
    fin_sum = cs.finished_returns_sum + torch.sum(ep_return * terminal)
    fin_cnt = cs.finished_count + torch.sum(terminal)
    fin_len = cs.finished_len_sum + torch.sum(ep_steps.float() * terminal)

    # reset only the finished envs (the global reset's rows of this
    # rank's), then scatter them into the batch
    counts = [int(c) for c in
              mesh.all_gather(terminal.sum().reshape(1)).reshape(-1)]
    mine, total = counts[mesh.rank], sum(counts)
    if total:
      draws = take_rows(env.draw_for_reset(total, cs.gen),
                        sum(counts[:mesh.rank]), mine, total)
      if mine:
        idx = torch.nonzero(terminal)[:, 0]
        reset_states, reset_obs = env.reset_from(mine, draws)
        env_states = _scatter(env_states, reset_states, idx)
        next_raw = next_raw.index_copy(0, idx, reset_obs)
    ep_steps = torch.where(terminal, 0, ep_steps).to(torch.int32)
    ep_return = torch.where(terminal, 0.0, ep_return)

    cs = cs.replace(env_states=env_states, raw_obs=next_raw,
                    ep_steps=ep_steps, ep_return=ep_return,
                    normalizer=nstate, finished_returns_sum=fin_sum,
                    finished_count=fin_cnt, finished_len_sum=fin_len)
    tr = Transition(obs=obs, acts=act, log_probs=log_prob, values=value,
                    rewards=rew[..., None], terminals=terminal[..., None],
                    time_limits=tl_done[..., None], means=mean, stds=std)
    return cs, tr

  @torch.no_grad()
  def rollout(cs: CollectorState, max_ep: int | None = None):
    if max_ep is None:
      max_ep = max_episode_frames
    if inference_dtype is not None:
      module, twin = weights
      twin.load_state_dict(module.state_dict())   # cast down once
    trs = []
    for _ in range(horizon):
      cs, tr = step_fn(cs, max_ep)
      trs.append(tr)
    traj = Transition(*(torch.stack(x) for x in zip(*trs)))
    obs = normalize(cs.normalizer, cs.raw_obs)
    last_value = apply_v(obs)[..., 0] * (1.0 - traj.terminals[-1, :, 0].float())
    return cs, traj, last_value

  return rollout


def _scatter(full, part, idx):
  """`full` with rows idx replaced by `part` (dataclass pytrees whose
  tensors all lead with the env axis)."""
  if isinstance(full, torch.Tensor):
    return full.index_copy(0, idx, part)
  return type(full)(**{f.name: _scatter(getattr(full, f.name),
                                        getattr(part, f.name), idx)
                       for f in dataclasses.fields(full)})
