"""Timestep-driven off-policy training loop (torch mirror of
vision4leg_tpu.algo.off_policy.agent; reference torchrl/algo/off_policy/
off_rl_algo.py, the OffRLAlgo machinery).

Pretrain frames of random exploration, then per timestep {step the envs
-> write to the replay -> `updates_per_step` gradient updates on uniform
replay samples}, with the learner's target updates.  The replay ring
lives on the agent's device (data/replay.py).  The JAX package compiles
an epoch into one lax.scan; here the loop is plain Python over device
tensors, and the env steps through its `step_batch` (on the flat
terrains, one window-kernel launch a step).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from vision4leg_torch import resolve_device
from vision4leg_torch.collector.rollout import _scatter
from vision4leg_torch.data import replay as replay_lib


@dataclasses.dataclass
class OffPolicyCollectorState:
  env_states: Any
  raw_obs: torch.Tensor          # (E, D)
  ep_steps: torch.Tensor         # (E,) int32
  replay: replay_lib.ReplayBuffer
  total_frames: int


def _seeds(seed: int, n: int):
  return [int(s) for s in
          np.random.SeedSequence(seed).generate_state(n, np.uint64) >> 1]


class OffPolicyAgent:
  """Batched envs + the device replay + any off-policy learner
  (TwinSACQ/TD3/DDPG/SAC).  apply_pf(pf_module, obs) -> (mean, std, _):
  the acting path squashes tanh(mean + std n) (a deterministic policy is
  adapted to it, as tests/test_off_policy_learning.py does).  Draws come
  from one generator on the agent's device, seeded by `seed`."""

  def __init__(self, env, learner, learner_state, apply_pf: Callable,
               num_envs: int, replay_capacity: int, seed: int,
               pretrain_frames: int = 1000, max_episode_frames: int = 999,
               updates_per_step: int = 1, device=None):
    self.device = resolve_device(device)
    if env.device != self.device:
      raise ValueError(f"OffPolicyAgent: env on {env.device}, agent on "
                       f"{self.device}")
    self.env = env
    self.learner = learner
    self.apply_pf = apply_pf
    self.num_envs = num_envs
    self.pretrain_frames = pretrain_frames
    self.max_episode_frames = max_episode_frames
    self.updates_per_step = updates_per_step
    self.learner_state = learner_state

    s_env, s_upd = _seeds(seed, 2)
    self.gen = torch.Generator(device=self.device).manual_seed(s_env)
    self.update_gen = torch.Generator(device=self.device).manual_seed(s_upd)
    env_states, raw_obs = env.reset(num_envs, self.gen)
    A = env.cfg.action_dim
    example = {
        "obs": raw_obs[0],
        "acts": torch.zeros(A, device=self.device),
        "rewards": torch.zeros(1, device=self.device),
        "next_obs": raw_obs[0],
        "terminals": torch.zeros(1, device=self.device),
    }
    self.collector_state = OffPolicyCollectorState(
        env_states=env_states, raw_obs=raw_obs,
        ep_steps=torch.zeros(num_envs, dtype=torch.int32,
                             device=self.device),
        replay=replay_lib.init_replay(replay_capacity, example),
        total_frames=0)
    self._lo = env.action_low
    self._hi = env.action_high

  # ------------------------------------------------------------------
  @torch.no_grad()
  def _env_step(self, cs: OffPolicyCollectorState, pf,
                random_actions: bool):
    """One batched env transition; returns (cs, the replay batch)."""
    E, A = self.num_envs, self.env.cfg.action_dim
    if random_actions:
      act = 2.0 * torch.rand(E, A, generator=self.gen,
                             device=self.device) - 1.0
    else:
      mean, std, _ = self.apply_pf(pf, cs.raw_obs)
      act = torch.tanh(mean + std * torch.randn(
          mean.shape, generator=self.gen, dtype=mean.dtype,
          device=mean.device))
    env_act = self._lo + (act + 1.0) * 0.5 * (self._hi - self._lo)
    env_states, next_obs, rew, done, _ = self.env.step_batch(
        cs.env_states, env_act, self.gen)
    ep_steps = cs.ep_steps + 1
    terminal = done | (ep_steps >= self.max_episode_frames)
    # time-limit ends do not mark terminal for the bootstrap
    # (off_rl_algo.py time_limit handling)
    batch = {"obs": cs.raw_obs, "acts": act, "rewards": rew[:, None],
             "next_obs": next_obs, "terminals": done.float()[:, None]}
    if bool(terminal.any()):
      idx = torch.nonzero(terminal)[:, 0]
      reset_states, reset_obs = self.env.reset(int(idx.numel()), self.gen)
      env_states = _scatter(env_states, reset_states, idx)
      next_obs = next_obs.index_copy(0, idx, reset_obs)
    ep_steps = torch.where(terminal, 0, ep_steps).to(torch.int32)
    replay = replay_lib.add_batch(cs.replay, batch)
    return dataclasses.replace(
        cs, env_states=env_states, raw_obs=next_obs, ep_steps=ep_steps,
        replay=replay, total_frames=cs.total_frames + E), batch

  # ------------------------------------------------------------------
  def pretrain(self):
    """Random-exploration warmup filling the replay (off_rl_algo.py
    pretrain): pretrain_frames // num_envs steps, at least one."""
    for _ in range(max(1, self.pretrain_frames // self.num_envs)):
      self.collector_state, _ = self._env_step(self.collector_state, None,
                                               random_actions=True)

  def train_epoch(self, epoch_frames: int):
    """Collect epoch_frames with the current policy, updating the learner
    `updates_per_step` times per env timestep (update_per_timestep).
    Returns (mean reward, the learner's metrics averaged) as floats."""
    steps = max(1, epoch_frames // self.num_envs)
    bs = self.learner.cfg.batch_size
    rews, infos = [], {}
    for _ in range(steps):
      self.collector_state, batch = self._env_step(
          self.collector_state, self.learner_state.params["pf"],
          random_actions=False)
      rews.append(batch["rewards"].mean())
      for _ in range(self.updates_per_step):
        sample = replay_lib.sample(self.collector_state.replay, bs,
                                   self.update_gen)
        self.learner_state, info = self.learner.update(
            self.learner_state, sample, self.update_gen)
        for k, v in info.items():
          infos.setdefault(k, []).append(torch.as_tensor(
              v, dtype=torch.float32, device=self.device).reshape(()))
    vals = torch.stack([torch.stack(rews).mean()]
                       + [torch.stack(v).mean() for v in infos.values()])
    vals = vals.cpu().tolist()
    return vals[0], dict(zip(infos, vals[1:]))

  @property
  def replay(self) -> replay_lib.ReplayBuffer:
    return self.collector_state.replay
