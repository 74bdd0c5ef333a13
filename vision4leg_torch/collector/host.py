"""Host-environment collector: gymnasium envs with batched inference on
the card (torch mirror of vision4leg_tpu.collector.host).

Reference: torchrl/env/get_env.py (the plain-gym entry) + SubProcVecEnv +
VecOnPolicyCollector, for environments that cannot live on the device.
The envs step in worker processes (gymnasium.vector.AsyncVectorEnv) or in
this one (SyncVectorEnv); the policy runs as one batched forward per
vector step, one exchange with the device a step.  It produces the same
`Transition` as the on-device rollout, so every learner takes either.

gymnasium is imported inside `make_vec_env`: the rest of the port never
needs it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from vision4leg_torch import resolve_device
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.data import normalizer as norm


def make_vec_env(env_id: str, num_envs: int, seed: int = 0,
                 asynchronous: bool = True, wrappers=()):
  """get_vec_env / get_subprocvec_env for gymnasium ids; env i is reset
  with seed * num_envs + i (vecenv.py:64-68)."""
  try:
    import gymnasium
  except ImportError as e:
    raise ImportError("vision4leg_torch.collector.host.make_vec_env "
                      "requires gymnasium") from e

  def thunk(i):
    def f():
      env = gymnasium.make(env_id)
      for w in wrappers:
        env = w(env)
      env.reset(seed=seed * num_envs + i)
      return env
    return f

  cls = (gymnasium.vector.AsyncVectorEnv if asynchronous
         else gymnasium.vector.SyncVectorEnv)
  return cls([thunk(i) for i in range(num_envs)])


class HostOnPolicyCollector:
  """Collect (T, E, ...) trajectories from host envs with device inference.

  apply_pi(obs) -> (mean, std, logstd) and apply_v(obs) -> (B, 1) run on
  `device` (the card unless the caller asks for another).  Continuous
  actions map through NormAct (tanh + rescale); a discrete space takes the
  argmax of the mean.  The action noise is drawn from a generator on the
  device seeded by `seed`, or taken from `noise_fn(step) -> (E, A)`."""

  def __init__(self, vec_env, apply_pi: Callable, apply_v: Callable,
               discount: float = 0.99, max_episode_frames: int = 999,
               obs_norm: bool = True, seed: int = 0, device=None,
               noise_fn: Optional[Callable] = None):
    self.device = resolve_device(device)
    self.env = vec_env
    self.num_envs = vec_env.num_envs
    space = vec_env.single_action_space
    self.discrete = hasattr(space, "n")
    if not self.discrete:
      self.act_low = np.asarray(space.low)
      self.act_high = np.asarray(space.high)
    self.apply_pi, self.apply_v = apply_pi, apply_v
    self.discount = discount
    self.max_episode_frames = max_episode_frames
    self.obs_norm = obs_norm
    obs_dim = int(np.prod(vec_env.single_observation_space.shape))
    self.normalizer = norm.init_normalizer(obs_dim, self.device)
    self.gen = torch.Generator(device=self.device).manual_seed(seed)
    self.noise_fn = noise_fn
    self.steps = 0
    obs, _ = vec_env.reset(seed=seed)
    self.raw_obs = obs.reshape(self.num_envs, -1)
    self.ep_steps = np.zeros(self.num_envs, np.int32)
    self.train_rews = []
    self._ep_rew = np.zeros(self.num_envs)

  def _normalize(self, raw):
    x = torch.as_tensor(np.asarray(raw, np.float32), device=self.device)
    if not self.obs_norm:
      return x
    self.normalizer = norm.update(self.normalizer, x)
    return norm.filt(self.normalizer, x)

  @torch.no_grad()
  def _act(self, obs):
    mean, std, _ = self.apply_pi(obs)
    if self.noise_fn is not None:
      noise = torch.tensor(np.asarray(self.noise_fn(self.steps)),
                           dtype=mean.dtype, device=mean.device)
    else:
      noise = torch.randn(mean.shape, generator=self.gen, dtype=mean.dtype,
                          device=mean.device)
    act = mean + std * noise
    logp = torch.sum(-0.5 * noise ** 2 - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), dim=-1, keepdim=True)
    return act, logp, self.apply_v(obs), mean, std

  @torch.no_grad()
  def collect(self, horizon: int):
    """One epoch of (horizon, E, ...) data and the bootstrap value."""
    store = {k: [] for k in Transition._fields}
    for _ in range(horizon):
      obs = self._normalize(self.raw_obs)
      act, logp, value, mean, std = (x.cpu().numpy() for x in
                                     self._act(obs))
      self.steps += 1
      if self.discrete:
        env_act = np.argmax(mean, axis=-1)
      else:
        env_act = self.act_low + (np.tanh(act) + 1) * 0.5 * (
            self.act_high - self.act_low)
      next_obs, rew, term, trunc, _ = self.env.step(env_act)
      next_obs = next_obs.reshape(self.num_envs, -1)
      self.ep_steps += 1
      surpass = self.ep_steps >= self.max_episode_frames
      done = np.asarray(term) | np.asarray(trunc)
      terminal = done | surpass
      rew = np.asarray(rew, np.float64)
      self._ep_rew += rew
      if surpass.any():
        nv = self.apply_v(self._normalize(next_obs)).cpu().numpy()[:, 0]
        rew = rew + self.discount * nv * surpass
      if terminal.any():
        self.train_rews += list(self._ep_rew[terminal])
        self._ep_rew[terminal] = 0.0
        self.ep_steps[terminal] = 0
        # the vector env resets finished envs itself
      store["obs"].append(obs.cpu().numpy())
      store["acts"].append(act)
      store["log_probs"].append(logp)
      store["values"].append(value)
      store["rewards"].append(rew[:, None])
      store["terminals"].append(terminal[:, None])
      store["time_limits"].append((np.asarray(trunc) | surpass)[:, None])
      store["means"].append(mean)
      store["stds"].append(std)
      self.raw_obs = next_obs

    dev = self.device
    traj = Transition(**{
        k: torch.as_tensor(np.stack(v), device=dev,
                           dtype=(torch.bool if k in ("terminals",
                                                      "time_limits")
                                  else torch.float32))
        for k, v in store.items()})
    last_value = self.apply_v(self._normalize(self.raw_obs))[:, 0]
    last_value = last_value * (1.0 - traj.terminals[-1, :, 0].float())
    return traj, last_value
