"""DeepMind-style Atari wrappers for the host-env collector (torch port's
copy of vision4leg_tpu.collector.atari: host numpy code, no torch).

Reference: torchrl/env/atari_wrapper.py + torchrl/env/get_env.py:8-22
(wrap_deepmind).  Reimplemented against the gymnasium API (this image
ships gymnasium, not legacy gym): step returns (obs, reward, terminated,
truncated, info) and reset returns (obs, info).

Wrapper stack, same order and defaults as the reference's wrap_deepmind:
  EpisodicLife -> NoopReset(30) -> MaxAndSkip(4) -> [FireReset] ->
  WarpFrame(84x84 gray) -> [ScaledFloat] -> [ClipReward] -> [FrameStack 4]

ALE itself (ale-py) is optional: the wrappers only assume the gymnasium
core API plus `ale.lives()` / `get_action_meanings()` where noted, so
they are tested against a synthetic image env (tests/test_atari.py,
tests/test_torch_collectors_host.py) and work with real Atari when ale-py
is installed.  This is the one module of the port that needs gymnasium
at import.
"""
from __future__ import annotations

from collections import deque

import numpy as np

try:
  import gymnasium
  from gymnasium import spaces
except ImportError as _e:  # pragma: no cover
  # the wrapper classes subclass gymnasium.Wrapper at definition time, so
  # without gymnasium this module cannot load at all — fail loudly here
  # rather than with an AttributeError mid-class-statement
  raise ImportError(
      "vision4leg_torch.collector.atari requires gymnasium") from _e

try:
  import cv2
except ImportError:  # pragma: no cover
  cv2 = None         # only WarpFrame needs it; checked in its __init__


class NoopResetEnv(gymnasium.Wrapper):
  """On reset, take a random number (1..noop_max) of no-op actions
  (atari_wrapper.py:13-41): decorrelates initial states."""

  def __init__(self, env, noop_max: int = 30):
    super().__init__(env)
    self.noop_max = noop_max
    self.noop_action = 0
    meanings = getattr(env.unwrapped, "get_action_meanings", lambda: [])()
    if meanings:
      assert meanings[0] == "NOOP"

  def reset(self, **kwargs):
    obs, info = self.env.reset(**kwargs)
    noops = self.np_random.integers(1, self.noop_max + 1)
    for _ in range(noops):
      obs, _, term, trunc, info = self.env.step(self.noop_action)
      if term or trunc:
        obs, info = self.env.reset(**kwargs)
    return obs, info


class FireResetEnv(gymnasium.Wrapper):
  """Press FIRE after reset for envs that need it (atari_wrapper.py:44-62)."""

  def __init__(self, env):
    super().__init__(env)
    meanings = env.unwrapped.get_action_meanings()
    assert meanings[1] == "FIRE" and len(meanings) >= 3

  def reset(self, **kwargs):
    self.env.reset(**kwargs)
    obs, _, term, trunc, info = self.env.step(1)
    if term or trunc:
      self.env.reset(**kwargs)
    obs, _, term, trunc, info = self.env.step(2)
    if term or trunc:
      obs, info = self.env.reset(**kwargs)
    return obs, info


class EpisodicLifeEnv(gymnasium.Wrapper):
  """End the learning episode on life loss, only truly resetting when the
  game is over (atari_wrapper.py:65-99): makes value bootstrapping aware
  of lives without discarding game state."""

  def __init__(self, env):
    super().__init__(env)
    self.lives = 0
    self.was_real_done = True

  def step(self, action):
    obs, reward, term, trunc, info = self.env.step(action)
    self.was_real_done = term or trunc
    lives = self.env.unwrapped.ale.lives()
    if 0 < lives < self.lives:
      term = True
    self.lives = lives
    return obs, reward, term, trunc, info

  def reset(self, **kwargs):
    if self.was_real_done:
      obs, info = self.env.reset(**kwargs)
    else:
      # no-op step advances from the life-loss state
      obs, _, _, _, info = self.env.step(0)
    self.lives = self.env.unwrapped.ale.lives()
    return obs, info


class MaxAndSkipEnv(gymnasium.Wrapper):
  """Repeat the action `skip` frames and max-pool the last two
  (atari_wrapper.py:102-131): hides the ALE's 2-frame sprite flicker."""

  def __init__(self, env, skip: int = 4):
    super().__init__(env)
    shp = env.observation_space.shape
    self._buf = np.zeros((2,) + shp, dtype=env.observation_space.dtype)
    self._skip = skip

  def step(self, action):
    total = 0.0
    term = trunc = False
    info = {}
    for i in range(self._skip):
      obs, reward, term, trunc, info = self.env.step(action)
      if i == self._skip - 2:
        self._buf[0] = obs
      if i == self._skip - 1:
        self._buf[1] = obs
      total += reward
      if term or trunc:
        break
    return self._buf.max(axis=0), total, term, trunc, info


class ClipRewardEnv(gymnasium.RewardWrapper):
  """sign(reward) (atari_wrapper.py:134-140)."""

  def reward(self, reward):
    return float(np.sign(reward))


class WarpFrame(gymnasium.ObservationWrapper):
  """Grayscale + resize to 84x84x1 (atari_wrapper.py:172-197)."""

  def __init__(self, env, width: int = 84, height: int = 84):
    if cv2 is None:
      raise ImportError("WarpFrame requires cv2 (opencv-python)")
    super().__init__(env)
    self.width, self.height = width, height
    self.observation_space = spaces.Box(
        low=0, high=255, shape=(height, width, 1), dtype=np.uint8)

  def observation(self, frame):
    if frame.ndim == 3 and frame.shape[-1] == 3:
      frame = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    frame = cv2.resize(frame, (self.width, self.height),
                       interpolation=cv2.INTER_AREA)
    return frame[:, :, None]


class ScaledFloatFrame(gymnasium.ObservationWrapper):
  """uint8 -> float32 / 255 (atari_wrapper.py:232-241)."""

  def __init__(self, env):
    super().__init__(env)
    self.observation_space = spaces.Box(
        low=0.0, high=1.0, shape=env.observation_space.shape,
        dtype=np.float32)

  def observation(self, obs):
    return np.asarray(obs, dtype=np.float32) / 255.0


class FrameStack(gymnasium.Wrapper):
  """Stack the last k frames along the channel axis
  (atari_wrapper.py:200-229; the reference's LazyFrames memory trick is
  unnecessary here — epochs move to the device as one array anyway)."""

  def __init__(self, env, k: int = 4):
    super().__init__(env)
    self.k = k
    self.frames = deque([], maxlen=k)
    shp = env.observation_space.shape
    self.observation_space = spaces.Box(
        low=0, high=255, shape=(shp[0], shp[1], shp[2] * k),
        dtype=env.observation_space.dtype)

  def reset(self, **kwargs):
    obs, info = self.env.reset(**kwargs)
    for _ in range(self.k):
      self.frames.append(obs)
    return self._get_ob(), info

  def step(self, action):
    obs, reward, term, trunc, info = self.env.step(action)
    self.frames.append(obs)
    return self._get_ob(), reward, term, trunc, info

  def _get_ob(self):
    assert len(self.frames) == self.k
    return np.concatenate(list(self.frames), axis=-1)


def wrap_deepmind(env, frame_stack: bool = False, scale: bool = False,
                  clip_rewards: bool = False):
  """Reference wrap_deepmind (get_env.py:8-22), same order and flags."""
  assert "NoFrameskip" in env.spec.id
  env = EpisodicLifeEnv(env)
  env = NoopResetEnv(env, noop_max=30)
  env = MaxAndSkipEnv(env, skip=4)
  if "FIRE" in env.unwrapped.get_action_meanings():
    env = FireResetEnv(env)
  env = WarpFrame(env)
  if scale:
    env = ScaledFloatFrame(env)
  if clip_rewards:
    env = ClipRewardEnv(env)
  if frame_stack:
    env = FrameStack(env, 4)
  return env


def make_atari_vec_env(env_id: str, num_envs: int, seed: int = 0,
                       asynchronous: bool = True, **deepmind_kwargs):
  """Atari entry for HostOnPolicyCollector: N wrapped envs in worker
  processes (reference get_subprocvec_env over wrap_deepmind)."""
  from vision4leg_torch.collector.host import make_vec_env
  return make_vec_env(
      env_id, num_envs, seed=seed, asynchronous=asynchronous,
      wrappers=(lambda e: wrap_deepmind(e, **deepmind_kwargs),))
