"""npz recorder of a deployment run's observations and actions (mirror of
vision4leg_tpu.hardware.state_logger; reference
a1_hardware/a1_utilities/logger.py StateLogger)."""
from __future__ import annotations

import time

import numpy as np


class StateLogger:
  """Up to duration * control_freq + 10 rows of (time, observation,
  action); `save` writes them, and the row count `idx`, to an npz."""

  def __init__(self, duration: float, control_freq: float,
               frame_interval: int = 1, save_path: str = "log.npz"):
    n = int(duration * control_freq) + 10
    self.save_path = save_path
    self.idx = 0
    self.data = {
        "time": np.zeros(n),
        "observation": None,
        "action": None,
    }

  def record(self, observation, action):
    if self.data["observation"] is None:
      n = len(self.data["time"])
      self.data["observation"] = np.zeros((n,) + np.shape(observation))
      self.data["action"] = np.zeros((n,) + np.shape(action))
    if self.idx < len(self.data["time"]):
      self.data["time"][self.idx] = time.time()
      self.data["observation"][self.idx] = observation
      self.data["action"][self.idx] = action
      self.idx += 1

  def save(self):
    np.savez(self.save_path, idx=self.idx,
             **{k: v for k, v in self.data.items() if v is not None})
