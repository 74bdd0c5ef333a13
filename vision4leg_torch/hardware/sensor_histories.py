"""Hardware-side observation histories (mirror of
vision4leg_tpu.hardware.sensor_histories; reference
a1_hardware/a1_utilities/a1_sensor_histories.py).

`NormedStateHistory` keeps a ring of one modality's readings normalized
with the training normalizer's slice for it; `VisualHistory` keeps the
depth frames with the fixed depth statistics (mean 1.25, var 0.425**2).
Host numpy, as on the robot's computer: the arithmetic is the JAX
package's, so the observation is bit-equal to it.
"""
from __future__ import annotations

import numpy as np


def depth_process(depth: np.ndarray) -> np.ndarray:
  """clip [0.3, 10] + sqrt(log(d+1)) (a1_sensor_histories.py:55-62)."""
  return np.sqrt(np.log(np.clip(depth, 0.3, 10.0) + 1.0))


class NormedStateHistory:
  """Ring of the last `num_hist` readings, normalized with the training
  normalizer's mean/var slice for this modality."""

  def __init__(self, input_dim: int, num_hist: int, mean: np.ndarray,
               var: np.ndarray):
    """mean/var: the (num_hist * input_dim,) slice of the training
    normalizer covering this modality's full history block."""
    self.input_dim = input_dim
    self.num_hist = num_hist
    self.mean = np.asarray(mean, np.float64).reshape(num_hist, input_dim)
    self.var = np.asarray(var, np.float64).reshape(num_hist, input_dim)
    self.buffer = np.zeros((num_hist, input_dim))

  def record_and_normalize(self, reading: np.ndarray) -> np.ndarray:
    self.buffer = np.roll(self.buffer, 1, axis=0)
    self.buffer[0] = reading
    normalized = np.clip(
        (self.buffer - self.mean) / (np.sqrt(self.var) + 1e-4), -10, 10)
    return normalized.reshape(-1)


class VisualHistory:
  """Depth-frame ring gathered at the frame-extract indices; frames
  normalized with the fixed training statistics
  (rl_policy_wrapper.py:80-90)."""

  def __init__(self, frame_shape, num_frames: int, mean: float = 1.25,
               var: float = 0.425**2):
    self.buffer = np.zeros((num_frames,) + tuple(frame_shape))
    self.num_frames = num_frames
    self.mean = mean
    self.var = var

  def record_and_normalize(self, frame: np.ndarray,
                           frame_idx) -> np.ndarray:
    self.buffer = np.roll(self.buffer, 1, axis=0)
    self.buffer[0] = depth_process(frame)
    sel = self.buffer[np.asarray(frame_idx)]
    return ((sel - self.mean) / np.sqrt(self.var)).reshape(-1)
