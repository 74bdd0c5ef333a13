"""Deployment policy wrapper (mirror of
vision4leg_tpu.hardware.policy_wrapper; reference
a1_hardware/control_loop_execution/rl_policy_wrapper.py): the simulator's
observation pipeline on the real robot, and the policy's output turned
into motor position commands.

  * process_obs (:109-172): per-modality NormedStateHistory normalized with
    the TRAINING obs-normalizer slices; VisualHistory with sliding
    frame-extract indices,
  * process_act (:174-193): diagonal 6->12 expansion, tanh -> [lb, ub]
    rescale around the default pose, per-joint delta clip,
  * get_action (:196+).

Host numpy, bit-equal to the JAX wrapper.  `policy_fn` receives the
observation as a numpy array and returns the mean action; the deploy
entry point moves it to the policy's device
(`execute_locotransformer.make_policy_fn`).
"""
from __future__ import annotations

import numpy as np

from vision4leg_torch.hardware.sensor_histories import (NormedStateHistory,
                                                        VisualHistory)
from vision4leg_torch.robots import a1_params as P


class PolicyWrapper:
  def __init__(self, policy_fn, obs_normalizer_mean, obs_normalizer_var,
               num_hist: int = 3, frame_extract: int = 1,
               get_image_interval: int = 1, clip_num=(0.05, 0.5, 0.5) * 4,
               save_log: bool = False):
    """policy_fn: (obs (D,) numpy) -> action (6,) deterministic mean.

    obs_normalizer_* : the training NormObsWithImg statistics; slices are
    the sorted-sensor-name layout [IMU 0:12 | LastAction 12:48 |
    MotorAngle 48:84] for the shipped no-displacement configs.
    """
    self.policy_fn = policy_fn
    mean, var = np.asarray(obs_normalizer_mean), np.asarray(
        obs_normalizer_var)
    self.imu_hist = NormedStateHistory(4, num_hist, mean[0:12], var[0:12])
    self.last_action_hist = NormedStateHistory(12, num_hist, mean[12:48],
                                               var[12:48])
    self.motor_hist = NormedStateHistory(12, num_hist, mean[48:84],
                                         var[48:84])
    num_frames = get_image_interval * (4 * frame_extract - 1) + 1
    self.visual_hist = VisualHistory((64, 64), num_frames)
    self.frame_idx = np.arange(4) * frame_extract * get_image_interval
    clip = np.asarray(clip_num)
    self.lb = np.asarray(P.INIT_MOTOR_ANGLES) - clip
    self.ub = np.asarray(P.INIT_MOTOR_ANGLES) + clip
    self.last_action12 = np.asarray(P.INIT_MOTOR_ANGLES).copy()

  def process_obs(self, rpy, drpy, motor_angles, depth_frame) -> np.ndarray:
    imu = np.array([rpy[0], rpy[1], drpy[0], drpy[1]])
    parts = [
        self.imu_hist.record_and_normalize(imu),
        self.last_action_hist.record_and_normalize(self.last_action12),
        self.motor_hist.record_and_normalize(motor_angles),
        self.visual_hist.record_and_normalize(depth_frame, self.frame_idx),
    ]
    return np.concatenate(parts).astype(np.float32)

  def process_act(self, action6: np.ndarray) -> np.ndarray:
    """diagonal expand + tanh rescale + motor-delta clip (:174-193)."""
    right, left = np.split(np.asarray(action6), 2)
    act12 = np.concatenate([right, left, left, right])
    act12 = np.tanh(act12)
    act12 = self.lb + (act12 + 1.0) * 0.5 * (self.ub - self.lb)
    act12 = np.clip(act12,
                    self.last_action12 - P.MAX_MOTOR_ANGLE_CHANGE_PER_STEP,
                    self.last_action12 + P.MAX_MOTOR_ANGLE_CHANGE_PER_STEP)
    self.last_action12 = act12
    return act12

  def get_action(self, rpy, drpy, motor_angles, depth_frame) -> np.ndarray:
    obs = self.process_obs(rpy, drpy, motor_angles, depth_frame)
    action = np.asarray(self.policy_fn(obs))
    return self.process_act(action)
