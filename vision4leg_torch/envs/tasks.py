"""Locomotion task reward and termination (torch mirror of
vision4leg_tpu.envs.tasks; reference move_forward_task.py and
goal_task.py).  Every function is batched over a leading env axis."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from vision4leg_torch.physics import maths


@dataclasses.dataclass
class TaskState:
  last_base_pos: torch.Tensor     # (E, 3)
  current_base_pos: torch.Tensor  # (E, 3)
  subgoal_trackers: torch.Tensor  # (E, S) 1.0 = still active
  target_vel_dir: torch.Tensor    # (E, 2)

  def replace(self, **kw) -> "TaskState":
    return dataclasses.replace(self, **kw)


class TaskConfig(NamedTuple):
  goal: bool = False
  z_constrain: bool = False
  move_forward_coeff: float = 1.0
  other_direction_penalty: float = 0.0
  z_penalty: float = 0.0
  orientation_penalty: float = 0.0
  time_step_s: float = 0.0025
  num_action_repeat: int = 16
  height_fall_coeff: float = 0.2
  alive_reward: float = 0.1
  fall_reward: float = 0.0
  target_vel: float = 1.0
  check_contact: bool = False
  subgoal_reward: float | None = None
  goal_coeff: float = 10.0
  energy_weight: float = -0.005
  subgoal_radius: float = 0.2


def init_task_state(base_pos, num_subgoals: int) -> TaskState:
  E = base_pos.shape[0]
  dev = base_pos.device
  return TaskState(
      last_base_pos=base_pos.clone(), current_base_pos=base_pos.clone(),
      subgoal_trackers=torch.ones(E, num_subgoals, device=dev),
      target_vel_dir=torch.tensor([1.0, 0.0], device=dev).expand(E, 2)
      .clone())


def update(ts: TaskState, base_pos) -> TaskState:
  """MoveForwardTask.update (move_forward_task.py:89-92)."""
  return ts.replace(last_base_pos=ts.current_base_pos,
                    current_base_pos=base_pos)


def done(cfg: TaskConfig, ts: TaskState, base_pos, quat_wxyz,
         nonfoot_contact):
  """Termination (move_forward_task.py:94-134); a non-finite pose also
  terminates."""
  rot_fall = maths.quat_to_mat(quat_wxyz)[..., 2, 2] < 0.6
  height_fall = ((base_pos[..., 2] < cfg.height_fall_coeff)
                 | ~torch.isfinite(base_pos).all(dim=-1)
                 | ~torch.isfinite(quat_wxyz).all(dim=-1))
  if cfg.z_constrain:
    height_fall = height_fall | (base_pos[..., 2] > 0.8)
  d = torch.zeros_like(height_fall)
  if cfg.check_contact:
    dt = cfg.time_step_s * cfg.num_action_repeat
    speed = torch.linalg.norm(
        (ts.current_base_pos - ts.last_base_pos) / dt, dim=-1)
    d = nonfoot_contact & (speed <= 0.05)
  return height_fall | rot_fall | d


def reward(cfg: TaskConfig, ts: TaskState, quat_xyzw, motor_torques,
           is_done, subgoal_centers, goal_pos):
  """Reward (move_forward_task.py:136-187 / goal_task.py:136-200).
  Returns (reward (E,), new subgoal trackers)."""
  dt = cfg.time_step_s * cfg.num_action_repeat
  vel = (ts.current_base_pos - ts.last_base_pos) / dt
  xy_speed = vel[..., :2]
  along = torch.sum(xy_speed * ts.target_vel_dir, dim=-1)
  per = xy_speed - along[..., None] * ts.target_vel_dir
  along = torch.clamp(along, max=cfg.target_vel)
  along_reward = cfg.target_vel ** 2 - (along - cfg.target_vel) ** 2
  forward_reward = (along_reward
                    - cfg.other_direction_penalty * torch.sum(per * per, -1)
                    - cfg.z_penalty * vel[..., 2] ** 2)
  energy_reward = torch.sum(motor_torques * motor_torques, dim=-1) \
      * cfg.time_step_s
  init_q = quat_xyzw.new_tensor([0.0, 0.0, 0.0, 1.0])
  orientation_reward = torch.sum((init_q - quat_xyzw) ** 2, dim=-1)
  r = (forward_reward * cfg.move_forward_coeff
       + energy_reward * cfg.energy_weight
       - cfg.orientation_penalty * orientation_reward
       + cfg.alive_reward)
  if cfg.goal:
    last_d = torch.linalg.norm(ts.last_base_pos[..., :2] - goal_pos[..., :2],
                               dim=-1)
    cur_d = torch.linalg.norm(
        ts.current_base_pos[..., :2] - goal_pos[..., :2], dim=-1)
    r = r + cfg.goal_coeff * (last_d - cur_d) / dt
  r = r + torch.where(is_done, cfg.fall_reward, 0.0)
  trackers = ts.subgoal_trackers
  if cfg.subgoal_reward is not None:
    dis = torch.linalg.norm(
        subgoal_centers - ts.current_base_pos[..., None, :2], dim=-1)
    hit = (dis < cfg.subgoal_radius) * trackers
    r = r + cfg.subgoal_reward * torch.sum(hit, dim=-1)
    trackers = trackers * (1.0 - hit)
  return r, trackers
