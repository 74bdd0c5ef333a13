"""Model-based locomotion controller stack, batched over envs (torch mirror
of vision4leg_tpu.mpc.controllers).

Reference: mpc_controller/{openloop_gait_generator, com_velocity_estimator,
raibert_swing_leg_controller, torque_stance_leg_controller}.py, as pure
functions over a `ControllerState` whose tensors lead with the env axis.

Leg states use the reference encoding (gait_generator_lib.LegState):
0=SWING, 1=STANCE, 2=EARLY_CONTACT, 3=LOSE_CONTACT.

The stance controller comes in two forms: `stance_action` solves each
tick's QP cold (`convex_mpc.compute_contact_forces`), and
`stance_action_warm`, which the MPC env's hot loop runs, on the
warm-started per-tick path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from vision4leg_torch.mpc import leg_kinematics as lk
from vision4leg_torch.mpc.convex_mpc import (
    CanonicalScaling, MpcConfig, WarmState, compute_contact_forces,
    compute_contact_forces_warm)
from vision4leg_torch.robots import a1_params as P

SWING, STANCE, EARLY_CONTACT, LOSE_CONTACT = 0, 1, 2, 3

# trotting gait defaults (locomotion_gym_mpc_env's stance duration etc.
# and locomotion_controller_example.py)
STANCE_DURATION = 0.3
DUTY_FACTOR = 0.6
INIT_PHASE = (0.9, 0.0, 0.0, 0.9)            # FR, FL, RR, RL
INIT_LEG_STATE = (SWING, STANCE, STANCE, SWING)
MPC_BODY_HEIGHT = float(P.MPC_BODY_HEIGHT)   # 0.24
FOOT_CLEARANCE = 0.01
KP_RAIBERT = 0.03                            # raibert _KP
VEL_WINDOW = 20                              # com_velocity_estimator window


class GaitConfig(NamedTuple):
  stance_duration: tuple = (STANCE_DURATION,) * 4
  duty_factor: tuple = (DUTY_FACTOR,) * 4
  initial_leg_phase: tuple = INIT_PHASE
  initial_leg_state: tuple = INIT_LEG_STATE
  contact_detection_phase_threshold: float = 0.1


@dataclasses.dataclass
class ControllerState:
  leg_state: torch.Tensor             # (E, 4) int32 actual state
  desired_leg_state: torch.Tensor     # (E, 4) int32
  normalized_phase: torch.Tensor      # (E, 4)
  swing_start_foot_pos: torch.Tensor  # (E, 4, 3) base frame
  vel_window: torch.Tensor            # (E, VEL_WINDOW, 3) base-vel history
  vel_count: torch.Tensor             # (E,) int32
  swing_joint_angles: torch.Tensor    # (E, 12) persisted swing targets
  qp_warm: WarmState                  # warm-started QP state

  def replace(self, **kw) -> "ControllerState":
    return dataclasses.replace(self, **kw)


def init_controller_state(foot_positions, joint_q, qp_warm: WarmState
                          ) -> ControllerState:
  E = joint_q.shape[0]
  dev = joint_q.device
  init = torch.tensor(INIT_LEG_STATE, dtype=torch.int32, device=dev)
  return ControllerState(
      leg_state=init.expand(E, 4).clone(),
      desired_leg_state=init.expand(E, 4).clone(),
      normalized_phase=joint_q.new_zeros(E, 4),
      swing_start_foot_pos=foot_positions.clone(),
      vel_window=joint_q.new_zeros(E, VEL_WINDOW, 3),
      vel_count=torch.zeros(E, dtype=torch.int32, device=dev),
      swing_joint_angles=joint_q.clone(), qp_warm=qp_warm)


def _gait_consts(cfg: GaitConfig, like):
  f = lambda name, v: lk.const(f"gait.{name}.{v}", v, like)
  sd, df = f("sd", cfg.stance_duration), f("df", cfg.duty_factor)
  init_state = lk.const(f"gait.state.{cfg.initial_leg_state}",
                        cfg.initial_leg_state,
                        torch.empty(0, dtype=torch.int32, device=like.device))
  return sd, df, f("phase", cfg.initial_leg_phase), init_state


def gait_update(cfg: GaitConfig, cs: ControllerState, current_time,
                foot_contacts) -> ControllerState:
  """OpenloopGaitGenerator.update (openloop_gait_generator.py:118-192);
  current_time (E,), foot_contacts (E, 4)."""
  sd, df, init_phase, init_state = _gait_consts(cfg, cs.normalized_phase)
  next_state = torch.where(init_state == SWING, STANCE, SWING).to(torch.int32)
  # fraction of the full cycle spent in the initial state
  init_ratio = torch.where(init_state == SWING, 1.0 - df, df)

  full_cycle = sd / df
  aug_time = current_time[:, None] + init_phase * full_cycle
  phase_full = torch.remainder(aug_time, full_cycle) / full_cycle

  in_initial = phase_full < init_ratio
  desired = torch.where(in_initial, init_state, next_state)
  norm_phase = torch.where(
      in_initial, phase_full / init_ratio,
      (phase_full - init_ratio) / (1.0 - init_ratio))

  # contact-driven corrections (early/lost contact)
  contacts = foot_contacts.to(torch.bool)
  thr = cfg.contact_detection_phase_threshold
  early = (desired == SWING) & (norm_phase > thr) & contacts
  lost = (desired == STANCE) & (norm_phase > thr) & ~contacts
  leg_state = torch.where(early, EARLY_CONTACT, desired)
  leg_state = torch.where(lost, LOSE_CONTACT, leg_state).to(torch.int32)
  return cs.replace(leg_state=leg_state, desired_leg_state=desired,
                    normalized_phase=norm_phase)


def estimator_update(cs: ControllerState, base_vel_body) -> ControllerState:
  """COMVelocityEstimator (com_velocity_estimator.py:82-139): moving-window
  average of the body-frame base velocity (E, 3)."""
  win = torch.cat([base_vel_body[:, None], cs.vel_window[:, :-1]], dim=1)
  return cs.replace(vel_window=win,
                    vel_count=torch.clamp(cs.vel_count + 1, max=VEL_WINDOW))


def com_velocity_body(cs: ControllerState) -> torch.Tensor:
  n = torch.clamp(cs.vel_count, min=1).to(cs.vel_window.dtype)
  steps = torch.arange(VEL_WINDOW, device=cs.vel_count.device)
  mask = (steps[None] < cs.vel_count[:, None])[..., None]
  return torch.sum(cs.vel_window * mask, dim=1) / n[:, None]


def _gen_parabola(phase, start, mid, end):
  """raibert_swing_leg_controller.py:31-55."""
  mid_phase = 0.5
  d1 = mid - start
  d2 = end - start
  d3 = mid_phase**2 - mid_phase
  a = (d1 - d2 * mid_phase) / d3
  b = (d2 * mid_phase**2 - d1) / d3
  return a * phase**2 + b * phase + start


def _swing_foot_trajectory(phase, start_pos, end_pos):
  """raibert_swing_leg_controller.py:57-91; phase (...), positions
  (..., 3)."""
  phase = torch.where(phase <= 0.5, 0.8 * torch.sin(phase * math.pi),
                      0.8 + (phase - 0.5) * 0.4)
  x = (1 - phase) * start_pos[..., 0] + phase * end_pos[..., 0]
  y = (1 - phase) * start_pos[..., 1] + phase * end_pos[..., 1]
  mid = torch.maximum(end_pos[..., 2], start_pos[..., 2]) + 0.1
  z = _gen_parabola(phase, start_pos[..., 2], mid, end_pos[..., 2])
  return torch.stack([x, y, z], dim=-1)


def swing_action(cs: ControllerState, gait_cfg: GaitConfig, yaw_rate,
                 desired_speed, desired_twisting_speed, foot_positions):
  """RaibertSwingLegController.get_action (:167-213) with the phase-switch
  bookkeeping of update() (:148-166).  yaw_rate (E,), desired_speed
  (E, 3), desired_twisting_speed (E,), foot_positions (E, 4, 3).
  Returns (cs', per-joint desired angles (E, 12))."""
  like = cs.normalized_phase
  # detect stance->swing switches: remember the liftoff foot position
  new_swing = cs.desired_leg_state == SWING
  started = new_swing & (cs.normalized_phase < 0.05)
  start_pos = torch.where(started[..., None], foot_positions,
                          cs.swing_start_foot_pos)

  com_vel = com_velocity_body(cs)
  com_vel = torch.cat([com_vel[:, :2], torch.zeros_like(com_vel[:, 2:])], 1)
  hips = lk.const("hips", lk.HIP_ORIGINS, like)             # (4, 3)
  sd = lk.const(f"gait.sd.{gait_cfg.stance_duration}",
                gait_cfg.stance_duration, like)
  twisting = torch.stack([-hips[:, 1], hips[:, 0], torch.zeros_like(
      hips[:, 0])], -1)                                     # (4, 3)
  hip_xy = torch.cat([hips[:, :2], torch.zeros_like(hips[:, 2:])], -1)
  desired_height = lk.const(
      "swing.height", [0.0, 0.0, MPC_BODY_HEIGHT - FOOT_CLEARANCE], like)

  hip_h_vel = com_vel[:, None] + yaw_rate[:, None, None] * twisting
  target_hip_vel = (desired_speed[:, None]
                    + desired_twisting_speed[:, None, None] * twisting)
  target = (hip_h_vel * sd[:, None] / 2
            - KP_RAIBERT * (target_hip_vel - hip_h_vel)) \
      - desired_height + hip_xy                             # (E, 4, 3)
  foot_pos = _swing_foot_trajectory(cs.normalized_phase, start_pos, target)
  angles = lk.foot_ik_hip_frame(foot_pos - hips,
                                lk.const("side", lk.SIDE_SIGN, like))
  angles = angles.reshape(angles.shape[0], 12)
  # persist swing targets (the reference keeps the last swing angles for
  # legs that just transitioned)
  swing_mask = torch.repeat_interleave(new_swing, 3, dim=-1)
  joint_angles = torch.where(swing_mask, angles, cs.swing_joint_angles)
  cs = cs.replace(swing_start_foot_pos=start_pos,
                  swing_joint_angles=joint_angles)
  return cs, joint_angles


def _stance_inputs(cs: ControllerState, rpy, desired_speed,
                   desired_twisting_speed, friction):
  """The contact states (E, 4) and the QP's state arguments after the
  feet's and the joints' (com position, velocity, yawless rpy; friction,
  desired position, velocity, rpy and angular velocity) of a stance
  tick."""
  E = rpy.shape[0]
  contact_state = ((cs.desired_leg_state == STANCE)
                   | (cs.desired_leg_state == EARLY_CONTACT)).to(torch.int32)
  rpy_yawless = torch.cat([rpy[:, :2], torch.zeros_like(rpy[:, 2:])], 1)
  zero = torch.zeros_like(desired_twisting_speed)[:, None]
  head = (rpy.new_zeros(E, 1),              # com_position: from the feet
          com_velocity_body(cs), rpy_yawless)
  tail = (rpy.new_full((E, 4), friction),
          lk.const("stance.height", [0.0, 0.0, MPC_BODY_HEIGHT], rpy),
          torch.cat([desired_speed[:, :2], zero], 1),
          lk.const("stance.zeros", [0.0, 0.0, 0.0], rpy),
          torch.cat([zero, zero, desired_twisting_speed[:, None]], 1))
  return contact_state, head, tail


def _joint_torques(forces, joint_q):
  """tau = f^T J per leg (minitaur.py:726-737 MapContactForceToJointTorques):
  forces (E, 4, 3) -> (E, 12)."""
  jacs = lk.all_leg_jacobians(joint_q)                      # (E, 4, 3, 3)
  return torch.einsum("elj,elji->eli", forces, jacs).reshape(-1, 12)


def stance_action(mpc_cfg: MpcConfig, cs: ControllerState, rpy, rpy_rate,
                  foot_positions, joint_q, desired_speed,
                  desired_twisting_speed, friction: float = 0.45):
  """TorqueStanceLegController.get_action (:119-185) with each tick's QP
  solved cold: joint torques (E, 12) for the stance legs (the caller
  masks the others) and the contact states (E, 4)."""
  contact_state, head, tail = _stance_inputs(
      cs, rpy, desired_speed, desired_twisting_speed, friction)
  forces = compute_contact_forces(mpc_cfg, *head, rpy_rate, contact_state,
                                  foot_positions, *tail)
  return _joint_torques(forces, joint_q), contact_state


def stance_action_warm(mpc_cfg: MpcConfig, canon: CanonicalScaling,
                       cs: ControllerState, rpy, rpy_rate, foot_positions,
                       joint_q, desired_speed, desired_twisting_speed,
                       friction: float = 0.45):
  """TorqueStanceLegController.get_action (:119-185) on the warm-started
  per-tick QP: joint torques (E, 12) for the stance legs (the caller masks
  the others), the contact states (E, 4) and cs' with the new warm
  state."""
  contact_state, head, tail = _stance_inputs(
      cs, rpy, desired_speed, desired_twisting_speed, friction)
  forces, warm = compute_contact_forces_warm(
      mpc_cfg, canon, cs.qp_warm, *head, rpy_rate, contact_state,
      foot_positions, *tail, warm_iters=mpc_cfg.warm_iters,
      ns_iters=mpc_cfg.ns_iters)
  return (_joint_torques(forces, joint_q), contact_state,
          cs.replace(qp_warm=warm))
