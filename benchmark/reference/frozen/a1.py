"""A1 robot layer: PD motor model, observation-latency ring, delayed
sensor reads (torch mirror of vision4leg_tpu.robots.a1).

Reference behaviours (vision4leg): `LaikagoMotorModel.convert_to_torque`
(laikago_motor.py:107-180) for the PD torque, and the observation-history
deque with linear interpolation `control_latency` seconds back
(minitaur.py:1192-1234).  State tensors carry leading env dimensions.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import engine, maths
from .model import Model
from . import a1_params as P

# observation-history record: [q(12), qd(12), quat_wxyz(4), omega_world(3)]
OBS_HIST_DIM = 31
OBS_HIST_LEN = 20  # covers max control latency 0.04 s / 0.0025 s + blend


@dataclasses.dataclass
class DynamicsParams:
  """Per-episode randomized dynamics; fields carry leading env dims."""
  kp: torch.Tensor              # (..., 12)
  kd: torch.Tensor              # (..., 12)
  strength_ratios: torch.Tensor  # (..., 12)
  motor_friction: torch.Tensor  # (...) viscous damping Nm s/rad
  joint_friction: torch.Tensor  # (...) Coulomb torque Nm
  control_latency: torch.Tensor  # (...) seconds
  lateral_friction: torch.Tensor  # (...) ground friction coefficient
  mass_scale: torch.Tensor      # (..., B)
  inertia_scale: torch.Tensor   # (..., B)

  def replace(self, **kw) -> "DynamicsParams":
    return dataclasses.replace(self, **kw)


def default_dynamics(model: Model, batch: tuple = ()) -> DynamicsParams:
  dev = model.device
  full = lambda shape, v: torch.full(batch + shape, float(v), device=dev)
  return DynamicsParams(
      kp=torch.tensor(P.MOTOR_KP, dtype=torch.float32,
                      device=dev).expand(batch + (12,)).clone(),
      kd=torch.tensor(P.MOTOR_KD, dtype=torch.float32,
                      device=dev).expand(batch + (12,)).clone(),
      strength_ratios=full((12,), 1.0), motor_friction=full((), 0.0),
      joint_friction=full((), 0.0), control_latency=full((), 0.0),
      lateral_friction=full((), 1.0), mass_scale=full((model.nbody,), 1.0),
      inertia_scale=full((model.nbody,), 1.0))


def apply_dynamics(model: Model, dyn: DynamicsParams) -> Model:
  """Per-episode model with the randomized inertial/joint params of dyn;
  with env dims on dyn, every inertial/joint array of the model gains
  them (mass (E, B), inertia (E, B, 3, 3), damping and friction (E, J))."""
  return model.replace(
      mass=model.mass * dyn.mass_scale,
      inertia=model.inertia * dyn.inertia_scale[..., None, None],
      joint_damping=model.joint_damping + dyn.motor_friction[..., None],
      joint_friction=model.joint_friction + dyn.joint_friction[..., None])


@dataclasses.dataclass
class RobotState:
  phys: engine.PhysState
  obs_hist: torch.Tensor          # (..., OBS_HIST_LEN, OBS_HIST_DIM)
  observed_torques: torch.Tensor  # (..., 12) last substep's PD torque
  last_robot_action: torch.Tensor  # (..., 12)
  step_counter: torch.Tensor      # (...) int32 substep counter

  def replace(self, **kw) -> "RobotState":
    return dataclasses.replace(self, **kw)


def true_record(state: engine.PhysState) -> torch.Tensor:
  return torch.cat([state.joint_q, state.joint_qd, state.quat, state.ang],
                   dim=-1)


def init_robot_state(phys: engine.PhysState) -> RobotState:
  rec = true_record(phys)
  batch = rec.shape[:-1]
  return RobotState(
      phys=phys,
      obs_hist=rec[..., None, :].expand(
          batch + (OBS_HIST_LEN, OBS_HIST_DIM)).clone(),
      observed_torques=torch.zeros_like(phys.joint_q),
      last_robot_action=phys.joint_q.clone(),
      step_counter=torch.zeros(batch, dtype=torch.int32,
                               device=rec.device))


def motor_torques(q, qd, commands, dyn: DynamicsParams) -> torch.Tensor:
  """POSITION-mode PD (laikago_motor.py:169-179), no torque clip."""
  tau = -dyn.kp * (q - commands) - dyn.kd * qd
  return dyn.strength_ratios * tau


def substep(model: Model, rs: RobotState, command, dyn: DynamicsParams,
            contact_fn, tau_ff=None, tau_mask=None
            ) -> Tuple[RobotState, torch.Tensor]:
  """ApplyAction + stepSimulation + ReceiveObservation (minitaur.py:
  255-274) with the per-env engine.  `model` already carries dyn
  (apply_dynamics).  With tau_ff and tau_mask (..., 12) the torque is the
  MPC env's hybrid one (JAX mpc_env.py:218-227): the masked (stance)
  joints apply tau_ff, the others track `command` under PD, as the
  physics window's hybrid mode does.  Returns (new state, penetration
  (..., P, 2))."""
  tau = motor_torques(rs.phys.joint_q, rs.phys.joint_qd, command, dyn)
  if tau_ff is not None:
    tau = (1.0 - tau_mask) * tau + tau_mask * tau_ff
  phys, penetration, _ = engine.step(model, rs.phys, tau, contact_fn)
  hist = torch.cat([true_record(phys)[..., None, :], rs.obs_hist[..., :-1, :]],
                   dim=-2)
  return rs.replace(phys=phys, obs_hist=hist, observed_torques=tau,
                    step_counter=rs.step_counter + 1), penetration


# ---------------------------------------------------------------------------
# Delayed sensor reads (minitaur.py:1192-1252)
# ---------------------------------------------------------------------------

def _delayed_record(rs: RobotState, latency, dt: float) -> torch.Tensor:
  """Linear interpolation into the observation ring."""
  steps = latency / dt
  n = torch.clamp(torch.floor(steps).to(torch.int32), 0, OBS_HIST_LEN - 2)
  alpha = torch.clamp(steps - n.to(torch.float32), 0.0, 1.0)[..., None]
  idx = n.long()[..., None, None].expand(n.shape + (1, OBS_HIST_DIM))
  newer = torch.gather(rs.obs_hist, -2, idx)[..., 0, :]
  older = torch.gather(rs.obs_hist, -2, idx + 1)[..., 0, :]
  rec = (1.0 - alpha) * newer + alpha * older
  quat = rec[..., 24:28]
  quat = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True),
                            min=1e-8)
  return torch.cat([rec[..., :24], quat, rec[..., 28:]], dim=-1)


def delayed_motor_angles(rs: RobotState, dyn: DynamicsParams, dt: float):
  return _delayed_record(rs, dyn.control_latency, dt)[..., 0:12]


def delayed_rpy_and_rate(rs: RobotState, dyn: DynamicsParams, dt: float):
  """Delayed (roll, pitch, yaw) and body-frame angular rate."""
  rec = _delayed_record(rs, dyn.control_latency, dt)
  quat = rec[..., 24:28]
  omega_w = rec[..., 28:31]
  return maths.quat_to_rpy(quat), maths.quat_rotate_inv(quat, omega_w)
