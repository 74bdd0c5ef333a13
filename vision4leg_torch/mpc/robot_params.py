"""Per-robot MPC parameter sets for the convex-MPC locomotion controller
(the port's copy of vision4leg_tpu.mpc.robot_params, numpy only).

Mirrors the constants of the reference's robot sim modules
(mpc_controller/a1_sim.py:6-60, laikago_sim.py:4-60,
spirit40_sim.py:4-50): single-rigid-body mass/inertia, body height,
default hip positions in the base frame, init pose, joint offsets and the
demo velocity multiplier used by locomotion_controller_example.

Only the A1 has a full articulated model (robots/a1_model.py, built
from its URDF numbers).  The Laikago and Spirit40 articulated models live
in pybullet_data URDFs the reference loads at runtime and does not ship;
their parameter sets here drive the same MPC math (and the reference's
controller stack is robot-agnostic given these constants), with the demo
falling back to the A1 body for full-physics rollouts.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RobotMpcParams:
  name: str
  body_mass: float                       # kg (MPC single-rigid-body)
  body_inertia: Tuple[float, ...]        # 9, row-major body frame
  body_height: float                     # desired CoM height (m)
  velocity_multiplier: float             # demo speed profile scale
  hip_positions: Tuple[Tuple[float, float, float], ...]  # base frame, FR FL RR RL
  init_motor_angles: Tuple[float, ...]   # 12
  start_height: float                    # spawn height (START_POS z)
  # pose <-> motor-angle conversion offsets (laikago_sim.py:30-32)
  hip_joint_offset: float = 0.0
  upper_leg_joint_offset: float = 0.0
  knee_joint_offset: float = 0.0

  @property
  def init_angles(self) -> np.ndarray:
    return np.asarray(self.init_motor_angles, np.float32)


A1 = RobotMpcParams(
    name="a1",
    body_mass=108.0 / 9.8,
    # a1_sim.py:10-11: (0.017, 0.057, 0.064) * 0.1.  NOTE the RL-MPC env
    # (vision4leg/robots/a1.py:118) uses a different SRB inertia — that one
    # lives in robots/a1_params.MPC_BODY_INERTIA.
    body_inertia=(0.0017, 0.0, 0.0, 0.0, 0.0057, 0.0, 0.0, 0.0, 0.0064),
    body_height=0.24,
    velocity_multiplier=0.5,
    hip_positions=((0.17, -0.14, 0.0), (0.17, 0.14, 0.0),
                   (-0.17, -0.14, 0.0), (-0.17, 0.14, 0.0)),
    init_motor_angles=(0.0, 0.9, -1.8) * 4,
    start_height=0.32,
)

LAIKAGO = RobotMpcParams(
    name="laikago",
    body_mass=215.0 / 9.8,
    body_inertia=(0.07335, 0.0, 0.0, 0.0, 0.25068, 0.0, 0.0, 0.0, 0.25447),
    body_height=0.42,
    velocity_multiplier=1.0,
    hip_positions=((0.21, -0.1157, 0.0), (0.21, 0.1157, 0.0),
                   (-0.21, -0.1157, 0.0), (-0.21, 0.1157, 0.0)),
    init_motor_angles=(0.0, 0.67, -1.25) * 4,
    start_height=0.48,
    hip_joint_offset=0.0,
    upper_leg_joint_offset=-0.6,
    knee_joint_offset=0.66,
)

SPIRIT40 = RobotMpcParams(
    name="spirit40",
    body_mass=12.0,
    body_inertia=(0.07335, 0.0, 0.0, 0.0, 0.25068, 0.0, 0.0, 0.0, 0.25447),
    body_height=0.32,
    velocity_multiplier=0.7,
    hip_positions=((0.23, -0.12, 0.0), (0.23, 0.12, 0.0),
                   (-0.23, -0.12, 0.0), (-0.23, 0.12, 0.0)),
    init_motor_angles=(0.0, -0.7, 1.4) * 4,
    start_height=0.43,
)

ROBOTS = {p.name: p for p in (A1, LAIKAGO, SPIRIT40)}
