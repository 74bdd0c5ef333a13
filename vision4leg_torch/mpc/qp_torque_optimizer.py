"""Zeroth-order whole-body force QP for stance control, batched over envs
(torch mirror of vision4leg_tpu.mpc.qp_torque_optimizer).

Reference: mpc_controller/qp_torque_optimizer.py:16-98 (quadprog-based):
  min || M f - (g + desired_acc) ||_Q^2 + reg ||f||^2
  s.t. fz bounds per contact leg + friction pyramid,
with M the 6x12 centroidal "mass matrix" mapping leg forces to base
accelerations.  The quadprog active-set solve becomes the convex MPC's
cold box-constrained ADMM (`convex_mpc._admm_box_qp`), one QP per env.
"""
from __future__ import annotations

import torch

from vision4leg_torch.mpc.convex_mpc import _admm_box_qp, _skew, no_tf32

ACC_WEIGHT = (1.0, 1.0, 1.0, 10.0, 10.0, 1.0)
GRAVITY = 9.8


def compute_mass_matrix(robot_mass, robot_inertia, foot_positions):
  """(E, 6, 12): rows = base [lin acc (3), ang acc (3)] per unit leg
  force; robot_inertia (3, 3) or (E, 3, 3), foot_positions (E, 4, 3)."""
  E = foot_positions.shape[0]
  like = foot_positions
  inv_mass = torch.eye(3, dtype=like.dtype, device=like.device) / robot_mass
  inv_inertia = torch.linalg.inv(torch.as_tensor(
      robot_inertia, dtype=like.dtype, device=like.device))
  ang = inv_inertia[..., None, :, :] @ _skew(foot_positions)  # (E, 4, 3, 3)
  lin = inv_mass.expand(E, 4, 3, 3)
  return torch.cat([lin, ang], dim=-2).permute(0, 2, 1, 3).reshape(E, 6, 12)


def compute_contact_force(mass, inertia, foot_positions, desired_acc,
                          contacts, acc_weight=ACC_WEIGHT,
                          reg_weight: float = 1e-4,
                          friction_coef: float = 0.45,
                          f_min_ratio: float = 0.1,
                          f_max_ratio: float = 10.0,
                          iters: int = 60) -> torch.Tensor:
  """Robot-applied forces (E, 4, 3) (the negated ground reaction, as the
  reference returns them, :98) of every env: foot_positions (E, 4, 3),
  desired_acc (E, 6), contacts (E, 4)."""
  E = foot_positions.shape[0]
  like = foot_positions
  t = lambda x: torch.as_tensor(x, dtype=like.dtype, device=like.device)
  with no_tf32():
    M = compute_mass_matrix(mass, inertia, foot_positions)
    g = t([0.0, 0.0, GRAVITY, 0.0, 0.0, 0.0])
    Q = torch.diag(t(acc_weight))
    eye = torch.eye(12, dtype=like.dtype, device=like.device)
    P = 2.0 * (M.mT @ Q @ M + reg_weight * eye + 1e-4 * eye)
    q = (-2.0 * M.mT @ Q @ (g + desired_acc)[..., None])[..., 0]

    # constraints: per leg fz in [f_min, f_max] (contact) or ~0, then the
    # four pyramid rows
    f_min = f_min_ratio * mass * GRAVITY
    f_max = f_max_ratio * mass * GRAVITY
    c = contacts.to(like.dtype)
    big = 1e7
    A = torch.zeros(20, 12, dtype=like.dtype, device=like.device)
    lbs, ubs = [], []
    zero = torch.zeros_like(c[:, 0])
    for leg in range(4):
      A[5 * leg, 3 * leg + 2] = 1.0
      lbs.append(c[:, leg] * f_min - (1 - c[:, leg]) * 1e-7)
      ubs.append(c[:, leg] * f_max + (1 - c[:, leg]) * 1e-7)
      for k, (cx, cy) in enumerate(((1, 0), (-1, 0), (0, 1), (0, -1))):
        A[5 * leg + 1 + k, 3 * leg: 3 * leg + 3] = t(
            [cx, cy, friction_coef])
        lbs.append(zero)
        ubs.append(zero + big)
    f = _admm_box_qp(P, q, A.expand(E, 20, 12), torch.stack(lbs, -1),
                     torch.stack(ubs, -1), iters, rho=0.1, sigma=1e-6)
  return -f.reshape(E, 4, 3)
