"""Rigid-body dynamics for floating-base revolute trees (torch mirror of
vision4leg_tpu.physics.engine).

Generalized velocity v = [omega_world(3), v_base_world(3), qd(J)]; mass
matrix from world-frame COM Jacobians (M = sum J^T I J); bias forces by
point-form Newton-Euler at qddot = 0; penalty contacts supplied by a
contact function; semi-implicit Euler.  Every function takes leading
batch dimensions on the state, and on the model's inertial/joint arrays
(`a1.apply_dynamics` of a batch).  On flat ground the env steps through
the physics window (`ops/physics_envlast.py`, its plain version); this
per-env engine serves the reset's one-time settle, the non-flat
terrains' steps and the parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from vision4leg_torch.physics import maths
from vision4leg_torch.physics.model import Model


@dataclasses.dataclass
class PhysState:
  pos: torch.Tensor       # (..., 3) base origin, world
  quat: torch.Tensor      # (..., 4) wxyz base->world
  joint_q: torch.Tensor   # (..., J)
  ang: torch.Tensor       # (..., 3) base angular velocity, world
  lin: torch.Tensor       # (..., 3) base linear velocity, world
  joint_qd: torch.Tensor  # (..., J)

  def replace(self, **kw) -> "PhysState":
    return dataclasses.replace(self, **kw)


class Kin(NamedTuple):
  R: torch.Tensor      # (..., B, 3, 3) body->world
  p: torch.Tensor      # (..., B, 3) body origins
  com_w: torch.Tensor  # (..., B, 3)
  ax_w: torch.Tensor   # (..., J, 3) joint axes, world
  jp_w: torch.Tensor   # (..., J, 3) joint anchors (= p[1:])


ContactFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]


def zero_state(model: Model, batch: tuple = ()) -> PhysState:
  z = lambda n: torch.zeros(batch + (n,), device=model.device)
  quat = z(4)
  quat[..., 0] = 1.0
  return PhysState(pos=z(3), quat=quat, joint_q=z(model.njoint), ang=z(3),
                   lin=z(3), joint_qd=z(model.njoint))


def _mm(A, B):
  """(..., m, k) @ (..., k, n) as broadcast mul + sum."""
  return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _mv(A, x):
  return torch.sum(A * x[..., None, :], dim=-1)


def _rodrigues(axes, angles):
  """(L, 3) constant axes, (..., L) angles -> (..., L, 3, 3)."""
  c = torch.cos(angles)[..., None, None]
  s = torch.sin(angles)[..., None, None]
  K = maths.skew(axes)
  aaT = axes[:, :, None] * axes[:, None, :]
  eye = torch.eye(3, device=axes.device)
  return c * eye + s * K + (1.0 - c) * aaT


def fwd_kinematics(model: Model, state: PhysState) -> Kin:
  """Frames root->leaves, one batch of ops per tree level."""
  nb = model.nbody
  R_list = [None] * nb
  p_list = [None] * nb
  ax_list = [None] * (nb - 1)
  R_list[0] = maths.quat_to_mat(state.quat)
  p_list[0] = state.pos
  for level in model.levels:
    jl = [b - 1 for b in level]
    plz = [model.parent[b] for b in level]
    Rp = torch.stack([R_list[i] for i in plz], dim=-3)   # (...,L,3,3)
    pp = torch.stack([p_list[i] for i in plz], dim=-2)   # (...,L,3)
    offs = model.joint_offset[jl]
    axes = model.joint_axis[jl]
    q = state.joint_q[..., jl]
    p_lvl = pp + _mv(Rp, offs)
    R_lvl = _mm(Rp, _rodrigues(axes, q))
    ax_lvl = _mv(Rp, axes)
    for k, b in enumerate(level):
      R_list[b] = R_lvl[..., k, :, :]
      p_list[b] = p_lvl[..., k, :]
      ax_list[b - 1] = ax_lvl[..., k, :]
  R = torch.stack(R_list, dim=-3)
  p = torch.stack(p_list, dim=-2)
  ax = torch.stack(ax_list, dim=-2)
  com_w = p + _mv(R, model.com)
  return Kin(R=R, p=p, com_w=com_w, ax_w=ax, jp_w=p[..., 1:, :])


def _swap(A):
  return A.transpose(-1, -2)


def point_jacobian(model: Model, kin: Kin, x, bodies) -> torch.Tensor:
  """Translational Jacobians (..., P, 3, nv) of world points x (..., P, 3)
  attached to the static body indices `bodies`."""
  mask = model.ancestor_mask[list(bodies)]                 # (P, J)
  r_joint = x[..., :, None, :] - kin.jp_w[..., None, :, :]  # (...,P,J,3)
  cols_j = torch.linalg.cross(
      kin.ax_w[..., None, :, :].expand_as(r_joint), r_joint) * mask[..., None]
  base_rot = _swap(maths.skew(x - kin.p[..., None, 0, :]))
  eye = torch.eye(3, device=x.device).expand_as(base_rot)
  return torch.cat([base_rot, eye, _swap(cols_j)], dim=-1)


def _body_jacobians(model: Model, kin: Kin):
  """(Jw, Jv), each (..., B, 3, nv), at the body COMs."""
  nb = model.nbody
  mask = model.ancestor_mask                               # (B, J)
  batch = kin.p.shape[:-2]
  dev = kin.p.device
  Jw_base = torch.cat([torch.eye(3, device=dev),
                       torch.zeros(3, 3, device=dev)], dim=1)
  Jw_joints = _swap(kin.ax_w)[..., None, :, :] * mask[:, None, :]
  Jw = torch.cat([Jw_base.expand(batch + (nb, 3, 6)), Jw_joints], dim=-1)
  r_base = kin.com_w - kin.p[..., 0:1, :]
  Jv_rot = _swap(maths.skew(r_base))
  r_joint = kin.com_w[..., :, None, :] - kin.jp_w[..., None, :, :]
  Jv_joints = _swap(torch.linalg.cross(
      kin.ax_w[..., None, :, :].expand_as(r_joint), r_joint)
      * mask[..., None])
  Jv = torch.cat([Jv_rot, torch.eye(3, device=dev).expand(batch + (nb, 3, 3)),
                  Jv_joints], dim=-1)
  return Jw, Jv


def _world_inertia(model: Model, kin: Kin):
  return _mm(_mm(kin.R, model.inertia), _swap(kin.R))


def mass_matrix(model: Model, kin: Kin) -> torch.Tensor:
  """(..., nv, nv) joint-space inertia via CRB in world coordinates."""
  Jw, Jv = _body_jacobians(model, kin)
  Iw = _world_inertia(model, kin)
  mJv = model.mass[..., :, None, None] * Jv
  IwJw = _mm(Iw, Jw)
  flat = lambda A: A.reshape(A.shape[:-3] + (-1, A.shape[-1]))
  return (torch.einsum("...kv,...kw->...vw", flat(mJv), flat(Jv))
          + torch.einsum("...kv,...kw->...vw", flat(Jw), flat(IwJw)))


def body_velocities(model: Model, state: PhysState, kin: Kin):
  """Per-body (omega, v_com, alpha_bias, a_com_bias), each (..., B, 3)."""
  nb = model.nbody
  zero3 = torch.zeros_like(state.lin)
  om = [zero3] * nb
  al = [zero3] * nb
  vr = [zero3] * nb
  ar = [zero3] * nb
  rf = [zero3] * nb
  om[0] = state.ang
  vr[0] = state.lin
  rf[0] = kin.p[..., 0, :]
  cross = torch.linalg.cross
  for level in model.levels:
    jl = [b - 1 for b in level]
    plz = [model.parent[b] for b in level]
    st = lambda lst: torch.stack([lst[i] for i in plz], dim=-2)
    om_p, al_p, vr_p, ar_p = st(om), st(al), st(vr), st(ar)
    jpw = kin.jp_w[..., jl, :]
    r = jpw - st(rf)
    a = kin.ax_w[..., jl, :]
    qd = state.joint_qd[..., jl][..., None]
    om_l = om_p + a * qd
    al_l = al_p + cross(om_p, a) * qd
    vr_l = vr_p + cross(om_p, r)
    ar_l = ar_p + cross(al_p, r) + cross(om_p, cross(om_p, r))
    for k, b in enumerate(level):
      om[b] = om_l[..., k, :]
      al[b] = al_l[..., k, :]
      vr[b] = vr_l[..., k, :]
      ar[b] = ar_l[..., k, :]
      rf[b] = jpw[..., k, :]
  omega = torch.stack(om, dim=-2)
  alpha = torch.stack(al, dim=-2)
  v_ref = torch.stack(vr, dim=-2)
  a_ref = torch.stack(ar, dim=-2)
  rc = kin.com_w - torch.stack(rf, dim=-2)
  v_com = v_ref + cross(omega, rc)
  a_com = a_ref + cross(alpha, rc) + cross(omega, cross(omega, rc))
  return omega, v_com, alpha, a_com


def bias_forces(model: Model, state: PhysState, kin: Kin) -> torch.Tensor:
  """Coriolis + centrifugal + gravity h(q, v); M vdot + h = tau + Jc^T f."""
  Jw, Jv = _body_jacobians(model, kin)
  omega, _, alpha, a_com = body_velocities(model, state, kin)
  Iw = _world_inertia(model, kin)
  F = model.mass[..., :, None] * (a_com - model.gravity)
  T = _mv(Iw, alpha) + torch.linalg.cross(omega, _mv(Iw, omega))
  return (torch.sum(Jv * F[..., None], dim=(-3, -2))
          + torch.sum(Jw * T[..., None], dim=(-3, -2)))


def gen_velocity(state: PhysState) -> torch.Tensor:
  return torch.cat([state.ang, state.lin, state.joint_qd], dim=-1)


def contact_points_world(model: Model, state: PhysState, kin: Kin):
  """World positions (..., P, 3), velocities and Jacobians of the
  collision points."""
  idx = list(model.cp_body)
  pos = kin.p[..., idx, :] + _mv(kin.R[..., idx, :, :], model.cp_offset)
  Jp = point_jacobian(model, kin, pos, model.cp_body)
  v = torch.sum(Jp * gen_velocity(state)[..., None, None, :], dim=-1)
  return pos, v, Jp


def joint_limit_torque(model: Model, state: PhysState, k_lim: float = 300.0,
                       d_lim: float = 1.0):
  q, qd = state.joint_q, state.joint_qd
  below = torch.clamp(model.joint_lower - q, min=0.0)
  above = torch.clamp(q - model.joint_upper, min=0.0)
  viol = (below > 0) | (above > 0)
  return k_lim * (below - above) - d_lim * qd * viol


def solve_spd_cg(M: torch.Tensor, b: torch.Tensor,
                 iters: int = 16) -> torch.Tensor:
  """Jacobi-preconditioned CG, fixed iteration count. M (..., n, n)."""
  vdot = lambda a, c: torch.sum(a * c, dim=-1, keepdim=True)
  mv = lambda A, v: torch.sum(A * v[..., None, :], dim=-1)
  dinv = 1.0 / torch.diagonal(M, dim1=-2, dim2=-1)
  x = b * dinv
  r = b - mv(M, x)
  z = dinv * r
  p = z
  rz = vdot(r, z)
  for _ in range(iters):
    Mp = mv(M, p)
    alpha = rz / torch.clamp(vdot(p, Mp), min=1e-12)
    x = x + alpha * p
    r = r - alpha * Mp
    z = dinv * r
    rz_new = vdot(r, z)
    p = z + (rz_new / torch.clamp(rz, min=1e-12)) * p
    rz = rz_new
  return x


def fwd_dynamics(model: Model, state: PhysState, tau_joints,
                 contact_fn: ContactFn, solver: str = "chol"):
  kin = fwd_kinematics(model, state)
  M = mass_matrix(model, kin)
  h = bias_forces(model, state, kin)
  cpos, cvel, Jp = contact_points_world(model, state, kin)
  f_c, penetration = contact_fn(cpos, cvel, model.cp_radius)
  tau_c = torch.sum(Jp * f_c[..., None], dim=(-3, -2))
  tau_j = (tau_joints + joint_limit_torque(model, state)
           - model.joint_damping * state.joint_qd
           - model.joint_friction * torch.tanh(state.joint_qd / 0.05))
  tau = torch.cat([torch.zeros_like(tau_j[..., :6]), tau_j], dim=-1)
  arm = torch.cat([torch.zeros(6, device=M.device), model.armature])
  Mr = M + torch.diag(arm)
  rhs = tau + tau_c - h
  if solver == "cg":
    vdot = solve_spd_cg(Mr, rhs)
  else:
    # cholesky_ex: no device sync, and a failed factorization gives NaN
    # as jnp.linalg.cholesky does (a diverged env ends its episode there)
    L, info = torch.linalg.cholesky_ex(Mr)
    vdot = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    vdot = torch.where((info == 0)[..., None], vdot,
                       torch.full_like(vdot, float("nan")))
  return vdot, kin, penetration, f_c


def integrate(model: Model, state: PhysState, vdot) -> PhysState:
  """Semi-implicit Euler: velocities first, then positions."""
  dt = model.dt
  ang = state.ang + dt * vdot[..., 0:3]
  lin = state.lin + dt * vdot[..., 3:6]
  qd = state.joint_qd + dt * vdot[..., 6:]
  return PhysState(pos=state.pos + dt * lin,
                   quat=maths.quat_integrate(state.quat, ang, dt),
                   joint_q=state.joint_q + dt * qd, ang=ang, lin=lin,
                   joint_qd=qd)


def step(model: Model, state: PhysState, tau_joints, contact_fn: ContactFn,
         solver: str = "chol"):
  """One substep. Returns (new state, penetration (..., P, 2), forces)."""
  vdot, _, penetration, f_c = fwd_dynamics(model, state, tau_joints,
                                           contact_fn, solver=solver)
  return integrate(model, state, vdot), penetration, f_c
