"""Convex MPC for quadruped stance control, batched over envs (torch
mirror of vision4leg_tpu.mpc.convex_mpc): the cold adaptive-rho solve and
the warm-started per-tick path.

Reference: mpc_controller/mpc_osqp.cc (MIT-style convex MPC):
  * 13-dim state [rpy(3), pos(3), omega(3), vel(3), -g] with rpy-rate
    kinematics A(psi) and contact-force input matrix B from world-frame
    foot positions;
  * zero-order-hold discretization (closed form: A is nilpotent);
  * condensed horizon-H QP over contact forces:
      min  (A_qp x0 + B_qp U - X_ref)^T L (A_qp x0 + B_qp U - X_ref)
           + U^T alpha U
    with 5 friction-pyramid rows per leg per step; fz bounds scaled by the
    contact state, fz_max = mass * g * 10.

Cold solve (`compute_contact_forces`, the accuracy reference of the warm
path): modified Ruiz equilibration of each env's QP, then an OSQP-style
ADMM whose penalty rho is rebalanced per env every `adapt_every`
iterations by the primal/dual residual ratio, with a fresh KKT inverse
(`torch.linalg.inv`, LU) at each rho; the friction pyramids stay in
block-diagonal (5, 3) form (`_admm_box_qp_blockdiag`).  `_admm_box_qp`
is the same solver for a dense constraint matrix (the QP torque
optimizer's).

Warm path (what the MPC env's hot loop runs): the Ruiz scaling D, E, c
and the sigma/rho penalties are frozen per MpcConfig from a canonical
standing problem (`canonical_constants`); one exact KKT inverse per env
step (`kkt_inverse`, from the step-start pose) serves every controller
tick of the step, each tick refining it by Newton-Schulz and running
`warm_iters` fixed-penalty ADMM iterations from the carried iterates
(`compute_contact_forces_warm`).

Every function takes a leading env axis E.  The solvers' products never
run in TF32: `compute_contact_forces`, `compute_contact_forces_warm` and
`kkt_inverse` turn TF32 matmuls off for their duration and restore the
caller's setting (the QP's KKT matrix has cond ~1e6 after the sigma
floor; 10-bit mantissas turn the iteration into noise).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

STATE_DIM = 13
CONSTRAINT_DIM = 5
GRAVITY = 9.8
KMAX_SCALE = 10.0


class MpcConfig(NamedTuple):
  mass: float
  inertia: tuple           # 9 values, row-major 3x3 (body frame)
  num_legs: int = 4
  horizon: int = 10
  timestep: float = 0.025
  qp_weights: tuple = ()   # 13 values
  alpha: float = 1e-5
  admm_iters: int = 50     # the cold solve's iteration budget
  rho: float = 0.1
  sigma: float = 1e-6
  # warm-started per-tick path (compute_contact_forces_warm)
  warm_iters: int = 15
  ns_iters: int = 1


@contextlib.contextmanager
def no_tf32():
  """Full float32 matmuls on CUDA whatever the caller's TF32 setting."""
  prev = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = prev


def _a_matrix(rpy):
  """(E, 3) -> (E, 13, 13)."""
  cy, sy = torch.cos(rpy[:, 2]), torch.sin(rpy[:, 2])
  # clamp pitch: tan/sec blow up at +-pi/2 (a fallen robot mid-episode
  # reaches that); the exploded A would cascade into a NaN KKT system
  p = torch.clamp(rpy[:, 1], -1.4, 1.4)
  cp, tp = torch.cos(p), torch.tan(p)
  E = rpy.shape[0]
  A = rpy.new_zeros(E, STATE_DIM, STATE_DIM)
  A[:, 0, 6] = cy / cp
  A[:, 0, 7] = sy / cp
  A[:, 1, 6] = -sy
  A[:, 1, 7] = cy
  A[:, 2, 6] = cy * tp
  A[:, 2, 7] = sy * tp
  A[:, 2, 8] = 1.0
  A[:, 3, 9] = 1.0
  A[:, 4, 10] = 1.0
  A[:, 5, 11] = 1.0
  A[:, 11, 12] = 1.0
  return A


def _skew(v):
  """(..., 3) -> (..., 3, 3)."""
  x, y, z = v.unbind(-1)
  zero = torch.zeros_like(x)
  return torch.stack([torch.stack([zero, -z, y], -1),
                      torch.stack([z, zero, -x], -1),
                      torch.stack([-y, x, zero], -1)], -2)


def _b_matrix(inv_mass, inv_inertia_world, foot_positions_world):
  """(E, 3, 3), (E, n, 3) -> B (E, 13, 3n)."""
  E, n = foot_positions_world.shape[:2]
  B = foot_positions_world.new_zeros(E, STATE_DIM, 3 * n)
  ang = inv_inertia_world[:, None] @ _skew(foot_positions_world)  # (E,n,3,3)
  B[:, 6:9] = ang.permute(0, 2, 1, 3).reshape(E, 3, 3 * n)
  for i in range(n):
    B[:, 9, 3 * i] = inv_mass
    B[:, 10, 3 * i + 1] = inv_mass
    B[:, 11, 3 * i + 2] = inv_mass
  return B


def _rpy_to_rot(rpy):
  """Extrinsic X-Y-Z rotation (ConvertRpyToRot), (E, 3) -> (E, 3, 3)."""
  cr, sr = torch.cos(rpy[:, 0]), torch.sin(rpy[:, 0])
  cp, sp = torch.cos(rpy[:, 1]), torch.sin(rpy[:, 1])
  cy, sy = torch.cos(rpy[:, 2]), torch.sin(rpy[:, 2])
  one, zero = torch.ones_like(cr), torch.zeros_like(cr)
  m = lambda rows: torch.stack([torch.stack(r, -1) for r in rows], -2)
  Rx = m([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
  Ry = m([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
  Rz = m([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
  return Rz @ Ry @ Rx


def _friction_cone_rows(mu):
  """(...,) -> (..., 5, 3) friction pyramid blocks."""
  one, zero = torch.ones_like(mu), torch.zeros_like(mu)
  rows = [[-one, zero, mu], [one, zero, mu], [zero, -one, mu],
          [zero, one, mu], [zero, zero, one]]
  return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rows(x, E):
  """A (3,) or (E, k) tensor as (E, k)."""
  return x.expand(E, x.shape[-1]) if x.dim() == 1 else x


_CONSTS: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _qp_consts(cfg: MpcConfig, like: torch.Tensor) -> Dict[str, torch.Tensor]:
  """The QP's constant tensors for cfg on `like`'s device and dtype, made
  once (so that no tick copies from the host)."""
  key = (cfg, like.device, like.dtype)
  if key not in _CONSTS:
    dtype, dev = like.dtype, like.device
    H, adim = cfg.horizon, 3 * cfg.num_legs
    np_t = np.float64 if dtype == torch.float64 else np.float32
    inertia = np.asarray(cfg.inertia, np_t).reshape(3, 3)
    ii = torch.arange(H, device=dev)[:, None]
    jj = torch.arange(H, device=dev)[None, :]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    _CONSTS[key] = dict(
        inv_inertia=t(np.linalg.inv(inertia)),
        L_diag=t(np.tile(np.asarray(cfg.qp_weights, np_t), H)),
        # dt * k in float32 for every dtype, as the reference computes it
        dts=(cfg.timestep * torch.arange(1, H + 1, dtype=torch.float32,
                                         device=dev))[None],
        idx=torch.clamp(ii - jj, 0, H - 1),
        lower=(jj <= ii)[None, :, :, None, None].to(dtype),
        eye13=torch.eye(STATE_DIM, dtype=dtype, device=dev),
        eye_n=torch.eye(H * adim, dtype=dtype, device=dev),
        z025=t([0.0, 0.0, 0.25]))
  return _CONSTS[key]


def _build_qp(cfg: MpcConfig, com_position, com_velocity, com_roll_pitch_yaw,
              com_angular_velocity, foot_contact_states, foot_positions_body,
              foot_friction_coeffs, desired_com_position,
              desired_com_velocity, desired_com_rpy, desired_com_ang_vel):
  """Condensed-QP data (P (E,n,n), q (E,n), cone blocks (E,H*legs,5,3),
  lb, ub (E,m)) of one MPC problem per env.  com_position is (E, 3), or
  (E, 1) to take the body height from the feet in contact; the desired
  values may be (3,) for all envs."""
  rpy = com_roll_pitch_yaw
  E = rpy.shape[0]
  n = cfg.num_legs
  H = cfg.horizon
  dt = cfg.timestep
  k = _qp_consts(cfg, rpy)
  d_pos = _rows(desired_com_position, E)
  d_vel = _rows(desired_com_velocity, E)
  d_rpy = _rows(desired_com_rpy, E)
  d_ang = _rows(desired_com_ang_vel, E)

  rot = _rpy_to_rot(rpy)
  foot_world = foot_positions_body @ rot.mT                 # (E, n, 3)

  # body height from the feet in contact when the absolute z is unknown
  contacts = foot_contact_states.to(rpy.dtype)
  if com_position.shape[-1] == 3:
    com_z = com_position[:, 2]
  else:
    com_z = torch.abs(torch.sum(foot_world[..., 2] * contacts, -1)
                      / torch.clamp(torch.sum(contacts, -1), min=1.0))

  zero = torch.zeros_like(com_z)
  x0 = torch.cat([rpy, torch.stack([zero, zero, com_z], -1),
                  com_angular_velocity, com_velocity,
                  torch.full_like(com_z, -GRAVITY)[:, None]], -1)

  dts = k["dts"]                                            # (1, H)
  x_ref = rpy.new_zeros(E, H, STATE_DIM)
  x_ref[:, :, 0] = d_rpy[:, 0:1]
  x_ref[:, :, 1] = d_rpy[:, 1:2]
  x_ref[:, :, 2] = rpy[:, 2:3] + dts * d_ang[:, 2:3]
  x_ref[:, :, 3] = dts * d_vel[:, 0:1]
  x_ref[:, :, 4] = dts * d_vel[:, 1:2]
  x_ref[:, :, 5] = d_pos[:, 2:3]
  x_ref[:, :, 6:9] = d_ang[:, None]
  x_ref[:, :, 9] = d_vel[:, 0:1]
  x_ref[:, :, 10] = d_vel[:, 1:2]
  # vz reference 0 ("prefer to stabilize body height"), x[12] = -g
  x_ref[:, :, 12] = -GRAVITY
  x_ref = x_ref.reshape(E, -1)

  A = _a_matrix(rpy)
  inv_inertia_world = rot @ k["inv_inertia"] @ rot.mT
  B = _b_matrix(1.0 / cfg.mass, inv_inertia_world, foot_world)

  # ZOH discretization in closed form: A is nilpotent of index 3 (pure
  # integrator chains plus the z <- gravity drift), so expm([[A, B],
  # [0, 0]] dt) is a quadratic polynomial in A
  adim = 3 * n
  eye = k["eye13"]
  A2 = A @ A
  A_exp = eye + dt * A + (dt * dt / 2.0) * A2
  B_exp = (dt * eye + (dt * dt / 2.0) * A + (dt ** 3 / 6.0) * A2) @ B

  # condensed prediction matrices: A^1..A^H
  powers = []
  Ak = eye.expand(E, STATE_DIM, STATE_DIM)
  for _ in range(H):
    Ak = A_exp @ Ak
    powers.append(Ak)
  a_powers = torch.stack(powers, 1)                        # (E, H, 13, 13)
  A_qp = a_powers.reshape(E, H * STATE_DIM, STATE_DIM)

  # anb[i] = A^i B (i = 0..H-1); B_qp[i, j] = A^(i-j) B for j <= i
  anb = torch.cat([B_exp[:, None], a_powers[:, :-1] @ B_exp[:, None]], 1)
  blocks = anb[:, k["idx"]] * k["lower"]
  B_qp = blocks.permute(0, 1, 3, 2, 4).reshape(E, H * STATE_DIM, H * adim)

  L_diag = k["L_diag"]                                      # (H*13,)
  P = 2.0 * (B_qp.mT * L_diag) @ B_qp
  P = P + cfg.alpha * k["eye_n"]
  state_diff = (A_qp @ x0[..., None])[..., 0] - x_ref
  q = 2.0 * (B_qp.mT @ (L_diag * state_diff)[..., None])[..., 0]

  # constraints: block-diagonal friction pyramids, (H*n) blocks of (5, 3)
  fric = foot_friction_coeffs
  cone = _friction_cone_rows(fric.repeat(1, H))            # (E, H*n, 5, 3)
  fz_max = cfg.mass * GRAVITY * KMAX_SCALE
  fz_min = 0.0
  cs = contacts.repeat(1, H)                                # (E, H*n)
  mu0 = fric[:, 0:1]
  ub_blk = torch.stack([(mu0 + 1) * fz_max * cs] * 4 + [fz_max * cs], -1)
  lb_blk = torch.cat([torch.zeros_like(ub_blk[..., :4]),
                      (fz_min * cs)[..., None]], -1)
  return P, q, cone, lb_blk.reshape(E, -1), ub_blk.reshape(E, -1)


# ---------------------------------------------------------------------------
# the cold solve
# ---------------------------------------------------------------------------

def _block_add(K, blocks, scale):
  """K (E, M*c, M*c) with scale * blocks (E, M, c, c) added to its
  diagonal blocks (in place on K, which is returned); scale is a number
  or (E, 1, 1, 1)."""
  E, M, c, _ = blocks.shape
  K.view(E, M, c, M, c).diagonal(dim1=1, dim2=3).add_(
      (scale * blocks).permute(0, 2, 3, 1))
  return K


def _cost_scaling(Ps, Dq):
  """OSQP's cost normalization c (E,) of the variable-scaled P and D q."""
  return 1.0 / torch.clamp(torch.maximum(
      torch.mean(torch.amax(torch.abs(Ps), dim=-2), dim=-1),
      torch.amax(torch.abs(Dq), dim=-1)), min=1e-12)


def _ruiz_equilibrate(P, q, A, lb, ub, iters: int = 10):
  """Modified Ruiz equilibration of each env's QP (OSQP sec. 5.1): scales
  the variables by D and the constraints by E so that every row and
  column of [[P, A^T], [A, 0]] has unit inf-norm, then the cost by c.
  P (E, n, n), q (E, n), A (E, m, n), lb, ub (E, m).  Returns the scaled
  (P, q, A, lb, ub) and D (E, n) (x = D x_bar).  The A1's SRB inertia
  gives the condensed P a ~1e7 dynamic range (B carries 1/I)."""
  Dv = torch.ones_like(q)
  Ev = torch.ones_like(lb)
  for _ in range(iters):
    Ps = Dv[:, :, None] * P * Dv[:, None, :]
    As = Ev[:, :, None] * A * Dv[:, None, :]
    col = torch.maximum(torch.amax(torch.abs(Ps), dim=-2),
                        torch.amax(torch.abs(As), dim=-2))
    row = torch.amax(torch.abs(As), dim=-1)
    Dv = Dv / torch.sqrt(torch.clamp(col, min=1e-12))
    Ev = Ev / torch.sqrt(torch.clamp(row, min=1e-12))
  Ps = Dv[:, :, None] * P * Dv[:, None, :]
  c = _cost_scaling(Ps, Dv * q)[:, None]
  return (c[..., None] * Ps, c * Dv * q, Ev[:, :, None] * A * Dv[:, None, :],
          Ev * lb, Ev * ub, Dv)


def _ruiz_equilibrate_blockdiag(P, q, blocks, lb, ub, iters: int = 10):
  """_ruiz_equilibrate for a block-diagonal constraint matrix: blocks
  (E, M, r, c), block i touching only variables [c i, c (i + 1)).  The
  row and column inf-norms decompose per block, so the dense (M r, M c)
  matrix is never built; A comes back in block form."""
  E, M, r, cb = blocks.shape
  Dv = torch.ones_like(q)
  Ev = torch.ones_like(lb)
  for _ in range(iters):
    Ps = Dv[:, :, None] * P * Dv[:, None, :]
    As = (Ev.reshape(E, M, r)[..., None] * blocks
          * Dv.reshape(E, M, cb)[:, :, None, :])
    col_a = torch.amax(torch.abs(As), dim=2).reshape(E, -1)
    col = torch.maximum(torch.amax(torch.abs(Ps), dim=-2), col_a)
    row = torch.amax(torch.abs(As), dim=3).reshape(E, -1)
    Dv = Dv / torch.sqrt(torch.clamp(col, min=1e-12))
    Ev = Ev / torch.sqrt(torch.clamp(row, min=1e-12))
  Ps = Dv[:, :, None] * P * Dv[:, None, :]
  c = _cost_scaling(Ps, Dv * q)[:, None]
  As = (Ev.reshape(E, M, r)[..., None] * blocks
        * Dv.reshape(E, M, cb)[:, :, None, :])
  return c[..., None] * Ps, c * Dv * q, As, Ev * lb, Ev * ub, Dv


def _admm(P, q, lb, ub, a_mv, at_mv, add_ata, iters: int, rho: float,
          sigma: float, adapt_every: int):
  """The OSQP-style ADMM of the cold solve on equilibrated data, for
  constraint products a_mv / at_mv and a function add_ata(K, rho (E,))
  that adds rho A^T A to K.  Each env keeps its own rho: it starts at
  rho times the trace scale of its P, and every adapt_every iterations
  it is rebalanced by the residual ratio (OSQP sec. 5.2) when the
  suggested change exceeds 5x, with a fresh K^-1.  sigma is floored at
  1e-6 of a Gershgorin bound of lam_max(P), which keeps K invertible in
  float32 for the near-singular condensed P.  Every x-update takes one
  iterative-refinement step against the explicit inverse.  Returns the
  scaled x (E, n)."""
  E, n = q.shape
  eye = torch.eye(n, dtype=P.dtype, device=P.device)
  scale = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).sum(-1) / n,
                      min=1e-9)
  rho_v = rho * scale
  lam_max = torch.amax(torch.sum(torch.abs(P), dim=-1), dim=-1)
  sig = torch.maximum(sigma * scale, 1e-6 * lam_max)[:, None]
  mv = lambda A, v: (A @ v[..., None])[..., 0]
  norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
  x = torch.zeros_like(q)
  z = torch.minimum(torch.maximum(torch.zeros_like(lb), lb), ub)
  y = torch.zeros_like(lb)
  for _ in range(max(iters // adapt_every, 1)):
    # LU, not Cholesky: near cond(K) ~ 1 / eps the float32 Cholesky can
    # lose positive-definiteness to rounding; the pivoted LU stays stable
    K = add_ata(P + sig[..., None] * eye, rho_v)
    Kinv = torch.linalg.inv(K)
    r = rho_v[:, None]
    for _ in range(adapt_every):
      rhs = sig * x - q + at_mv(r * z - y)
      x = mv(Kinv, rhs)
      x = x + mv(Kinv, rhs - mv(K, x))
      Ax = a_mv(x)
      z_new = torch.minimum(torch.maximum(Ax + y / r, lb), ub)
      y = y + r * (Ax - z_new)
      z = z_new
    Ax = a_mv(x)
    r_prim = norm(Ax - z) / torch.clamp(torch.maximum(norm(Ax), norm(z)),
                                        min=1e-6)
    r_dual = norm(mv(P, x) + q + at_mv(y)) / torch.clamp(norm(q), min=1e-6)
    ratio = torch.sqrt(r_prim / torch.clamp(r_dual, min=1e-12))
    sug = torch.minimum(torch.maximum(
        rho_v * torch.clamp(ratio, 0.1, 10.0), 1e-6 * scale), 1e6 * scale)
    big = torch.maximum(sug / rho_v, rho_v / sug) > 5.0
    rho_v = torch.where(big, sug, rho_v)
  return x


def _admm_box_qp(P, q, A, lb, ub, iters: int, rho: float, sigma: float,
                 adapt_every: int = 25):
  """min 1/2 x^T P x + q^T x s.t. lb <= A x <= ub for every env: P (E, n,
  n), q (E, n), A (E, m, n), lb, ub (E, m); Ruiz-equilibrated, then
  `_admm`.  Returns x (E, n)."""
  P, q, A, lb, ub, D = _ruiz_equilibrate(P, q, A, lb, ub)
  AtA = A.mT @ A
  x = _admm(P, q, lb, ub, lambda v: (A @ v[..., None])[..., 0],
            lambda w: (A.mT @ w[..., None])[..., 0],
            lambda K, r: K + r[:, None, None] * AtA, iters, rho, sigma,
            adapt_every)
  return D * x


def _admm_box_qp_blockdiag(P, q, blocks, lb, ub, iters: int, rho: float,
                           sigma: float, adapt_every: int = 25):
  """_admm_box_qp for a block-diagonal constraint matrix of blocks
  (E, M, r, c) (the MPC's friction pyramids: each horizon step's leg
  couples its 3 force components to its own 5 rows): A x and A^T y are
  block einsums and A^T A is M (c, c) blocks added to K's diagonal.
  Returns x (E, M c)."""
  P, q, As, lb, ub, D = _ruiz_equilibrate_blockdiag(P, q, blocks, lb, ub)
  E, M, r, cb = As.shape
  AtA = torch.einsum("emij,emik->emjk", As, As)
  x = _admm(
      P, q, lb, ub,
      lambda v: torch.einsum("emij,emj->emi", As, v.reshape(E, M, cb)
                             ).reshape(E, -1),
      lambda w: torch.einsum("emij,emi->emj", As, w.reshape(E, M, r)
                             ).reshape(E, -1),
      lambda K, rv: _block_add(K, AtA, rv[:, None, None, None]),
      iters, rho, sigma, adapt_every)
  return D * x


def compute_contact_forces(cfg: MpcConfig, *state_args):
  """The cold solve of every env's MPC problem (state_args those of
  `_build_qp`): Ruiz equilibration, adaptive-rho ADMM over
  cfg.admm_iters iterations, a fresh KKT inverse at each rho.  Returns
  the first step's forces (E, legs, 3), the ground reaction negated as
  the stance controller consumes it."""
  with no_tf32():
    P, q, cone, lb, ub = _build_qp(cfg, *state_args)
    u = _admm_box_qp_blockdiag(P, q, cone, lb, ub, cfg.admm_iters, cfg.rho,
                               cfg.sigma)
  E = u.shape[0]
  return -u[:, : 3 * cfg.num_legs].reshape(E, cfg.num_legs, 3)


# ---------------------------------------------------------------------------
# the warm-started per-tick path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CanonicalScaling:
  D: torch.Tensor        # (n,) variable scaling
  E: torch.Tensor        # (m,) constraint scaling
  c: torch.Tensor        # () cost scaling
  sigma: torch.Tensor    # () proximal weight (scaled space)
  rho: torch.Tensor      # () ADMM penalty (scaled space)
  kinv0: torch.Tensor    # (n, n) exact K^-1 of the canonical problem

  def to(self, device, dtype) -> "CanonicalScaling":
    return CanonicalScaling(**{
        f.name: getattr(self, f.name).to(device=device, dtype=dtype)
        for f in dataclasses.fields(self)})


@dataclasses.dataclass
class WarmState:
  x: torch.Tensor        # (E, n) scaled primal iterate
  z: torch.Tensor        # (E, m) scaled slack iterate
  y: torch.Tensor        # (E, m) scaled dual iterate
  kinv: torch.Tensor     # (E, n, n) tracked K^-1 (scaled space)

  def replace(self, **kw) -> "WarmState":
    return dataclasses.replace(self, **kw)


def _canonical_qp(cfg: MpcConfig):
  """A canonical standing problem (nominal pose, all legs in stance) in
  float64 on the CPU."""
  f64 = dict(dtype=torch.float64)
  # nominal A1-class foot positions (base frame), float32 values as the
  # reference gives them; they only seed the scaling, which is structural
  feet = torch.tensor([[0.17, -0.13, -0.25], [0.17, 0.13, -0.25],
                       [-0.17, -0.13, -0.25], [-0.17, 0.13, -0.25]],
                      dtype=torch.float32)[: cfg.num_legs].to(**f64)
  z = torch.tensor([[0.0, 0.0, 0.25]], **f64)
  zeros = torch.zeros(1, 3, **f64)
  n = cfg.num_legs
  return _build_qp(cfg, z, zeros, zeros, zeros, torch.ones(1, n, **f64),
                   feet[None], torch.full((1, n), 0.45, **f64), z[0],
                   zeros[0], zeros[0], zeros[0])


def canonical_constants(cfg: MpcConfig) -> CanonicalScaling:
  """Frozen scaling, penalty constants and canonical K^-1 of the warm
  path, computed once per MpcConfig in float64 on the CPU (callers cast
  them with `.to(device, dtype)`)."""
  P, q, cone, lb, ub = (x[0] for x in _canonical_qp(cfg))
  M, r, c_blk = cone.shape
  n = P.shape[0]
  # the modified-Ruiz recursion (OSQP sec. 5.1) on the block-diagonal
  # constraint matrix
  E = torch.ones(M * r, dtype=torch.float64)
  Dv = torch.ones(n, dtype=torch.float64)
  for _ in range(10):
    Db = Dv.reshape(M, c_blk)
    Eb = E.reshape(M, r)
    Ps_i = Dv[:, None] * P * Dv[None, :]
    As_i = Eb[:, :, None] * cone * Db[:, None, :]
    col_a = torch.amax(torch.abs(As_i), dim=1).reshape(-1)
    col = torch.maximum(torch.amax(torch.abs(Ps_i), dim=0), col_a)
    row = torch.amax(torch.abs(As_i), dim=2).reshape(-1)
    Dv = Dv / torch.sqrt(torch.clamp(col, min=1e-12))
    E = E / torch.sqrt(torch.clamp(row, min=1e-12))
  Ps_f = Dv[:, None] * P * Dv[None, :]
  c = 1.0 / torch.clamp(
      torch.maximum(torch.mean(torch.amax(torch.abs(Ps_f), dim=0)),
                    torch.amax(torch.abs(Dv * q))), min=1e-12)
  scale = torch.clamp(torch.trace(c * Ps_f) / n, min=1e-9)
  rho = cfg.rho * scale
  lam_max = torch.amax(torch.sum(torch.abs(c * Ps_f), dim=1))
  sigma = torch.maximum(cfg.sigma * scale, 1e-6 * lam_max)
  As_f = (E.reshape(M, r)[:, :, None] * cone
          * Dv.reshape(M, c_blk)[:, None, :])
  AtA = torch.einsum("mij,mik->mjk", As_f, As_f)
  K = c * Ps_f + sigma * torch.eye(n, dtype=torch.float64)
  K = _block_add(K[None].clone(), AtA[None], rho)[0]
  kinv0 = torch.linalg.inv(K)
  return CanonicalScaling(D=Dv, E=E, c=c, sigma=sigma, rho=rho, kinv0=kinv0)


def init_warm_state(canon: CanonicalScaling, batch: int) -> WarmState:
  n = canon.D.shape[0]
  m = canon.E.shape[0]
  z = canon.D.new_zeros
  return WarmState(x=z(batch, n), z=z(batch, m), y=z(batch, m),
                   kinv=canon.kinv0.expand(batch, n, n).clone())


def _scaled_kkt(canon: CanonicalScaling, P, blocks):
  """K = P_s + sigma I + rho A^T A in the frozen canonical scaled space;
  returns (K (E,n,n), A_s (E,M,5,3))."""
  D, c = canon.D, canon.c
  E, M, r, cb = blocks.shape
  n = P.shape[-1]
  Ps = c * (D[:, None] * P * D[None, :])
  As = (canon.E.reshape(M, r)[:, :, None] * blocks
        * D.reshape(M, cb)[:, None, :])
  AtA = torch.einsum("emij,emik->emjk", As, As)
  K = Ps + canon.sigma * torch.eye(n, dtype=P.dtype, device=P.device)
  return _block_add(K, AtA, canon.rho), As


def kkt_inverse(cfg: MpcConfig, canon: CanonicalScaling, rpy_yawless,
                foot_positions_body, friction: float = 0.45):
  """Exact scaled-space KKT inverse (E, n, n) for the current pose of
  every env.

  K depends only on the feet and rpy (through B_qp -> P), not on contact
  states, bounds or the desired command, so the env computes this once
  per env step and every tick tracks the small intra-step drift with
  Newton-Schulz from this exact start.  An env whose K is singular (a
  degenerate pose) gets the canonical inverse instead; no env's result
  waits on another's."""
  E = rpy_yawless.shape[0]
  n = cfg.num_legs
  like = rpy_yawless
  z = _qp_consts(cfg, like)["z025"]
  zeros = like.new_zeros(3)
  with no_tf32():
    P, _, cone, _, _ = _build_qp(
        cfg, z.expand(E, 3), like.new_zeros(E, 3), rpy_yawless,
        like.new_zeros(E, 3), like.new_ones(E, n), foot_positions_body,
        like.new_full((E, n), friction), z, zeros, zeros, zeros)
    K, _ = _scaled_kkt(canon, P, cone)
    X, info = torch.linalg.inv_ex(K)
  ok = (info == 0) & torch.isfinite(X).all(-1).all(-1)
  return torch.where(ok[:, None, None], X, canon.kinv0)


def _solve_warm(canon: CanonicalScaling, P, q, blocks, lb, ub,
                warm: WarmState, iters: int, ns_iters: int):
  """Fixed-scaling ADMM with a Newton-Schulz-tracked KKT inverse.

  The splitting of the reference's block-diagonal ADMM with the scaling
  and penalties frozen (canon): no per-call equilibration and no
  factorization; warm.kinv is refined by `ns_iters` Newton-Schulz steps
  and the x-update keeps one iterative-refinement step, so a slightly
  stale inverse costs accuracy O(||I-KX||^2) only."""
  D, Es, c = canon.D, canon.E, canon.c
  sigma, rho = canon.sigma, canon.rho
  E, M, r, cb = blocks.shape
  n = P.shape[-1]
  qs = c * (D * q)
  lbs, ubs = Es * lb, Es * ub
  K, As = _scaled_kkt(canon, P, blocks)

  eye = torch.eye(n, dtype=P.dtype, device=P.device)
  X = warm.kinv
  for _ in range(ns_iters):          # X <- X + X(I - KX): pure matmuls
    X = X + X @ (eye - K @ X)

  def a_mv(x):
    return torch.einsum("emij,emj->emi", As, x.reshape(E, M, cb)
                        ).reshape(E, -1)

  def at_mv(w):
    return torch.einsum("emij,emi->emj", As, w.reshape(E, M, r)
                        ).reshape(E, -1)

  mv = lambda A, v: (A @ v[..., None])[..., 0]
  x, y = warm.x, warm.y
  z = torch.minimum(torch.maximum(warm.z, lbs), ubs)   # bounds may switch
  for _ in range(iters):
    rhs = sigma * x - qs + at_mv(rho * z - y)
    x_new = mv(X, rhs)
    x_new = x_new + mv(X, rhs - mv(K, x_new))   # iterative refinement
    Ax = a_mv(x_new)
    z_new = torch.minimum(torch.maximum(Ax + y / rho, lbs), ubs)
    y = y + rho * (Ax - z_new)
    x, z = x_new, z_new
  # self-heal on divergence (extreme pose, singular K): zero forces for
  # this tick, reset the carried iterates and inverse; the next env step
  # recomputes an exact K^-1 and the episode is terminating anyway
  fin = lambda v: torch.isfinite(v).reshape(E, -1).all(-1)
  ok = fin(x) & fin(z) & fin(y) & fin(X)
  okv = ok[:, None]
  x = torch.where(okv, x, 0.0)
  z = torch.where(okv, z, 0.0)
  y = torch.where(okv, y, 0.0)
  X = torch.where(okv[..., None], X, canon.kinv0)
  return D * x, WarmState(x=x, z=z, y=y, kinv=X)


def compute_contact_forces_warm(cfg: MpcConfig, canon: CanonicalScaling,
                                warm: WarmState, *state_args,
                                warm_iters: int = 15, ns_iters: int = 2):
  """Warm-started contact forces of every env: the condensed QP with the
  frozen canonical scaling, the carried iterates and the tracked K^-1.
  state_args are those of `_build_qp`.  Returns (forces (E, legs, 3),
  the ground reaction negated as the stance controller consumes it,
  and the new WarmState)."""
  with no_tf32():
    P, q, cone, lb, ub = _build_qp(cfg, *state_args)
    u, warm = _solve_warm(canon, P, q, cone, lb, ub, warm, warm_iters,
                          ns_iters)
  # the true solution lies in the friction box, so this clamp never
  # harms a correct solve but bounds a transiently diverging one before
  # it reaches the physics
  fmax = cfg.mass * GRAVITY * KMAX_SCALE * 2.0
  u = torch.clamp(u, -fmax, fmax)
  E = u.shape[0]
  return -u[:, : 3 * cfg.num_legs].reshape(E, cfg.num_legs, 3), warm

