"""Bytes and operations the physics window needs, for the roofline bound
of `ops/csrc/physics_window.cu` (the larger of bytes over the memory rate
and operations over the float32 rate).

The operations are the least that the plain version's algorithm
(`ops/physics_envlast.py`: Jacobian-product mass matrix, 16 Jacobi-PCG
iterations) needs for one run's data, not the kernel's own arithmetic:
  * one triangle of the symmetric mass matrix and world inertias;
  * a product with a structural zero (the ancestor mask, the base
    Jacobian's identity and zero blocks, a zero entry of a model constant)
    is skipped, and one with a constant +-1 is free;
  * a contact force is counted only for the (point, surface) pairs that
    touch in this run, and a point's contact velocity and generalized
    force only where it touches (`physics_envlast.window`'s `counts`);
  * what depends only on the model or on one window's inputs (scaled
    masses and inertias, friction sums, box yaw sines) once per window;
  * where a count could go either way, the lower is taken: joint-limit
    torques of violated limits, the sum of ground and obstacle forces on
    one point and the obstacle max of the post-window read are left out;
  * in hybrid mode (the MPC env) each joint's torque blend
    (1 - m) PD + m tau_ff costs 4 per substep, and the window reads 24
    more parameter rows.
Each +, -, x, /, sqrt, sin, cos, tanh, min, max and comparison counts 1
(a multiply-add counts 2); negation and copies are free.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vision4leg_torch.physics.model import Model

Z, U, G = 0, 1, 2          # entry kinds: zero, constant +-1, general
G33 = np.full((3, 3), G)
G3 = np.full((3, 1), G)
CG_ITERS = 16


def _np(x) -> np.ndarray:
  if hasattr(x, "detach"):
    x = x.detach().cpu()
  return np.asarray(x, np.float64)


def kinds(x) -> np.ndarray:
  x = _np(x)
  return np.where(x == 0, Z, np.where(np.abs(x) == 1, U, G))


def matmul(A, B, upper: bool = False) -> Tuple[int, np.ndarray]:
  """Operations of A @ B for entry kinds A (m,k) and B (k,n), and the
  product's kinds; with `upper`, only entries i <= j are computed and the
  result is mirrored (a symmetric product)."""
  C = np.zeros((A.shape[0], B.shape[1]), int)
  ops = 0
  for i in range(A.shape[0]):
    for j in range(i if upper else 0, B.shape[1]):
      terms = [(a, b) for a, b in zip(A[i], B[:, j]) if a and b]
      ops += sum(a == G and b == G for a, b in terms) + max(len(terms) - 1, 0)
      C[i, j] = Z if not terms else U if terms == [(U, U)] else G
      if upper:
        C[j, i] = C[i, j]
  return ops, C


def _nonzero(x) -> int:
  return int((np.asarray(x) != Z).sum())


def _ancestors(model: Model, b: int):
  out = []
  while b > 0:
    out.append(b - 1)
    b = model.parent[b]
  return out


def _rotation(axis) -> Tuple[int, np.ndarray]:
  """Operations and kinds of Rodrigues' rotation about a constant axis."""
  a = kinds(axis)
  if sorted(a) == [Z, Z, U]:                 # about a coordinate axis
    k = int(np.argmax(a))
    rot = np.full((3, 3), G)
    rot[k, :] = Z
    rot[:, k] = Z
    rot[k, k] = U
    return 2, rot                            # cos, sin
  return 3 + 3 * 2 + 6 * 3, np.full((3, 3), G)


def fk_ops(model: Model) -> int:
  """Frames, origins, world joint axes and com positions (fk)."""
  ops = 24                  # quat_to_mat from doubled components
  for b in range(model.nbody):
    if b > 0:
      j = b - 1
      o, off = matmul(G33, kinds(model.joint_offset[j])[:, None])
      ops += o + _nonzero(off)                       # p_b
      ops += matmul(G33, kinds(model.joint_axis[j])[:, None])[0]
      o_rot, rot = _rotation(model.joint_axis[j])
      ops += o_rot + matmul(G33, rot)[0]             # R_b
    o, rc = matmul(G33, kinds(model.com[b])[:, None])
    ops += o + _nonzero(rc)                          # com_w
  return ops


def velocity_ops(model: Model) -> int:
  """Body angular velocities and the qddot = 0 accelerations of the
  coms (body_velocities; the com velocities are not used)."""
  ops = 18                                   # trunk: w x (w x rc)
  for b in range(1, model.nbody):
    from_trunk = model.parent[b] == 0        # parent alpha, a_ref are 0
    ops += 6                                 # omega
    ops += 12 if from_trunk else 15          # alpha
    ops += 18 if from_trunk else 33          # a_ref
    ops += 33                                # a_com
  return ops


def mass_bias_ops(model: Model) -> Tuple[int, np.ndarray]:
  """Mass matrix (one triangle) and bias forces; returns the ops and the
  mass matrix's kinds (with the armature on the joint diagonal)."""
  nv = model.nv
  Mk = np.zeros((nv, nv), int)
  hk = np.zeros(nv, int)
  grav = _nonzero(kinds(model.gravity))
  ops = 0
  for b in range(model.nbody):
    o1, RI = matmul(G33, kinds(model.inertia[b]))
    o2, Iw = matmul(RI, G33, upper=True)
    ops += o1 + o2
    joints = _ancestors(model, b)
    cols = list(range(6)) + [6 + j for j in joints]
    n = len(cols)
    Jv = np.full((3, n), G)
    Jw = np.zeros((3, n), int)
    for k in range(3):
      Jv[k, k] = Z                           # e_k x r0
      Jv[:, 3 + k] = Z
      Jv[k, 3 + k] = U                       # base linear dof
      Jw[k, k] = U
    Jw[:, 6:] = G
    d = len(joints)
    # r0 = com_w - p0 (free on the trunk); a x (com_w - p_joint), where
    # com_w - p_b of the body's own joint is free
    ops += (3 if b else 0) + 9 * d + 3 * max(d - 1, 0)
    iu = np.triu_indices(n)
    o, vv = matmul(Jv.T, Jv, upper=True)
    ops += o + int((vv[iu] == G).sum())      # x mass
    o, IJ = matmul(Iw, Jw)
    ops += o
    o, ww = matmul(Jw.T, IJ, upper=True)
    ops += o + int(((vv[iu] != Z) & (ww[iu] != Z)).sum())
    for i, k in zip(*iu):
      if vv[i, k] or ww[i, k]:
        ops += int(Mk[cols[i], cols[k]] != Z)
        Mk[cols[i], cols[k]] = Mk[cols[k], cols[i]] = G
    # F = m (a_com - g), T = Iw alpha + w x Iw w; h += Jv^T F + Jw^T T
    ops += grav + 3 + (24 if b == 0 else 42)
    o1, hv = matmul(Jv.T, G3)
    o2, hw = matmul(Jw.T, G3)
    ops += o1 + o2 + int(((hv != Z) & (hw != Z)).sum())
    for i in range(n):
      if hv[i, 0] or hw[i, 0]:
        ops += int(hk[cols[i]] != Z)
        hk[cols[i]] = G
  Mk[range(6, nv), range(6, nv)] = G
  return ops, Mk


def cg_ops(Mk: np.ndarray) -> int:
  """Jacobi-PCG over the mass matrix's nonzero pattern."""
  nv = Mk.shape[0]
  nnz = (Mk != Z).sum(1)
  matvec = int((2 * nnz - 1).sum())
  dot = 2 * nv - 1
  init = nv + nv + matvec + nv + nv + dot    # dinv, x0, r, z, rz
  it = matvec + dot + 2 + 2 * nv + 2 * nv + nv + dot + 2 + 2 * nv
  return init + CG_ITERS * it


def point_ops(model: Model) -> np.ndarray:
  """Per contact point: its world position (every substep)."""
  out = []
  for c, b in enumerate(model.cp_body):
    o, x = matmul(G33, kinds(model.cp_offset[c])[:, None])
    out.append(o + _nonzero(x))
  return np.array(out)


def touching_ops(model: Model) -> np.ndarray:
  """Per contact point that touches: its velocity and generalized force
  (contact_points' Jacobian applied both ways, structural zeros out)."""
  out = []
  for b in model.cp_body:
    d = len(_ancestors(model, b))
    vel = 15 + 15 + 18 * (d - 1) if d else 12   # x - p0 free on the trunk
    tau = 15 + 15 * d
    out.append(vel + tau)
  return np.array(out)


GROUND_FORCE = 13       # vertical normal: f_n, tangential slip, friction
BOX_PHI = 27            # local frame, clamp, distance, phi
BOX_INSIDE = 8          # face gaps and the nearest one
BOX_FORCE = 46          # normal, world rotation, penalty force, sum
SPHERE_PHI = 12
SPHERE_FORCE = 40


def window_bytes_and_ops(model: Model, boxes, spheres, n_substeps: int,
                         interpolate: bool, counts: Dict[str, object],
                         hybrid: bool = False) -> Tuple[int, int]:
  """Bytes the window must move (each input read once, each output
  written once, float32) and the operations it needs, for boxes (E,K,8),
  spheres (E,Q,5) and the `counts` of the plain version's run on the same
  inputs (`physics_envlast.window`); `hybrid` for the tau_ff/mask blend."""
  E, K = boxes.shape[0], boxes.shape[1]
  Q = spheres.shape[1]
  nj, P = model.njoint, model.ncp
  n_state = 3 + 4 + nj + 3 + 3 + nj + nj + 20 * 31
  n_par = (nj * (5 if interpolate else 4) + 2 + 2 * model.nbody + 2
           + (2 * nj if hybrid else 0))
  n_in = n_state + n_par + 8 * K + 5 * Q
  n_out = n_state + 2 * P
  n_model = 384
  nbytes = 4 * (E * (n_in + n_out) + n_model)

  valid_boxes = int((boxes[..., 7] > 0.5).sum())
  valid_spheres = int((spheres[..., 4] > 0.5).sum())
  mass_ops, Mk = mass_bias_ops(model)
  pts = point_ops(model)
  fk = fk_ops(model)
  per_substep = (
      nj * (5 + (2 if interpolate else 0))  # PD torques
      + (4 * nj if hybrid else 0)           # hybrid blend
      + fk + velocity_ops(model) + mass_ops
      + int(pts.sum()) + 2 * P              # points, ground phi test
      + nj * 10 + 6 + 2 * nj + nj           # joint torques, rhs, armature
      + cg_ops(Mk)
      + 12 + 24 + 24 + 6 + 56)              # Euler, quaternion
  per_window = (model.nbody                 # scaled masses
                + sum(_nonzero(np.triu(kinds(I))) for I in model.inertia)
                + 2 * nj + (nj if interpolate else 0))
  end_read = fk + int(pts.sum()) + P
  pair_phi = P * (BOX_PHI * valid_boxes + SPHERE_PHI * valid_spheres)
  obstacles = (3 * valid_boxes + K * E + Q * E   # yaw sines, valid flags
               + pair_phi * (n_substeps + 1))
  data = lambda k: _np(counts.get(k, 0))
  contacts = (GROUND_FORCE * data("ground_contacts").sum()
              + BOX_FORCE * data("box_contacts").sum()
              + BOX_INSIDE * data("box_inside").sum()
              + SPHERE_FORCE * data("sphere_contacts").sum()
              + float((touching_ops(model) * data("touching")).sum()))
  ops = (E * (n_substeps * per_substep + per_window + end_read)
         + obstacles + int(contacts))
  return nbytes, int(ops)
