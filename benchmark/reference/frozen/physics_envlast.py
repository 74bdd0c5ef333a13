"""Env-last (structure-of-arrays) rigid-body physics window: the plain
PyTorch version of the CUDA kernel in `ops/csrc/physics_window.cu`
(torch mirror of vision4leg_tpu.ops.physics_envlast).

Every per-env array is (..., E): the env axis is last, as in the kernel's
memory layout.  Model constants stay env-free and broadcast in.  Mirrors,
function by function: engine.fwd_kinematics / body_velocities /
mass_matrix / bias_forces / contact_points_world, contact (flat ground +
pruned boxes + spheres), engine.solve_spd_cg / integrate, and
a1.motor_torques / robot_step with the env's post-window contact read.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .model import Model

# contact params — must match physics/contact.py ContactParams defaults
STIFFNESS = 5000.0
DAMPING = 150.0
V_SLIP = 0.02


def mm(A, B):
  """(..., m, k, E) @ (..., k, n, E) -> (..., m, n, E)."""
  return torch.sum(A[..., :, :, None, :] * B[..., None, :, :, :], dim=-3)


def mv(A, x):
  """(..., m, k, E) @ (..., k, E) -> (..., m, E)."""
  return torch.sum(A * x[..., None, :, :], dim=-2)


def transpose(A):
  return A.transpose(-3, -2)


def cross(a, b):
  """(..., 3, E) x (..., 3, E)."""
  a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
  b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
  return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                      a0 * b1 - a1 * b0], dim=-2)


def skew(v):
  """(..., 3, E) -> (..., 3, 3, E)."""
  x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
  zero = torch.zeros_like(x)
  return torch.stack([
      torch.stack([zero, -z, y], dim=-2),
      torch.stack([z, zero, -x], dim=-2),
      torch.stack([-y, x, zero], dim=-2),
  ], dim=-3)


def quat_to_mat(q):
  """(4, E) wxyz -> (3, 3, E)."""
  w, x, y, z = q[0], q[1], q[2], q[3]
  return torch.stack([
      torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)]),
      torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)]),
      torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]),
  ])


def quat_mul(a, b):
  aw, ax, ay, az = a[0], a[1], a[2], a[3]
  bw, bx, by, bz = b[0], b[1], b[2], b[3]
  return torch.stack([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw,
  ])


def quat_integrate(q, omega, dt: float):
  """(4, E), (3, E) world angular velocity."""
  angle = torch.sqrt(torch.sum(omega * omega, dim=0))
  axis = omega / torch.clamp(angle, min=1e-9)[None]
  half = 0.5 * angle * dt
  dq = torch.cat([torch.cos(half)[None], torch.sin(half)[None] * axis])
  out = quat_mul(dq, q)
  return out / torch.sqrt(torch.sum(out * out, dim=0))[None]


# ---------------------------------------------------------------------------
# kinematics / dynamics
# ---------------------------------------------------------------------------

def _rodrigues(axes, ang):
  """axes (L, 3) constants, ang (L, E) -> (L, 3, 3, E)."""
  c = torch.cos(ang)[:, None, None, :]
  s = torch.sin(ang)[:, None, None, :]
  x, y, z = axes[:, 0], axes[:, 1], axes[:, 2]
  zero = torch.zeros_like(x)
  K = torch.stack([
      torch.stack([zero, -z, y], dim=-1),
      torch.stack([z, zero, -x], dim=-1),
      torch.stack([-y, x, zero], dim=-1),
  ], dim=-2)[..., None]
  aaT = (axes[:, :, None] * axes[:, None, :])[..., None]
  eye = torch.eye(3, device=axes.device)[None, :, :, None]
  return c * eye + s * K + (1.0 - c) * aaT


def fk(model: Model, pos, quat, q):
  """pos (3,E), quat (4,E), q (12,E) -> dict R (B,3,3,E), p (B,3,E),
  com_w (B,3,E), ax_w (J,3,E), jp_w (J,3,E)."""
  nb = model.nbody
  R_list = [None] * nb
  p_list = [None] * nb
  ax_list = [None] * (nb - 1)
  R_list[0] = quat_to_mat(quat)
  p_list[0] = pos
  for level in model.levels:
    jl = [b - 1 for b in level]
    plz = [model.parent[b] for b in level]
    Rp = torch.stack([R_list[i] for i in plz])
    pp = torch.stack([p_list[i] for i in plz])
    offs = model.joint_offset[jl]
    axes = model.joint_axis[jl]
    p_lvl = pp + mv(Rp, offs[:, :, None])
    R_lvl = mm(Rp, _rodrigues(axes, q[jl]))
    ax_lvl = mv(Rp, axes[:, :, None])
    for k, b in enumerate(level):
      R_list[b] = R_lvl[k]
      p_list[b] = p_lvl[k]
      ax_list[b - 1] = ax_lvl[k]
  R = torch.stack(R_list)
  p = torch.stack(p_list)
  com_w = p + mv(R, model.com[:, :, None])
  return dict(R=R, p=p, com_w=com_w, ax_w=torch.stack(ax_list), jp_w=p[1:])


def body_velocities(model: Model, kin, ang, lin, qd):
  """Per-body omega / v_com and the qddot=0 bias accelerations."""
  nb = model.nbody
  zero3 = torch.zeros_like(lin)
  om_l = [zero3] * nb
  al_l = [zero3] * nb
  vr_l = [zero3] * nb
  ar_l = [zero3] * nb
  rf_l = [zero3] * nb
  om_l[0] = ang
  vr_l[0] = lin
  rf_l[0] = kin["p"][0]
  for level in model.levels:
    jl = [b - 1 for b in level]
    plz = [model.parent[b] for b in level]
    st = lambda lst: torch.stack([lst[i] for i in plz])
    om_p, al_p, vr_p, ar_p = st(om_l), st(al_l), st(vr_l), st(ar_l)
    jpw = kin["jp_w"][jl]
    r = jpw - st(rf_l)
    a = kin["ax_w"][jl]
    qd_l = qd[jl][:, None, :]
    om_n = om_p + a * qd_l
    al_n = al_p + cross(om_p, a) * qd_l
    vr_n = vr_p + cross(om_p, r)
    ar_n = ar_p + cross(al_p, r) + cross(om_p, cross(om_p, r))
    for k, b in enumerate(level):
      om_l[b] = om_n[k]
      al_l[b] = al_n[k]
      vr_l[b] = vr_n[k]
      ar_l[b] = ar_n[k]
      rf_l[b] = jpw[k]
  omega = torch.stack(om_l)
  alpha = torch.stack(al_l)
  v_ref = torch.stack(vr_l)
  a_ref = torch.stack(ar_l)
  rc = kin["com_w"] - torch.stack(rf_l)
  v_com = v_ref + cross(omega, rc)
  a_com = a_ref + cross(alpha, rc) + cross(omega, cross(omega, rc))
  return omega, v_com, alpha, a_com


def body_jacobians(model: Model, kin):
  """(Jw, Jv), each (B, 3, nv, E)."""
  nb = model.nbody
  E = kin["p"].shape[-1]
  dev = kin["p"].device
  mask = model.ancestor_mask                                # (B,J)
  eye3 = torch.eye(3, device=dev)
  Jw_base = torch.cat([eye3, torch.zeros(3, 3, device=dev)], dim=1)
  Jw_base = Jw_base[None, :, :, None].expand(nb, 3, 6, E)
  axT = kin["ax_w"].transpose(0, 1)                         # (3,J,E)
  Jw_j = axT[None] * mask[:, None, :, None]                 # (B,3,J,E)
  Jw = torch.cat([Jw_base, Jw_j], dim=2)
  r_base = kin["com_w"] - kin["p"][0][None]
  Jv_rot = transpose(skew(r_base))
  r_joint = kin["com_w"][:, None] - kin["jp_w"][None]       # (B,J,3,E)
  Jv_j = cross(kin["ax_w"][None].expand_as(r_joint), r_joint) \
      * mask[:, :, None, None]
  Jv_j = Jv_j.transpose(1, 2)                               # (B,3,J,E)
  eye_b = eye3[None, :, :, None].expand(nb, 3, 3, E)
  Jv = torch.cat([Jv_rot, eye_b, Jv_j], dim=2)
  return Jw, Jv


def mass_and_bias(model: Model, kin, ang, lin, qd, mass_e, inertia_e):
  """Mass matrix (nv,nv,E) and bias force (nv,E); mass_e (B,E) and
  inertia_e (B,3,3,E) carry the per-env dynamics randomization."""
  nb = model.nbody
  nv = model.nv
  E = kin["p"].shape[-1]
  Jw, Jv = body_jacobians(model, kin)
  Iw = mm(mm(kin["R"], inertia_e), transpose(kin["R"]))     # (B,3,3,E)
  M = torch.zeros(nv, nv, E, device=Jv.device)
  for b in range(nb):
    Jvb = Jv[b]
    Jwb = Jw[b]
    mJvb = mass_e[b][None, None, :] * Jvb
    M = M + torch.sum(mJvb[:, :, None, :] * Jvb[:, None, :, :], dim=0)
    IwJwb = mm(Iw[b], Jwb)
    M = M + torch.sum(Jwb[:, :, None, :] * IwJwb[:, None, :, :], dim=0)
  omega, _, alpha, a_com = body_velocities(model, kin, ang, lin, qd)
  F = mass_e[:, None, :] * (a_com - model.gravity[None, :, None])
  T = mv(Iw, alpha) + cross(omega, mv(Iw, omega))
  h = (torch.sum(Jv * F[:, :, None, :], dim=(0, 1))
       + torch.sum(Jw * T[:, :, None, :], dim=(0, 1)))
  return M, h


def contact_points(model: Model, kin, ang, lin, qd):
  """pos/vel (P,3,E), Jp (P,3,nv,E)."""
  idx = list(model.cp_body)
  pos = kin["p"][idx] + mv(kin["R"][idx], model.cp_offset[:, :, None])
  mask = model.ancestor_mask[idx]                           # (P,J)
  E = pos.shape[-1]
  r_joint = pos[:, None] - kin["jp_w"][None]                # (P,J,3,E)
  cols = cross(kin["ax_w"][None].expand_as(r_joint), r_joint) \
      * mask[:, :, None, None]
  cols = cols.transpose(1, 2)                               # (P,3,J,E)
  base_rot = transpose(skew(pos - kin["p"][0][None]))
  P = pos.shape[0]
  eye_b = torch.eye(3, device=pos.device)[None, :, :, None].expand(P, 3, 3, E)
  Jp = torch.cat([base_rot, eye_b, cols], dim=2)
  gen_v = torch.cat([ang, lin, qd], dim=0)                  # (nv,E)
  vel = torch.sum(Jp * gen_v[None, None], dim=2)
  return pos, vel, Jp


# ---------------------------------------------------------------------------
# contacts: flat ground + pruned boxes + spheres
# ---------------------------------------------------------------------------

def _contact_force(phi, normal, vel, friction):
  """phi (..., E), normal/vel (..., 3, E), friction (E,)."""
  in_contact = phi > 0.0
  v_n = torch.sum(vel * normal, dim=-2)
  f_n = torch.clamp(STIFFNESS * phi - DAMPING * v_n, min=0.0) * in_contact
  v_t = vel - v_n[..., None, :] * normal
  v_t_norm = torch.sqrt(torch.sum(v_t * v_t, dim=-2) + V_SLIP ** 2)
  f_t = -(friction * f_n / v_t_norm)[..., None, :] * v_t
  return f_n[..., None, :] * normal + f_t


def _box_forces(pos, vel, radius, boxes, friction, counts=None):
  """pos/vel (P,3,E), radius (P,), boxes (K,8,E) [c3,h3,yaw,valid]."""
  c = boxes[:, 0:3]
  half = boxes[:, 3:6]
  yaw = boxes[:, 6]
  valid = boxes[:, 7]
  cy, sy = torch.cos(yaw), torch.sin(yaw)
  d = pos[:, None] - c[None]                                # (P,K,3,E)
  lx = cy[None] * d[:, :, 0] + sy[None] * d[:, :, 1]
  ly = -sy[None] * d[:, :, 0] + cy[None] * d[:, :, 1]
  lp = torch.stack([lx, ly, d[:, :, 2]], dim=2)
  closest = torch.maximum(torch.minimum(lp, half[None]), -half[None])
  delta = lp - closest
  dist_out = torch.sqrt(torch.sum(delta * delta, dim=2))    # (P,K,E)
  inside = dist_out <= 1e-9
  face_gap = half[None] - torch.abs(lp)
  min_gap = torch.amin(face_gap, dim=2)
  rad = radius[:, None, None]
  phi = torch.where(inside, rad + min_gap, rad - dist_out)
  n_out = delta / torch.clamp(dist_out, min=1e-9)[:, :, None]
  g0, g1, g2 = face_gap[:, :, 0], face_gap[:, :, 1], face_gap[:, :, 2]
  m0 = (g0 <= g1) & (g0 <= g2)
  m1 = ~m0 & (g1 <= g2)
  m2 = ~(m0 | m1)
  onehot = torch.stack([m0, m1, m2], dim=2).to(lp.dtype)
  sign = torch.sign(torch.sum(lp * onehot, dim=2))
  n_face = onehot * sign[:, :, None]
  n_local = torch.where(inside[:, :, None], n_face, n_out)
  nw = torch.stack([
      cy[None] * n_local[:, :, 0] - sy[None] * n_local[:, :, 1],
      sy[None] * n_local[:, :, 0] + cy[None] * n_local[:, :, 1],
      n_local[:, :, 2]], dim=2)
  phi = torch.where(valid[None] > 0.5, phi, torch.full_like(phi, -1.0))
  if counts is not None:
    _count(counts, box_contacts=phi > 0, box_inside=(phi > 0) & inside)
  f = _contact_force(phi, nw, vel[:, None], friction)
  return torch.sum(f, dim=1), torch.amax(phi, dim=1)


def _sphere_forces(pos, vel, radius, spheres, friction, counts=None):
  """pos/vel (P,3,E), spheres (Q,5,E) = [center(3), r, valid]."""
  c = spheres[:, 0:3]
  r = spheres[:, 3]
  valid = spheres[:, 4]
  d = pos[:, None] - c[None]                                # (P,Q,3,E)
  dist = torch.sqrt(torch.sum(d * d, dim=2))
  phi = (radius[:, None, None] + r[None]) - dist
  phi = torch.where(valid[None] > 0.5, phi, torch.full_like(phi, -1.0))
  if counts is not None:
    _count(counts, sphere_contacts=phi > 0)
  n = d / torch.clamp(dist, min=1e-9)[:, :, None]
  f = _contact_force(phi, n, vel[:, None], friction)
  return torch.sum(f, dim=1), torch.amax(phi, dim=1)


def _count(counts, **masks):
  """Add each mask's true entries per contact point (masks are (P,...,E))
  to counts[name], a (P,) tensor."""
  for name, m in masks.items():
    n = m.reshape(m.shape[0], -1).sum(-1)
    counts[name] = counts.get(name, 0) + n


def flat_contact(model: Model, pos, vel, boxes, spheres, fric_ground,
                 fric_box, counts: Optional[dict] = None):
  """Flat ground + boxes/spheres. Returns force (P,3,E), pen (P,2,E).
  With `counts`, adds to it, per contact point, how many (point, surface)
  pairs touch (the data-dependent work that window_cost counts)."""
  radius = model.cp_radius
  phi = radius[:, None] - pos[:, 2]                         # (P,E)
  up = torch.stack([torch.zeros_like(phi), torch.zeros_like(phi),
                    torch.ones_like(phi)], dim=1)
  force = _contact_force(phi, up, vel, fric_ground)
  if boxes.shape[0] > 0:
    fb, phib = _box_forces(pos, vel, radius, boxes, fric_box, counts)
  else:                                    # no obstacles (plane terrain)
    fb, phib = torch.zeros_like(force), torch.full_like(phi, -1.0)
  if spheres is not None and spheres.shape[0] > 0:
    fs, phis = _sphere_forces(pos, vel, radius, spheres, fric_box, counts)
    fb = fb + fs
    phib = torch.maximum(phib, phis)
  if counts is not None:
    _count(counts, ground_contacts=phi > 0, touching=(phi > 0) | (phib > 0))
  return force + fb, torch.stack([phi, phib], dim=1)


# ---------------------------------------------------------------------------
# solver / integration / motor model
# ---------------------------------------------------------------------------

def solve_spd_cg(M, b, iters: int = 16):
  """Jacobi-PCG: M (nv,nv,E), b (nv,E)."""
  dinv = 1.0 / torch.diagonal(M, dim1=0, dim2=1).transpose(0, 1)
  matvec = lambda p: torch.sum(M * p[None, :, :], dim=1)
  vdot = lambda a, c: torch.sum(a * c, dim=0)
  x = b * dinv
  r = b - matvec(x)
  z = dinv * r
  p = z
  rz = vdot(r, z)
  for _ in range(iters):
    Mp = matvec(p)
    alpha = rz / torch.clamp(vdot(p, Mp), min=1e-12)
    x = x + alpha[None] * p
    r = r - alpha[None] * Mp
    z = dinv * r
    rz_new = vdot(r, z)
    p = z + (rz_new / torch.clamp(rz, min=1e-12))[None] * p
    rz = rz_new
  return x


def joint_limit_torque(model: Model, q, qd, k_lim=300.0, d_lim=1.0):
  below = torch.clamp(model.joint_lower[:, None] - q, min=0.0)
  above = torch.clamp(q - model.joint_upper[:, None], min=0.0)
  viol = (below > 0) | (above > 0)
  return k_lim * (below - above) - d_lim * qd * viol


def motor_torques(q, qd, commands, kp, kd, strength):
  """All (12, E)."""
  return strength * (-kp * (q - commands) - kd * qd)


def end_contact_pen(model: Model, st, boxes, spheres, fric_ground,
                    fric_box):
  """Penetration (P,2,E) of the current state (the env's post-window
  contact read)."""
  kin = fk(model, st["pos"], st["quat"], st["q"])
  cpos, cvel, _ = contact_points(model, kin, st["ang"], st["lin"], st["qd"])
  _, pen = flat_contact(model, cpos, cvel, boxes, spheres, fric_ground,
                        fric_box)
  return pen


def substep(model: Model, st, tau_j, mass_e, inertia_e, damping_e,
            coulomb_e, boxes, spheres, fric_ground, fric_box, counts=None):
  """One env-last substep (engine.fwd_dynamics + integrate)."""
  kin = fk(model, st["pos"], st["quat"], st["q"])
  M, h = mass_and_bias(model, kin, st["ang"], st["lin"], st["qd"], mass_e,
                       inertia_e)
  cpos, cvel, Jp = contact_points(model, kin, st["ang"], st["lin"], st["qd"])
  f_c, pen = flat_contact(model, cpos, cvel, boxes, spheres, fric_ground,
                          fric_box, counts)
  tau_c = torch.sum(Jp * f_c[:, :, None, :], dim=(0, 1))    # (nv,E)
  tau_full = (tau_j + joint_limit_torque(model, st["q"], st["qd"])
              - damping_e * st["qd"]
              - coulomb_e * torch.tanh(st["qd"] / 0.05))
  tau = torch.cat([torch.zeros_like(tau_full[:6]), tau_full], dim=0)
  arm = torch.cat([torch.zeros(6, device=M.device), model.armature])
  Mr = M + torch.diag(arm)[:, :, None]
  vdot = solve_spd_cg(Mr, tau + tau_c - h)
  dt = model.dt
  ang = st["ang"] + dt * vdot[0:3]
  lin = st["lin"] + dt * vdot[3:6]
  qd = st["qd"] + dt * vdot[6:]
  return dict(pos=st["pos"] + dt * lin,
              quat=quat_integrate(st["quat"], ang, dt),
              q=st["q"] + dt * qd, ang=ang, lin=lin, qd=qd), pen


def window(model: Model, rs: Dict[str, torch.Tensor], action,
           dyn: Dict[str, torch.Tensor], boxes, spheres, fric_ground,
           fric_box, n_substeps: int, interpolate: bool = False,
           counts: Optional[dict] = None, tau_ff=None, tau_mask=None
           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
  """Full action-repeat window, env-last.

  rs: pos(3,E) quat(4,E) q(12,E) ang(3,E) lin(3,E) qd(12,E)
      hist(20,31,E) obs_tau(12,E) last_action(12,E) counter(E,)
  action (12,E); dyn: kp/kd/strength (12,E), motor_friction /
  joint_friction (E,), mass_scale/inertia_scale (B,E); boxes (K,8,E);
  spheres (Q,5,E) or None; fric_ground/fric_box (E,).
  tau_ff/tau_mask (12,E), optional: hybrid control (the MPC env) — the
  joint torque is (1 - mask) * PD(action) + mask * tau_ff, both fixed
  across the window (swing legs track `action` under PD, stance legs
  apply the MPC feedforward torque); obs_tau is that blended torque.
  Returns (new rs, pen_end (P,2,E) of the post-window state).  With
  `counts`, the substeps add their contact counts to it (flat_contact).
  """
  mass_e = model.mass[:, None] * dyn["mass_scale"]
  inertia_e = model.inertia[..., None] * dyn["inertia_scale"][:, None, None, :]
  damping_e = model.joint_damping[:, None] + dyn["motor_friction"][None]
  coulomb_e = model.joint_friction[:, None] + dyn["joint_friction"][None]
  prev = rs["last_action"]
  st = {k: rs[k] for k in ("pos", "quat", "q", "ang", "lin", "qd")}
  hist, obs_tau = rs["hist"], rs["obs_tau"]
  for i in range(n_substeps):
    if interpolate:
      cmd = prev + ((i + 1.0) / n_substeps) * (action - prev)
    else:
      cmd = action
    obs_tau = motor_torques(st["q"], st["qd"], cmd, dyn["kp"], dyn["kd"],
                            dyn["strength"])
    if tau_ff is not None:
      obs_tau = (1.0 - tau_mask) * obs_tau + tau_mask * tau_ff
    st, _ = substep(model, st, obs_tau, mass_e, inertia_e, damping_e,
                    coulomb_e, boxes, spheres, fric_ground, fric_box,
                    counts)
    rec = torch.cat([st["q"], st["qd"], st["quat"], st["ang"]], dim=0)
    hist = torch.cat([rec[None], hist[:-1]], dim=0)
  pen_end = end_contact_pen(model, st, boxes, spheres, fric_ground, fric_box)
  return dict(st, hist=hist, obs_tau=obs_tau, last_action=action,
              counter=rs["counter"] + n_substeps), pen_end
