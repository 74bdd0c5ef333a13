"""The action-repeat physics window over all envs: wrapper of the CUDA
kernel `ops/csrc/physics_window.cu` (torch counterpart of
vision4leg_tpu.ops.physics_kernel.robot_window_pallas).

On CUDA tensors `robot_window` launches the hand-written kernel or
raises; on CPU tensors it runs the plain PyTorch version
(`ops/physics_envlast.window`, same math, env-last).  The kernel is built
with nvcc at first use into `vision4leg_torch/_build/` (a shared library
with a plain C interface, loaded with ctypes; `ops/nvcc.py`) and cached
there by a hash of its source and flags.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from vision4leg_torch.ops import nvcc
from vision4leg_torch.ops import physics_envlast as pe
from vision4leg_torch.physics import engine
from vision4leg_torch.physics.model import Model
from vision4leg_torch.robots import a1

SOURCE = nvcc.SOURCES["physics_window"]

# tree topology the kernel is compiled for (the A1: trunk + 4 legs x 3)
KERNEL_PARENT = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11)
KERNEL_CP_BODY = (3, 6, 9, 12, 3, 6, 9, 12, 1, 4, 7, 10) + (0,) * 8
HIST_LEN, HIST_DIM = a1.OBS_HIST_LEN, a1.OBS_HIST_DIM

# env-last row order of the kernel's state buffer (csrc S_* offsets)
STATE_ROWS = (("pos", 3), ("quat", 4), ("q", 12), ("ang", 3), ("lin", 3),
              ("qd", 12), ("obs_tau", 12), ("hist", HIST_LEN * HIST_DIM))
NUM_STATE_ROWS = sum(n for _, n in STATE_ROWS)
# parameter buffer rows before the boxes (csrc P_* offsets)
PARAM_ROWS = (("cmd", 12), ("prev", 12), ("kp", 12), ("kd", 12),
              ("strength", 12), ("motor_friction", 1), ("joint_friction", 1),
              ("mass_scale", 13), ("inertia_scale", 13), ("fric_ground", 1),
              ("fric_box", 1))
MODEL_SIZE = 384

_LIB = {}
BUILD_INFO: Dict[str, object] = {}


def build_library() -> ctypes.CDLL:
  """Compile the kernel (once per source+flags hash, `ops/nvcc.py`) and
  load it; BUILD_INFO holds the build's seconds and ptxas counts."""
  if "lib" in _LIB:
    return _LIB["lib"]
  lib = nvcc.load("physics_window")
  info = nvcc.INFO["physics_window"]
  BUILD_INFO.update(seconds=info["seconds"], cached=info["cached"],
                    path=info["path"], ptxas={
                        "f64" if "IdE" in k else "f32": v for k, v in
                        nvcc.ptxas_counts(info["log"]).items()})
  fn = lib.physics_window_launch
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
      ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  _LIB["lib"] = lib
  return lib


# ---------------------------------------------------------------------------
# layouts: env-first RobotState / DynamicsParams <-> env-last dicts
# ---------------------------------------------------------------------------

def _t(x):
  return x.movedim(0, -1)


def rs_to_envlast(rs: a1.RobotState) -> dict:
  p = rs.phys
  return dict(pos=_t(p.pos), quat=_t(p.quat), q=_t(p.joint_q), ang=_t(p.ang),
              lin=_t(p.lin), qd=_t(p.joint_qd), hist=_t(rs.obs_hist),
              obs_tau=_t(rs.observed_torques),
              last_action=_t(rs.last_robot_action), counter=rs.step_counter)


def rs_from_envlast(d: dict) -> a1.RobotState:
  t = lambda x: x.movedim(-1, 0).contiguous()
  return a1.RobotState(
      phys=engine.PhysState(pos=t(d["pos"]), quat=t(d["quat"]),
                            joint_q=t(d["q"]), ang=t(d["ang"]),
                            lin=t(d["lin"]), joint_qd=t(d["qd"])),
      obs_hist=t(d["hist"]), observed_torques=t(d["obs_tau"]),
      last_robot_action=t(d["last_action"]), step_counter=d["counter"])


def dyn_to_envlast(dyn: a1.DynamicsParams) -> dict:
  return dict(kp=_t(dyn.kp), kd=_t(dyn.kd), strength=_t(dyn.strength_ratios),
              motor_friction=dyn.motor_friction,
              joint_friction=dyn.joint_friction,
              mass_scale=_t(dyn.mass_scale),
              inertia_scale=_t(dyn.inertia_scale))


def model_buffer(model: Model) -> torch.Tensor:
  """The kernel's flat model-constant buffer (csrc M_* offsets)."""
  if model.parent != KERNEL_PARENT or model.cp_body != KERNEL_CP_BODY:
    raise ValueError("physics_window kernel is compiled for the A1 tree; "
                     "got another topology")
  parts = [model.joint_axis, model.joint_offset, model.com, model.mass,
           model.inertia, model.joint_lower, model.joint_upper,
           model.armature, model.joint_damping, model.joint_friction,
           model.cp_offset, model.cp_radius, model.gravity]
  buf = torch.cat([x.reshape(-1) for x in parts])
  if buf.numel() != MODEL_SIZE:
    raise ValueError(f"physics_window: model buffer of {buf.numel()} "
                     f"floats, the kernel reads {MODEL_SIZE}")
  return buf.contiguous()


def _check(name, x, shape, device, dtype):
  if x.dtype != dtype:
    raise TypeError(f"robot_window: {name} must be {dtype} like pos, got "
                    f"{x.dtype}")
  if x.device != device:
    raise ValueError(f"robot_window: {name} on {x.device}, expected {device}")
  if tuple(x.shape) != tuple(shape):
    raise ValueError(f"robot_window: {name} has shape {tuple(x.shape)}, "
                     f"expected {tuple(shape)}")


def _launch(model: Model, rs: a1.RobotState, command, dyn, boxes, spheres,
            fric_ground, fric_box, n_substeps: int,
            interpolate: bool = False, tau_ff=None, tau_mask=None,
            launch=None):
  """Check, pack into the kernel's env-last buffers, launch, unpack.
  `launch(*pointers_and_sizes)` defaults to the built kernel on the
  current CUDA stream.  The kernel runs in float32 or, for float64
  inputs, in its float64 instantiation.  In hybrid mode (tau_ff and
  tau_mask given) their 24 rows follow the sphere rows of the parameter
  buffer."""
  E = command.shape[0]
  K, Q = boxes.shape[1], spheres.shape[1]
  dev = command.device
  nb = model.nbody
  dtype = rs.phys.pos.dtype
  if dtype not in (torch.float32, torch.float64):
    raise TypeError(f"robot_window: float32 or float64 inputs, got {dtype}")
  checks = [("pos", rs.phys.pos, (E, 3)), ("quat", rs.phys.quat, (E, 4)),
            ("joint_q", rs.phys.joint_q, (E, 12)),
            ("ang", rs.phys.ang, (E, 3)), ("lin", rs.phys.lin, (E, 3)),
            ("joint_qd", rs.phys.joint_qd, (E, 12)),
            ("obs_hist", rs.obs_hist, (E, HIST_LEN, HIST_DIM)),
            ("observed_torques", rs.observed_torques, (E, 12)),
            ("last_robot_action", rs.last_robot_action, (E, 12)),
            ("command", command, (E, 12)), ("kp", dyn.kp, (E, 12)),
            ("kd", dyn.kd, (E, 12)),
            ("strength_ratios", dyn.strength_ratios, (E, 12)),
            ("motor_friction", dyn.motor_friction, (E,)),
            ("joint_friction", dyn.joint_friction, (E,)),
            ("mass_scale", dyn.mass_scale, (E, nb)),
            ("inertia_scale", dyn.inertia_scale, (E, nb)),
            ("boxes", boxes, (E, K, 8)), ("spheres", spheres, (E, Q, 5)),
            ("fric_ground", fric_ground, (E,)), ("fric_box", fric_box, (E,))]
  hybrid = _hybrid(tau_ff, tau_mask)
  if hybrid:
    checks += [("tau_ff", tau_ff, (E, 12)), ("tau_mask", tau_mask, (E, 12))]
  for name, x, shape in checks:
    _check(name, x, shape, dev, dtype)
  if model.mass.device != dev or model.mass.dtype != dtype:
    raise ValueError(f"robot_window: model is {model.mass.dtype} on "
                     f"{model.mass.device}, expected {dtype} on {dev}")
  if launch is None:
    fn = build_library().physics_window_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lambda *args: fn(*args, stream)
  el = rs_to_envlast(rs)
  state_in = torch.cat(
      [el[k].reshape(-1, E) for k, _ in STATE_ROWS]).contiguous()
  dl = dyn_to_envlast(dyn)
  par = dict(cmd=_t(command), prev=el["last_action"], kp=dl["kp"],
             kd=dl["kd"], strength=dl["strength"],
             motor_friction=dl["motor_friction"],
             joint_friction=dl["joint_friction"],
             mass_scale=dl["mass_scale"], inertia_scale=dl["inertia_scale"],
             fric_ground=fric_ground, fric_box=fric_box)
  hyb = [_t(tau_ff), _t(tau_mask)] if hybrid else []
  params = torch.cat([par[k].reshape(-1, E) for k, _ in PARAM_ROWS]
                     + [_t(boxes).reshape(-1, E), _t(spheres).reshape(-1, E)]
                     + hyb).contiguous()
  mdl = model_buffer(model)
  state_out = torch.empty_like(state_in)
  pen = torch.empty(model.ncp, 2, E, device=dev, dtype=dtype)
  err = launch(state_in.data_ptr(), state_out.data_ptr(), params.data_ptr(),
               mdl.data_ptr(), pen.data_ptr(), E, K, Q, n_substeps,
               int(interpolate), int(hybrid), float(model.dt),
               int(dtype == torch.float64))
  if err != 0:
    raise RuntimeError(f"physics_window_launch failed: cudaError {err}")
  robot_window.launches += 1
  out, r = {}, 0
  for k, n in STATE_ROWS:
    out[k] = state_out[r:r + n]
    r += n
  out["hist"] = out["hist"].reshape(HIST_LEN, HIST_DIM, E)
  out["last_action"] = _t(command)
  out["counter"] = rs.step_counter + n_substeps
  return rs_from_envlast(out), pen.movedim(-1, 0)


def robot_window(model: Model, rs: a1.RobotState, command, dyn, boxes,
                 spheres, fric_ground, fric_box, n_substeps: int,
                 interpolate: bool = False, tau_ff=None, tau_mask=None
                 ) -> Tuple[a1.RobotState, torch.Tensor]:
  """Batched robot_step window + post-window contact read (flat ground +
  per-env pruned boxes and spheres).

  rs/command (E,12)/dyn/boxes (E,K,8)/spheres (E,Q,5)/fric_* (E,) carry a
  leading env axis; returns (new RobotState, pen_end (E, P, 2) — [ground,
  obstacle] penetration of the post-window state).
  tau_ff/tau_mask (E, 12), optional together: hybrid control (the MPC
  env), torque = (1 - mask) * PD(command) + mask * tau_ff, both fixed
  across the window.
  """
  _hybrid(tau_ff, tau_mask)
  if command.device.type == "cuda":
    return _launch(model, rs, command, dyn, boxes, spheres, fric_ground,
                   fric_box, n_substeps, interpolate, tau_ff, tau_mask)
  if command.device.type != "cpu":
    raise ValueError(f"robot_window: unsupported device {command.device}")
  return window_plain(model, rs, command, dyn, boxes, spheres, fric_ground,
                      fric_box, n_substeps, interpolate, tau_ff, tau_mask)


robot_window.launches = 0


def _hybrid(tau_ff, tau_mask) -> bool:
  """Whether the window runs in hybrid mode; tau_ff and tau_mask come
  together or not at all."""
  if (tau_ff is None) != (tau_mask is None):
    raise ValueError("robot_window: hybrid mode needs both tau_ff and "
                     "tau_mask")
  return tau_ff is not None


def window_plain(model: Model, rs: a1.RobotState, command, dyn, boxes,
                 spheres, fric_ground, fric_box, n_substeps: int,
                 interpolate: bool = False, tau_ff=None, tau_mask=None,
                 counts=None):
  """The plain PyTorch version on any device (what the CPU path runs and
  what the kernel is held against); `counts` as in physics_envlast.window."""
  hybrid = _hybrid(tau_ff, tau_mask)
  new_el, pen = pe.window(
      model, rs_to_envlast(rs), _t(command), dyn_to_envlast(dyn), _t(boxes),
      _t(spheres) if spheres.shape[1] > 0 else None, fric_ground, fric_box,
      n_substeps, interpolate, counts, _t(tau_ff) if hybrid else None,
      _t(tau_mask) if hybrid else None)
  return rs_from_envlast(new_el), pen.movedim(-1, 0)


# ---------------------------------------------------------------------------
# holding the kernel against its plain version
# ---------------------------------------------------------------------------

# tolerances of tests/test_physics_kernel.py (JAX package)
WINDOW_TOL = dict(pos=1e-5, quat=1e-5, joint_q=1e-5, ang=6e-3, lin=6e-3,
                  joint_qd=6e-3, obs_hist=6e-3, observed_torques=6e-3,
                  pen_end=1e-4)


def _cast(x, fn):
  """Apply fn to every floating tensor of x (a tensor, a dataclass of
  them, or anything else, left as it is)."""
  if isinstance(x, torch.Tensor):
    return fn(x) if x.is_floating_point() else x
  if dataclasses.is_dataclass(x):
    return dataclasses.replace(x, **{
        f.name: _cast(getattr(x, f.name), fn) for f in dataclasses.fields(x)})
  return x


def _double(x):
  return _cast(x, torch.Tensor.double)


def _nudged(args, gen):
  """The window inputs (not the model) each moved by up to one float32
  rounding unit (relative 2**-24), at random."""
  nudge = lambda x: x * (1 + (2 * torch.rand(
      x.shape, generator=gen, device=x.device) - 1) * 2.0 ** -24)
  return (args[0],) + tuple(_cast(a, nudge) for a in args[1:])


def _per_env(rs: a1.RobotState, pen) -> Dict[str, torch.Tensor]:
  """Each output field as (E, n)."""
  p = rs.phys
  flat = lambda x: x.reshape(x.shape[0], -1)
  return dict(pos=p.pos, quat=p.quat, joint_q=p.joint_q, ang=p.ang,
              lin=p.lin, joint_qd=p.joint_qd, obs_hist=flat(rs.obs_hist),
              observed_torques=rs.observed_torques, pen_end=flat(pen))


ROUNDING_SAMPLES = 8


def compare_with_plain(args, run=None):
  """Hold the kernel against its plain version on the window inputs
  `args` (the positional arguments of `robot_window`, hybrid mode's
  tau_ff and tau_mask included); `run(*args)` runs the kernel (default:
  `robot_window`).

  Two checks, on every env and every output field:
  * float64: the kernel's float64 instantiation against the plain
    version in float64, within WINDOW_TOL (the JAX package's tolerances
    for its own window kernel).
  * float32, what the main path runs: penalty contacts switch on at zero
    penetration and the friction cone is steep near zero slip, so float32
    rounding moves some envs of any batch further from the float64
    result than the tolerances, in the plain version as much as in the
    kernel.  Per env, the float32 kernel's largest error against the
    float64 plain run must be at most max(tol, 2 s), where s, the env's
    float32 spread, is the largest error of the float32 plain version
    against the float64 run, on the inputs and on ROUNDING_SAMPLES copies
    of them moved by one float32 rounding unit.  An env that passes only
    by the second term is counted as excused.

  Returns (ok, report); `report["max_abs_err"]` is the largest float32
  kernel-vs-plain difference.
  """
  run = robot_window if run is None else run
  args64 = tuple(_double(a) for a in args)
  got = run(*args)
  k32 = _per_env(*got)
  k64 = _per_env(*run(*args64))
  p32_rs, p32_pen = window_plain(*args)
  p32 = _per_env(p32_rs, p32_pen)
  p64 = _per_env(*window_plain(*args64))
  gen = torch.Generator(device=p32_pen.device).manual_seed(0)
  nudged = [_per_env(*window_plain(*_nudged(args, gen)))
            for _ in range(ROUNDING_SAMPLES)]
  worst = lambda a, b: (a.double() - b.double()).abs().amax(-1)
  report = dict(envs=int(p32_pen.shape[0]), fields={})
  ok = (torch.equal(got[0].step_counter, p32_rs.step_counter)
        and torch.equal(got[0].last_robot_action, p32_rs.last_robot_action))
  for k, tol in WINDOW_TOL.items():
    e64 = worst(k64[k], p64[k])
    e_k = worst(k32[k], p64[k])
    e_p = worst(p32[k], p64[k])
    spread = torch.stack([e_p] + [worst(n[k], p64[k]) for n in nudged]
                         ).amax(0)
    fails = e_k > torch.clamp(2 * spread, min=tol)
    report["fields"][k] = dict(
        max_abs_err=float(worst(k32[k], p32[k]).max()),
        f64_max_err=float(e64.max()), f32_kernel_vs_f64=float(e_k.max()),
        f32_plain_vs_f64=float(e_p.max()), f32_spread=float(spread.max()),
        excused=int(((e_k > tol) & ~fails).sum()), failed=int(fails.sum()))
    ok &= bool(e64.max() <= tol) and not bool(fails.any())
  report["max_abs_err"] = max(v["max_abs_err"]
                              for v in report["fields"].values())
  return ok, report
