"""Python surface matching the reference's pybind module `mpc_osqp`
(mpc_osqp.cc PYBIND11_MODULE :893-916): `ConvexMpc(mass, inertia,
num_legs, horizon, timestep, qp_weights, alpha, solver)` with
`compute_contact_forces(...)`, backed by the native C++ core in
convex_mpc.cpp (a self-contained float64 ADMM in place of OSQP/qpOASES).

The port keeps its own copy of convex_mpc.cpp beside this file.  g++
builds it at first use into `vision4leg_torch/_build/`, cached by a hash
of the source and the flags as `ops/nvcc.py` caches the CUDA builds; a
failed build raises.  Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "convex_mpc.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

# solver enum for ctor parity (the native core always uses its ADMM)
OSQP = 0
QPOASES = 1

_LIB = None


def so_path() -> str:
  with open(SOURCE, "rb") as f:
    src = f.read()
  digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
  return os.path.join(BUILD_DIR, f"convex_mpc_{digest[:16]}.so")


def build() -> str:
  """The built library's path: g++ compiles the source unless a build of
  the same source and flags is cached.  Raises if g++ is missing or
  fails."""
  out = so_path()
  if os.path.exists(out):
    return out
  cxx = os.environ.get("CXX") or shutil.which("g++")
  if cxx is None:
    raise RuntimeError("g++ not found: the native convex-MPC core cannot "
                       "be built (set CXX)")
  os.makedirs(BUILD_DIR, exist_ok=True)
  tmp = f"{out}.{os.getpid()}.tmp"
  proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"g++ exit {proc.returncode} building {SOURCE}:\n"
                       f"{proc.stderr}")
  os.replace(tmp, out)
  return out


def _load():
  global _LIB
  if _LIB is not None:
    return _LIB
  lib = ctypes.CDLL(build())
  D = ctypes.POINTER(ctypes.c_double)
  I = ctypes.POINTER(ctypes.c_int)
  lib.mpc_create.restype = ctypes.c_void_p
  lib.mpc_create.argtypes = [ctypes.c_double, D, ctypes.c_int, ctypes.c_int,
                             ctypes.c_double, D, ctypes.c_double]
  lib.mpc_destroy.argtypes = [ctypes.c_void_p]
  lib.mpc_compute_contact_forces.restype = ctypes.c_int
  lib.mpc_compute_contact_forces.argtypes = [
      ctypes.c_void_p, D, ctypes.c_int, D, D, D, I, D, D, D, D, D, D, D]
  _LIB = lib
  return lib


def _d(x):
  return np.ascontiguousarray(x, np.float64)


def _dp(x):
  return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class ConvexMpc:
  def __init__(self, mass, inertia, num_legs, planning_horizon,
               timestep, qp_weights, alpha=1e-5, qp_solver=QPOASES):
    del qp_solver  # ctor parity; the native ADMM core handles all cases
    self._lib = _load()
    self.num_legs = num_legs
    self.horizon = planning_horizon
    inertia = _d(inertia)
    weights = _d(qp_weights)
    self._h = self._lib.mpc_create(
        float(mass), _dp(inertia), int(num_legs), int(planning_horizon),
        float(timestep), _dp(weights), float(alpha))

  def compute_contact_forces(self, com_position, com_velocity,
                             com_roll_pitch_yaw, com_angular_velocity,
                             foot_contact_states,
                             foot_positions_body_frame,
                             foot_friction_coeffs, desired_com_position,
                             desired_com_velocity,
                             desired_com_roll_pitch_yaw,
                             desired_com_angular_velocity):
    """The negated solution over the whole horizon (num_legs * 3 *
    horizon floats), or [] when the core reports a failure, as the
    reference's binding returns it."""
    com_position = _d(com_position)
    out = np.zeros(self.num_legs * 3 * self.horizon, np.float64)
    contacts = np.ascontiguousarray(foot_contact_states, np.int32)
    args = [_d(com_velocity), _d(com_roll_pitch_yaw),
            _d(com_angular_velocity)]
    rc = self._lib.mpc_compute_contact_forces(
        self._h, _dp(com_position), len(com_position),
        _dp(args[0]), _dp(args[1]), _dp(args[2]),
        contacts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _dp(_d(foot_positions_body_frame)), _dp(_d(foot_friction_coeffs)),
        _dp(_d(desired_com_position)), _dp(_d(desired_com_velocity)),
        _dp(_d(desired_com_roll_pitch_yaw)),
        _dp(_d(desired_com_angular_velocity)), _dp(out))
    if rc != 0:
      return []
    return list(out)

  def reset_solver(self):
    pass

  def __del__(self):
    h = getattr(self, "_h", None)
    if h:
      self._lib.mpc_destroy(h)
      self._h = None
