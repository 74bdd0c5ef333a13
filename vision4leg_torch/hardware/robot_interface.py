"""ctypes binding of the native A1 UDP robot interface (mirror of
vision4leg_tpu.hardware.robot_interface).

It presents the reference's `robot_interface.RobotInterface`
(third_party/unitree_legged_sdk/python_interface.cpp:17-80):
  ReceiveObservation() -> LowState
  SendCommand(60 floats: 12 x [q, Kp, dq, Kd, tau])
over the C++ UDP link `vision4leg_tpu/hardware/native/robot_interface.cpp`,
which the port reads where it sits and never copies.  g++ builds it at
first use into `vision4leg_torch/_build/`, cached by a hash of the source
and the flags (as `mpc/native/mpc_osqp.py` builds the MPC core); a failed
build raises.  Nothing is built when this module is imported, and the JAX
package's own build (`make` in its tree) is never run.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
SOURCE = os.path.join(_ROOT, "vision4leg_tpu", "hardware", "native",
                      "robot_interface.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# the flags of the reference's native/Makefile
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
STATE_SIZE = 54

ROBOT_IP = "192.168.123.10"
ROBOT_PORT = 8007
LOCAL_PORT = 8080

_LIB = None


def so_path() -> str:
  with open(SOURCE, "rb") as f:
    src = f.read()
  digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
  return os.path.join(BUILD_DIR, f"robot_interface_{digest[:16]}.so")


def build() -> str:
  """The built library's path: g++ compiles the source unless a build of
  the same source and flags is cached.  Raises if g++ is missing or
  fails."""
  out = so_path()
  if os.path.exists(out):
    return out
  cxx = os.environ.get("CXX") or shutil.which("g++")
  if cxx is None:
    raise RuntimeError("g++ not found: the robot interface cannot be built "
                       "(set CXX)")
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
  F = ctypes.POINTER(ctypes.c_float)
  lib.ri_create.restype = ctypes.c_void_p
  lib.ri_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
  lib.ri_destroy.restype = None
  lib.ri_destroy.argtypes = [ctypes.c_void_p]
  lib.ri_recv.restype = ctypes.c_int
  lib.ri_recv.argtypes = [ctypes.c_void_p, F]
  lib.ri_send.restype = ctypes.c_int
  lib.ri_send.argtypes = [ctypes.c_void_p, F]
  lib.ri_state_size.restype = ctypes.c_int
  lib.ri_state_size.argtypes = []
  if lib.ri_state_size() != STATE_SIZE:
    raise RuntimeError(f"robot interface: {lib.ri_state_size()} state "
                       f"floats, expected {STATE_SIZE}")
  _LIB = lib
  return lib


@dataclasses.dataclass
class IMUState:
  quaternion: np.ndarray    # (4,) wxyz
  gyroscope: np.ndarray     # (3,)
  accelerometer: np.ndarray  # (3,)
  rpy: np.ndarray           # (3,)


@dataclasses.dataclass
class MotorStateArray:
  q: np.ndarray       # (12,)
  dq: np.ndarray      # (12,)
  tauEst: np.ndarray  # (12,)


@dataclasses.dataclass
class LowState:
  motorState: MotorStateArray
  imu: IMUState
  footForce: np.ndarray  # (4,)
  tick: float


def low_state(buf: np.ndarray) -> LowState:
  """The LowState of the native link's 54 floats: q, dq, tauEst (12
  each), quaternion wxyz, gyroscope, accelerometer, rpy, footForce (4),
  tick."""
  return LowState(
      motorState=MotorStateArray(q=buf[0:12].copy(), dq=buf[12:24].copy(),
                                 tauEst=buf[24:36].copy()),
      imu=IMUState(quaternion=buf[36:40].copy(), gyroscope=buf[40:43].copy(),
                   accelerometer=buf[43:46].copy(), rpy=buf[46:49].copy()),
      footForce=buf[49:53].copy(),
      tick=float(buf[53]),
  )


class RobotInterface:
  """Low-level UDP link (LOWLEVEL mode of the reference wrapper).
  local_port 0 binds an ephemeral port."""

  def __init__(self, robot_ip: str = ROBOT_IP, robot_port: int = ROBOT_PORT,
               local_port: int = LOCAL_PORT):
    self._lib = _load()
    self._handle = self._lib.ri_create(robot_ip.encode(), robot_port,
                                       local_port)
    if not self._handle:
      raise RuntimeError(f"failed to open the UDP link to the robot "
                         f"({robot_ip}:{robot_port}, local {local_port})")
    self._state_buf = np.zeros(STATE_SIZE, np.float32)

  def ReceiveObservation(self) -> LowState:
    """The latest state (the last one received when no packet is
    pending)."""
    buf = self._state_buf
    if self._lib.ri_recv(
        self._handle,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) < 0:
      raise RuntimeError("robot interface: receive on a closed link")
    return low_state(buf)

  def SendCommand(self, motorcmd) -> None:
    cmd = np.ascontiguousarray(motorcmd, np.float32)
    if cmd.shape != (60,):
      raise ValueError(f"SendCommand: expected 12 x [q, Kp, dq, Kd, tau] "
                       f"= 60 floats, got shape {cmd.shape}")
    if self._lib.ri_send(
        self._handle, cmd.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
      raise RuntimeError("robot interface: the command was not sent")

  def close(self) -> None:
    if getattr(self, "_handle", None):
      self._lib.ri_destroy(self._handle)
      self._handle = None

  def __del__(self):
    self.close()
