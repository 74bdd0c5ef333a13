"""The port's native convex-MPC core (vision4leg_torch/mpc/native/) against
the JAX package's, on the CPU.

The port keeps a byte copy of convex_mpc.cpp and builds it with g++ into
vision4leg_torch/_build/; it never opens the JAX package's committed
libconvex_mpc.so nor runs its Makefile.  Tolerances: the same forces as
the JAX binding to the bit (one source, one compiler); the standing fixed
points within 2% (tests/test_mpc.py:292-318); the port's float64 cold
torch solve within 3.0 N (tests/test_mpc.py:140-172 holds the native
core to the JAX float32 cold solve so: two approximate solvers, a few
percent of body weight).
"""
import importlib.util
import os
import subprocess

import numpy as np
import pytest
import torch

from vision4leg_torch.mpc import convex_mpc as tmpc
from vision4leg_torch.mpc import robot_params
from vision4leg_torch.mpc.native import mpc_osqp
from vision4leg_torch.robots import a1_params as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(ROOT, "vision4leg_tpu", "mpc", "native")
WEIGHTS = (5, 5, 0.2, 0, 0, 10, 0., 0., 1., 1., 1., 0., 0)
FEET = np.array([[0.17, -0.13, -0.24], [0.17, 0.13, -0.24],
                 [-0.19, -0.13, -0.24], [-0.19, 0.13, -0.24]])
EXPECTED_TOTAL_FZ = {"a1": 126.5, "laikago": 253.9, "spirit40": 139.4}


def _jax_binding():
  """The JAX package's mpc_osqp module (loads its committed .so)."""
  spec = importlib.util.spec_from_file_location(
      "jax_mpc_osqp", os.path.join(JAX_NATIVE, "mpc_osqp.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _cases():
  """(contacts, vel, rpy, rate, desired vel, desired twist) per case:
  standing, walking, turning, a leg in swing, two legs in swing."""
  rng = np.random.default_rng(0)
  out = [(np.ones(4, np.int32), np.zeros(3), np.zeros(3), np.zeros(3),
          np.zeros(3), np.zeros(3))]
  for contacts in ([1, 1, 1, 1], [1, 1, 0, 1], [1, 0, 0, 1], [0, 1, 1, 0]):
    out.append((np.array(contacts, np.int32), rng.normal(0, 0.1, 3),
                np.r_[rng.normal(0, 0.03, 2), 0.0], rng.normal(0, 0.2, 3),
                np.array([rng.uniform(0, 0.3), 0.0, 0.0]),
                np.array([0.0, 0.0, rng.uniform(-0.4, 0.4)])))
  return out


def _args(case, height=0.24, feet=FEET):
  contacts, vel, rpy, rate, dvel, dang = case
  return ([0.0, 0.0, height], vel, rpy, rate, contacts, feet.flatten(),
          np.full(4, 0.45), [0.0, 0.0, height], dvel, np.zeros(3), dang)


def _native(mod, mass=float(P.MPC_BODY_MASS),
            inertia=tuple(P.MPC_BODY_INERTIA)):
  return mod.ConvexMpc(mass, list(inertia), 4, 10, 0.025, list(WEIGHTS),
                       1e-5)


def test_source_is_a_byte_copy():
  with open(os.path.join(JAX_NATIVE, "convex_mpc.cpp"), "rb") as f:
    jax_src = f.read()
  with open(mpc_osqp.SOURCE, "rb") as f:
    assert f.read() == jax_src


def test_forces_equal_the_jax_binding_to_the_bit():
  port, ref = _native(mpc_osqp), _native(_jax_binding())
  for case in _cases():
    got = np.array(port.compute_contact_forces(*_args(case)))
    want = np.array(ref.compute_contact_forces(*_args(case)))
    assert got.shape == (4 * 3 * 10,)
    np.testing.assert_array_equal(got, want)


def test_build_goes_to_the_port_and_never_opens_the_jax_library(
    monkeypatch, tmp_path):
  """A fresh build into a private build directory: g++ on the port's own
  source, the library opened from there; no make, nothing of the JAX
  tree opened or written."""
  jax_so = os.path.join(JAX_NATIVE, "libconvex_mpc.so")
  before = os.stat(jax_so).st_mtime_ns
  opened, ran = [], []
  real_cdll, real_run = mpc_osqp.ctypes.CDLL, mpc_osqp.subprocess.run
  monkeypatch.setattr(mpc_osqp, "BUILD_DIR", str(tmp_path))
  monkeypatch.setattr(mpc_osqp, "_LIB", None)
  monkeypatch.setattr(mpc_osqp.ctypes, "CDLL",
                      lambda p, *a, **kw: (opened.append(p),
                                           real_cdll(p, *a, **kw))[1])
  monkeypatch.setattr(mpc_osqp.subprocess, "run",
                      lambda cmd, *a, **kw: (ran.append(cmd),
                                             real_run(cmd, *a, **kw))[1])
  f = _native(mpc_osqp).compute_contact_forces(*_args(_cases()[1]))
  assert len(f) == 120 and np.isfinite(f).all()
  assert opened == [mpc_osqp.so_path()]
  assert opened[0].startswith(str(tmp_path))
  assert len(ran) == 1 and ran[0][-1] == mpc_osqp.SOURCE
  assert "make" not in ran[0] and "-shared" in ran[0]
  assert os.stat(jax_so).st_mtime_ns == before
  # a second load uses the cached build: no compiler
  monkeypatch.setattr(mpc_osqp, "_LIB", None)
  _native(mpc_osqp)
  assert len(ran) == 1
  # the real build directory is the port's, git-ignored
  assert mpc_osqp.so_path().startswith(str(tmp_path))
  monkeypatch.undo()
  assert os.path.dirname(mpc_osqp.so_path()) == os.path.join(
      ROOT, "vision4leg_torch", "_build")
  status = subprocess.run(["git", "status", "--porcelain", "--",
                           "vision4leg_tpu"], capture_output=True, text=True,
                          cwd=ROOT)
  if status.returncode == 0:
    assert status.stdout == ""


def test_a_failed_build_raises(monkeypatch, tmp_path):
  bad = tmp_path / "convex_mpc.cpp"
  bad.write_text("this is not C++\n")
  monkeypatch.setattr(mpc_osqp, "SOURCE", str(bad))
  monkeypatch.setattr(mpc_osqp, "BUILD_DIR", str(tmp_path / "build"))
  monkeypatch.setattr(mpc_osqp, "_LIB", None)
  with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
    _native(mpc_osqp)


@pytest.mark.parametrize("name", sorted(EXPECTED_TOTAL_FZ))
def test_standing_fixed_points(name):
  """tests/test_mpc.py::test_native_mpc_standing_all_robots on the port's
  build: each robot's standing QP at its x64 fixed point within 2%."""
  rp = robot_params.ROBOTS[name]
  native = _native(mpc_osqp, rp.body_mass, tuple(rp.body_inertia))
  feet = np.asarray([[hx, hy, -rp.body_height]
                     for hx, hy, _ in rp.hip_positions])
  f = np.array(native.compute_contact_forces(
      *_args(_cases()[0], rp.body_height, feet))[:12]).reshape(4, 3)
  total = float(-f[:, 2].sum())
  exp = EXPECTED_TOTAL_FZ[name]
  assert abs(total - exp) / exp < 0.02, (name, total, exp)


def test_native_matches_the_cold_torch_solve():
  """tests/test_mpc.py::test_native_mpc_matches_jax on the port: the
  native core's first-step forces and the port's cold solve (float64,
  admm_iters 100) within 3.0 N, on the JAX test's walking case and on
  this file's cases."""
  native = _native(mpc_osqp)
  cfg = tmpc.MpcConfig(mass=float(P.MPC_BODY_MASS),
                       inertia=tuple(float(x) for x in P.MPC_BODY_INERTIA),
                       qp_weights=WEIGHTS, admm_iters=100)
  cases = [(np.ones(4, np.int32), np.array([0.1, 0.02, 0.0]),
            np.array([0.02, -0.03, 0.0]), np.zeros(3),
            np.array([0.3, 0.0, 0.0]), np.zeros(3))] + _cases()
  d = lambda x: torch.tensor(np.asarray(x, np.float64))
  for case in cases:
    contacts, vel, rpy, rate, dvel, dang = case
    f_native = np.array(native.compute_contact_forces(*_args(case))[:12]
                        ).reshape(4, 3)
    f_torch = tmpc.compute_contact_forces(
        cfg, d([[0.0, 0.0, 0.24]]), d(vel)[None], d(rpy)[None],
        d(rate)[None], torch.tensor(contacts)[None], d(FEET)[None],
        torch.full((1, 4), 0.45, dtype=torch.float64), d([0.0, 0.0, 0.24]),
        d(dvel)[None], torch.zeros(1, 3, dtype=torch.float64),
        d(dang)[None])[0].numpy()
    np.testing.assert_allclose(f_native, f_torch, atol=3.0)
    assert np.abs(f_native).max() > 5.0


@pytest.mark.parametrize("name", ["a1 (RL-MPC SRB)"] + sorted(
    EXPECTED_TOTAL_FZ))
def test_native_matches_the_cold_solve_standing(name):
  """Every robot's standing QP (its mass, inertia, height and hips, all
  legs in stance): the native core and the port's cold solve in float64
  at 200 iterations (tests/test_mpc.py:238-289's budget) within 3.0 N;
  a1_sim's tiny inertia is the slow case (0.57 N after 200)."""
  if name.startswith("a1 ("):
    mass, inertia, h = (float(P.MPC_BODY_MASS),
                        tuple(float(x) for x in P.MPC_BODY_INERTIA), 0.24)
    hips = robot_params.A1.hip_positions
  else:
    rp = robot_params.ROBOTS[name]
    mass, inertia, h, hips = (rp.body_mass, tuple(rp.body_inertia),
                              rp.body_height, rp.hip_positions)
  feet = np.asarray([[x, y, -h] for x, y, _ in hips])
  f_native = np.array(_native(mpc_osqp, mass, inertia).compute_contact_forces(
      *_args(_cases()[0], h, feet))[:12]).reshape(4, 3)
  cfg = tmpc.MpcConfig(mass=mass, inertia=inertia, qp_weights=WEIGHTS,
                       admm_iters=200)
  z = torch.tensor([[0.0, 0.0, h]], dtype=torch.float64)
  zero = torch.zeros(1, 3, dtype=torch.float64)
  f_torch = tmpc.compute_contact_forces(
      cfg, z, zero, zero, zero, torch.ones(1, 4, dtype=torch.int32),
      torch.tensor(feet)[None], torch.full((1, 4), 0.45, dtype=torch.float64),
      z[0], zero[0], zero[0], zero[0])[0].numpy()
  np.testing.assert_allclose(f_native, f_torch, atol=3.0)
