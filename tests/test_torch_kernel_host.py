"""The physics-window kernel's CUDA source compiled for the host and held
against its plain PyTorch version on the CPU.

The kernel body is plain C++ apart from a few CUDA keywords; here it is
built with g++ against a header that defines those keywords away, and
run one env per call through the same packing code the CUDA launch uses
(`ops.physics_kernel._launch`).  This checks the kernel's arithmetic and
buffer layout without a card; the card runs it through
tests/test_torch_kernel_cuda.py and chip_smoke.py.  Skipped where no
g++ is installed.

The comparison is `physics_kernel.compare_with_plain`, on every env: the
kernel's float64 instantiation against the plain version in float64 at
the tolerances of tests/test_physics_kernel.py, and the float32 kernel
against the same float64 run within those tolerances or twice the env's
own float32 spread (see that function).
"""
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.ops import physics_kernel as pk
from vision4leg_torch.physics import engine
from vision4leg_torch.robots import a1, a1_model

_HOST_HEADER = """
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __constant__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct Dim3 { int x = 0, y = 0, z = 0; };
static Dim3 blockIdx, threadIdx, blockDim;
"""

_HOST_LAUNCH = """
template <typename T>
static void run_all(const void* state_in, void* state_out, const void* params,
                    const void* model, void* pen_out, int E, int K, int Q,
                    int n_substeps, int interpolate, int hybrid, double dt) {
  blockDim.x = 32;
  for (int e = 0; e < E; ++e) {
    blockIdx.x = e / 32;
    threadIdx.x = e % 32;
    physics_window_kernel<T>((const T*)state_in, (T*)state_out,
                             (const T*)params, (const T*)model, (T*)pen_out,
                             E, K, Q, n_substeps, interpolate, hybrid,
                             (T)dt);
  }
}

extern "C" int physics_window_launch(const void* state_in, void* state_out,
                                     const void* params, const void* model,
                                     void* pen_out, int E, int K, int Q,
                                     int n_substeps, int interpolate,
                                     int hybrid, double dt, int f64) {
  if (f64)
    run_all<double>(state_in, state_out, params, model, pen_out, E, K, Q,
                    n_substeps, interpolate, hybrid, dt);
  else
    run_all<float>(state_in, state_out, params, model, pen_out, E, K, Q,
                   n_substeps, interpolate, hybrid, dt);
  return 0;
}
"""


def _build_host(d, src):
  """Compile kernel source text `src` for the host in directory d; returns
  its launch function."""
  gxx = shutil.which("g++")
  if gxx is None:
    pytest.skip("needs g++ to build the kernel source for the host")
  (d / "cuda_runtime.h").write_text(_HOST_HEADER)
  body = src[:src.index('extern "C" int physics_window_launch')]
  (d / "kernel.cpp").write_text(body + _HOST_LAUNCH)
  so = d / "kernel.so"
  proc = subprocess.run(
      [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
       "-Wno-unknown-pragmas", "-I", str(d), "-o", str(so),
       str(d / "kernel.cpp")], capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert "warning" not in proc.stderr, proc.stderr
  fn = ctypes.CDLL(str(so)).physics_window_launch
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
      ctypes.c_double, ctypes.c_int]
  fn.restype = ctypes.c_int
  return fn


@pytest.fixture(scope="module")
def host_launch(tmp_path_factory):
  with open(pk.SOURCE) as f:
    return _build_host(tmp_path_factory.mktemp("host_kernel"), f.read())


def _inputs(E, n_sph, seed, interpolate):
  """A standing batch with randomized dynamics and commands, one box at
  the front toes and, with n_sph, one sphere at a rear toe (the setup of
  tests/test_physics_kernel.py, varied per env)."""
  rng = np.random.default_rng(seed)
  model = a1_model.build(dt=0.0025)
  t = lambda x: torch.tensor(np.asarray(x, np.float32))
  q0 = np.array([0, 0.9, -1.8] * 4, np.float32)
  phys = engine.PhysState(
      pos=t(np.c_[rng.uniform(-0.1, 0.1, (E, 2)), np.full(E, 0.27)]),
      quat=t(np.tile([1.0, 0, 0, 0], (E, 1))),
      joint_q=t(q0 + rng.uniform(-0.1, 0.1, (E, 12))),
      ang=t(rng.normal(0, 0.05, (E, 3))),
      lin=t(rng.normal(0, 0.05, (E, 3))),
      joint_qd=t(rng.normal(0, 0.1, (E, 12))))
  rs = a1.init_robot_state(phys)
  rs.obs_hist = rs.obs_hist + t(rng.normal(0, 0.1, rs.obs_hist.shape))
  rs.step_counter = torch.tensor(rng.integers(0, 100, E), dtype=torch.int32)
  dyn = a1.DynamicsParams(
      kp=t(np.full((E, 12), 60.0)), kd=t(np.full((E, 12), 0.6)),
      strength_ratios=t(rng.uniform(0.8, 1.2, (E, 12))),
      motor_friction=t(rng.uniform(0, 0.05, E)),
      joint_friction=t(rng.uniform(0, 0.05, E)),
      control_latency=t(np.zeros(E)), lateral_friction=t(np.ones(E)),
      mass_scale=t(rng.uniform(0.8, 1.2, (E, 13))),
      inertia_scale=t(rng.uniform(0.5, 1.5, (E, 13))))
  boxes = np.zeros((E, 8, 8), np.float32)
  boxes[:, 0] = [0.15, 0.0, 0.05, 0.1, 0.1, 0.05, 0.3, 1.0]
  boxes[:, 0, :2] += rng.uniform(-0.05, 0.05, (E, 2))
  spheres = np.zeros((E, n_sph, 5), np.float32)
  if n_sph:
    spheres[:, 0] = [-0.18, 0.13, 0.0, 0.12, 1.0]
  cmd = t(q0 + rng.uniform(-0.15, 0.15, (E, 12)))
  return (model, rs, cmd, dyn, t(boxes), t(spheres),
          t(rng.uniform(0.5, 1.25, E)), t(rng.uniform(0.5, 1.25, E)), 16,
          interpolate)


@pytest.mark.parametrize("n_sph,interpolate", [(0, False), (2, False),
                                               (2, True)])
def test_kernel_source_matches_plain_on_host(host_launch, n_sph,
                                             interpolate):
  args = _inputs(64, n_sph, seed=n_sph + 3 * interpolate,
                 interpolate=interpolate)
  ok, report = pk.compare_with_plain(
      args, run=lambda *a: pk._launch(*a, launch=host_launch))
  assert ok, report
  # most envs touch the box (or the sphere): the contact paths run
  _, pen_ref = pk.window_plain(*args)
  assert bool((pen_ref[..., 1] > 0).any(-1).float().mean() > 0.5)


def test_kernel_source_matches_plain_on_smoke_contact_case(host_launch):
  """chip_smoke.py's contact batch at 64 envs: per-env poses, some joints
  past their limits, boxes under the toes at faces, edges and corners
  and deep enough to hold toes inside, spheres against other toes."""
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(root, "chip_smoke.py"))
  smoke = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(smoke)
  with open(os.path.join(root, smoke.CONFIG)) as f:
    params = json.load(f)
  env, _ = get_env(params["env_name"], params["env"], device="cpu")
  E = 64
  gen = torch.Generator().manual_seed(0)
  xy = torch.rand(E, 2, generator=gen)
  cmd = env.settled_template().phys.joint_q + 0.3 * (
      torch.rand(E, 12, generator=gen) - 0.5)
  args = smoke.contact_case(env.model, env.settled_template(), xy, cmd,
                            a1.default_dynamics(env.model, (E,)),
                            env.cfg.num_action_repeat)
  ok, report = pk.compare_with_plain(
      args, run=lambda *a: pk._launch(*a, launch=host_launch))
  assert ok, report
  counts = {}
  pk.window_plain(*args, counts=counts)
  assert int(counts["box_contacts"].sum()) > 0
  assert int(counts["box_inside"].sum()) > 0
  assert int(counts["sphere_contacts"].sum()) > 0
  q = args[1].phys.joint_q
  assert bool(((q < env.model.joint_lower) | (q > env.model.joint_upper))
              .any())


def _hybrid_args(E, seed):
  """`_inputs` with 5 substeps in hybrid mode: feedforward torques of up
  to 8 Nm and a stance mask that mixes stance and swing legs within every
  env (whole legs, as the MPC env masks them)."""
  args = _inputs(E, 2, seed, False)
  rng = np.random.default_rng(seed + 100)
  legs = rng.uniform(size=(E, 4)) < 0.5
  legs[:, 0], legs[:, 1] = True, False
  mask = torch.tensor(np.repeat(legs, 3, axis=1).astype(np.float32))
  tau_ff = torch.tensor(rng.uniform(-8.0, 8.0, (E, 12)).astype(np.float32))
  return args[:8] + (5, False, tau_ff, mask)


def test_hybrid_kernel_source_matches_plain_on_host(host_launch):
  """Hybrid mode (the MPC env's window: 5 substeps) on a mixed-mask
  batch."""
  args = _hybrid_args(64, seed=5)
  ok, report = pk.compare_with_plain(
      args, run=lambda *a: pk._launch(*a, launch=host_launch))
  assert ok, report
  new, _ = pk._launch(*args, launch=host_launch)
  ff = args[-1] > 0.5
  assert torch.equal(new.observed_torques[ff], args[-2][ff])


# Mutations of the hybrid path that the comparison must catch.
_HYBRID_MUTATIONS = {
    "blend flipped": (
        "tau[j] = (T(1.0) - m) * tau[j] + m * hyb[(size_t)j * E];",
        "tau[j] = m * tau[j] + (T(1.0) - m) * hyb[(size_t)j * E];"),
    "mask read from the tau_ff rows": (
        "T m = hyb[(size_t)(NJ + j) * E];", "T m = hyb[(size_t)j * E];"),
    "hybrid rows before the spheres": (
        "const T* hyb = PP + (size_t)(P_BOX + 8 * K + 5 * Q) * E;",
        "const T* hyb = PP + (size_t)(P_BOX + 8 * K) * E;"),
}


@pytest.mark.parametrize("mutation", sorted(_HYBRID_MUTATIONS))
def test_hybrid_comparison_catches_mutations(tmp_path, mutation):
  """A copy of the kernel source with one fault in its hybrid path fails
  compare_with_plain on the mixed-mask batch."""
  with open(pk.SOURCE) as f:
    src = f.read()
  old, new = _HYBRID_MUTATIONS[mutation]
  assert src.count(old) == 1
  launch = _build_host(tmp_path, src.replace(old, new))
  ok, _ = pk.compare_with_plain(
      _hybrid_args(16, seed=1),
      run=lambda *a: pk._launch(*a, launch=launch))
  assert not ok
