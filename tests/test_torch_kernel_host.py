"""The physics-window kernel's CUDA source compiled for the host and held
against its plain PyTorch version on the CPU.

The kernel is written as warp-synchronous phases (`PW_PHASE`), each a
function of (env, lane) whose lanes write disjoint outputs in the env's
shared-memory slab and read only what earlier phases wrote.  Here the
source is built with g++ against a header that defines the CUDA keywords
away and makes each phase run for lanes 0..31 in turn before the next
starts, env after env, with the env's slab filled with NaN, through the
same packing code the CUDA launch uses (`ops.physics_kernel._launch`).  This checks the kernel's arithmetic,
indexing and slab layout without a card; the card runs it through
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
import re
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
#define __host__
#define __forceinline__ inline
#define __restrict__
// with reversed set, warps and lanes run in the opposite order
static int reversed = 0;
// a phase: its statement for lanes 0..31 in turn
#define PW_PHASE(kind, ...)                                    \\
  for (int pw_lane = 0; pw_lane < 32; ++pw_lane) {             \\
    const int lane = reversed ? 31 - pw_lane : pw_lane;        \\
    __VA_ARGS__;                                               \\
  }
"""

_HOST_LAUNCH = """
#include <algorithm>
#include <vector>
extern "C" void physics_window_host_reverse(int r) { reversed = r; }

// Each block's warps one after another (their last block's idle ones
// too), each env's slab alone in a buffer filled with NaN, as garbage in
// the shared memory, and followed by a guard band that must stay NaN.
template <typename T>
static int run_all(const PwArgs<T>& a) {
  const int slab = pw_slab_size(a.K, a.Q), guard = 64;
  const int blocks = (a.E + PW_WARPS - 1) / PW_WARPS;
  std::vector<T> mdl(M_SIZE), x(slab + guard);
  for (int t = 0; t < PW_THREADS; ++t)
    pw_stage_model(a, mdl.data(), t, PW_THREADS);
  for (int blk = 0; blk < blocks; ++blk)
    for (int i = 0; i < PW_WARPS; ++i) {
      const int w = reversed ? PW_WARPS - 1 - i : i;
      std::fill(x.begin(), x.end(), (T)NAN);
      pw_window(a, mdl.data(), x.data(), blk * PW_WARPS + w, 0);
      for (int g = slab; g < slab + guard; ++g)
        if (!std::isnan(x[g])) return 1;
    }
  return 0;
}

extern "C" int physics_window_launch(const void* state_in, void* state_out,
                                     const void* params, const void* model,
                                     void* pen_out, int E, int K, int Q,
                                     int n_substeps, int interpolate,
                                     int hybrid, double dt, int f64) {
  if (f64)
    return run_all(pw_args<double>(state_in, state_out, params, model,
                                   pen_out, E, K, Q, n_substeps,
                                   interpolate, hybrid, dt));
  return run_all(pw_args<float>(state_in, state_out, params, model, pen_out,
                                E, K, Q, n_substeps, interpolate, hybrid,
                                dt));
}
"""


def _build_host(d, src):
  """Compile kernel source text `src` for the host in directory d; returns
  its launch function."""
  gxx = shutil.which("g++")
  if gxx is None:
    pytest.skip("needs g++ to build the kernel source for the host")
  (d / "cuda_runtime.h").write_text(_HOST_HEADER)
  (d / "kernel.cpp").write_text(src + _HOST_LAUNCH)
  so = d / "kernel.so"
  proc = subprocess.run(
      [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
       "-Wno-unknown-pragmas", "-I", str(d), "-o", str(so),
       str(d / "kernel.cpp")], capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert "warning" not in proc.stderr, proc.stderr
  lib = ctypes.CDLL(str(so))
  fn = lib.physics_window_launch
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
      ctypes.c_double, ctypes.c_int]
  fn.restype = ctypes.c_int
  fn.reverse = lib.physics_window_host_reverse
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


def _warps_per_block():
  with open(pk.SOURCE) as f:
    return int(re.search(r"#define PW_WARPS (\d+)", f.read()).group(1))


@pytest.mark.parametrize("extra", [1, -1])
def test_kernel_source_matches_plain_on_ragged_batches(host_launch, extra):
  """A batch whose last block is ragged (extra = 1: E = PW_WARPS + 1,
  with interpolated commands) and one env alone in hybrid mode (extra =
  -1: E = 1): the envs of a block are independent and its idle warps
  write nothing."""
  if extra < 0:
    args = _hybrid_args(1, seed=21)
  else:
    E = _warps_per_block() + extra
    args = _inputs(E, 2, seed=10 + E, interpolate=True)
  ok, report = pk.compare_with_plain(
      args, run=lambda *a: pk._launch(*a, launch=host_launch))
  assert ok, report


def _bits(x):
  return x.contiguous().view(torch.int64 if x.dtype == torch.float64
                             else torch.int32)


@pytest.mark.parametrize("hybrid", [False, True])
def test_kernel_phases_do_not_depend_on_lane_order(host_launch, hybrid):
  """Every phase's lanes write disjoint outputs and read only what earlier
  phases wrote: run with warps and lanes in the opposite order, the
  kernel gives the same bits, float32 and float64."""
  args = _hybrid_args(6, seed=2) if hybrid else _inputs(6, 2, 4, True)
  for a in (args, tuple(pk._double(x) for x in args)):
    got = []
    for rev in (0, 1):
      host_launch.reverse(rev)
      try:
        rs, pen = pk._launch(*a, launch=host_launch)
      finally:
        host_launch.reverse(0)
      out = pk._per_env(rs, pen).values()
      assert all(bool(torch.isfinite(v).all()) for v in out)
      got.append([_bits(v) for v in out])
    for x, y in zip(*got):
      assert torch.equal(x, y)


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
        "tau = (T(1.0) - m) * tau + m * hyb[j];",
        "tau = m * tau + (T(1.0) - m) * hyb[j];"),
    "mask read from the tau_ff rows": (
        "T m = hyb[NJ + j];", "T m = hyb[j];"),
    "hybrid rows before the spheres": (
        "const T* hyb = x + X_BOX + 9 * a.K + 5 * a.Q;",
        "const T* hyb = x + X_BOX + 9 * a.K;"),
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
