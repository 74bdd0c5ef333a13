"""Print the full kernel-vs-plain report of one case of the card-only test
tests/test_torch_kernel_cuda.py::test_kernel_matches_plain, on the card.

    python3 tools/window_case_report.py [--root DIR] [--n_sph N]
    python3 tools/window_case_report.py --locate [--n_sph N] [--trace_dir DIR]
    python3 tools/window_case_report.py --time [--variant FLAGS]

Runs that test case of the checkout at DIR (default: this one) with
`physics_kernel.compare_with_plain` wrapped so that each field's numbers
are printed (the test's assertion shows them cut short), then prints
whether the case passed.  Running it on two checkouts on one card shows
whether their kernels compute the same on the test's inputs.

`--locate` looks for where the float32 kernel parts from the plain
version on that case, and prints:
* each env whose float32 kernel error against the float64 plain run
  exceeds the gate, with its float32 plain error and spread;
* for the worst env, the errors after n_sub = 1 .. n substeps (kernel
  float32, plain float32 and kernel float64, each against the plain
  float64 run);
* the worst env's per-substep trace (every contact point's ground, box
  and sphere penetration, the PCG's rz / pMp / alpha, the solved vdot)
  from a traced copy of the source built twice: with nvcc for the card
  and with g++ for the host (the build of tests/test_torch_kernel_host.py),
  and the first line where the two traces part;
* the case's compare_with_plain verdict with the source built by nvcc
  under each of `--variant` extra flags (default: -fmad=true, nvcc's
  contraction of a * b + c into one FMA, which the window's build turns
  off).

`--time` times the window kernel built with its own flags and with each
`--variant`'s in their place, in turns, at chip_smoke.py's shapes (see
`time_flags`).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import tempfile

FIELDS = ("max_abs_err", "f64_max_err", "f32_kernel_vs_f64",
          "f32_plain_vs_f64", "f32_spread", "excused", "failed")

# trace points inserted into a copy of the source (anchor, text after it);
# TR prints for the traced env of the float instantiation only
_TRACE_HEADER = """
#include <cstdio>
#define TR(...) do { if (sizeof(T) == 4 && e == TRACE_ENV) \\
    printf(__VA_ARGS__); } while (0)
"""
_TRACE_POINTS = (
    ("      T phi_g = rad - x.z;\n",
     '      TR("s%d c%d ground %.9e\\n", s, c, (double)phi_g);\n'),
    ("        fo = add(fo, box_force(x, vel, rad, boxes + (size_t)8 * k * E, "
     "E, mu_b, &phib));\n",
     '        TR("s%d c%d box%d %.9e\\n", s, c, k, (double)phib);\n'),
    ("        fo = add(fo, sphere_force(x, vel, rad, spheres + (size_t)5 * k "
     "* E, E, mu_b, &phib));\n",
     '        TR("s%d c%d sphere%d %.9e\\n", s, c, k, (double)phib);\n'),
    ("      T alpha = rz / Fmax(pMp, T(1e-12));\n",
     '      TR("s%d it%d rz %.9e pMp %.9e alpha %.9e\\n", s, it, (double)rz, '
     '(double)pMp, (double)alpha);\n'),
    ("    // --- semi-implicit Euler + quaternion exponential map ---\n",
     '    for (int i = 0; i < NV; ++i) TR("s%d vdot%d %.9e\\n", s, i, '
     '(double)x_[i]);\n'),
)


def traced_source(src: str, env: int) -> str:
  """The kernel source with the trace points for env `env`; loops whose
  body gains a trace line get braces."""
  out = src.replace("#include <cuda_runtime.h>\n",
                    f"#include <cuda_runtime.h>\n#define TRACE_ENV {env}\n"
                    + _TRACE_HEADER, 1)
  for anchor, line in _TRACE_POINTS:
    if out.count(anchor) != 1:
      raise ValueError(f"trace anchor not found once: {anchor!r}")
    if anchor.lstrip().startswith("fo = "):
      head = anchor[:len(anchor) - len(anchor.lstrip())]
      loop = out[:out.index(anchor)].rsplit("\n", 2)[-2] + "\n"
      out = out.replace(loop + anchor, loop.rstrip("\n") + " {\n" + anchor
                        + line + head[:-2] + "}\n", 1)
    else:
      out = out.replace(anchor, anchor + line, 1)
  return out


def nvcc_launch(src: str, d: pathlib.Path, extra=()):
  """Build kernel source text with nvcc (the port's flags, then `extra` in
  place of the window's own) into d; returns launch(*args) on the current
  stream."""
  import torch
  from vision4leg_torch.ops import nvcc
  (d / "k.cu").write_text(src)
  so = d / "k.so"
  own = tuple(extra) or nvcc.EXTRA_FLAGS["physics_window"]
  subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, *own, "-o", str(so),
                  str(d / "k.cu")], check=True, capture_output=True)
  fn = ctypes.CDLL(str(so)).physics_window_launch
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
      ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return lambda *a: fn(*a, torch.cuda.current_stream().cuda_stream)


def trace_run(pk, args, which: str, env: int) -> None:
  """Run the window on `args` through the traced source built for
  `which` ("card": nvcc, run on the card; "host": g++, run on the CPU),
  printing env `env`'s trace to this process's stdout."""
  import torch
  import test_torch_kernel_host as host
  with open(pk.SOURCE) as f:
    src = traced_source(f.read(), env)
  with tempfile.TemporaryDirectory() as tmp:
    d = pathlib.Path(tmp)
    if which == "card":
      launch = nvcc_launch(src, d)
    else:
      from vision4leg_torch.robots import a1_model
      launch = host._build_host(d, src)
      # the test's model (dt 0.0025) and inputs, on the CPU
      args = (a1_model.build(dt=0.0025),) + tuple(
          pk._cast(a, lambda x: x.cpu()) for a in args[1:])
    sys.stdout.flush()
    pk._launch(*args, launch=launch)
    if which == "card":
      torch.cuda.synchronize()
    ctypes.CDLL(None).fflush(None)


def locate(case, pk, args, variants, root, trace_dir=None) -> None:
  import torch
  args64 = tuple(pk._double(a) for a in args)
  worst = lambda a, b: (a.double() - b.double()).abs().amax(-1)
  for variant in variants:
    with tempfile.TemporaryDirectory() as tmp:
      with open(pk.SOURCE) as f:
        launch = nvcc_launch(f.read(), pathlib.Path(tmp), variant.split())
      ok, rep = pk.compare_with_plain(
          args, run=lambda *a: pk._launch(*a, launch=launch))
    print(f"nvcc {variant}: ok={ok} failed envs " + json.dumps(
        {k: v["failed"] for k, v in rep["fields"].items()}), flush=True)
  k32 = pk._per_env(*pk.robot_window(*args))
  p32 = pk._per_env(*pk.window_plain(*args))
  p64 = pk._per_env(*pk.window_plain(*args64))
  gen = torch.Generator(device="cuda").manual_seed(0)
  nudged = [pk._per_env(*pk.window_plain(*pk._nudged(args, gen)))
            for _ in range(pk.ROUNDING_SAMPLES)]
  score = torch.zeros(args[2].shape[0], dtype=torch.float64,
                      device=args[2].device)
  for k, tol in pk.WINDOW_TOL.items():
    e_k, e_p = worst(k32[k], p64[k]), worst(p32[k], p64[k])
    spread = torch.stack([e_p] + [worst(n[k], p64[k]) for n in nudged]
                         ).amax(0)
    gate = torch.clamp(2 * spread, min=tol)
    score = torch.maximum(score, e_k / gate)
    for env in torch.nonzero(e_k > gate).flatten().tolist():
      print(f"fails {k} env {env}: kernel32 {float(e_k[env]):.3e} plain32 "
            f"{float(e_p[env]):.3e} spread {float(spread[env]):.3e} gate "
            f"{float(gate[env]):.3e}", flush=True)
  env = int(score.argmax())
  print(f"worst env {env}: kernel error / gate {float(score[env]):.3f}",
        flush=True)
  n, first = args[8], None
  for n_sub in range(1, n + 1):
    a = args[:8] + (n_sub,) + args[9:]
    a64 = args64[:8] + (n_sub,) + args64[9:]
    r64 = pk._per_env(*pk.window_plain(*a64))
    row = {}
    for name, got in (("kernel32", pk.robot_window(*a)),
                      ("plain32", pk.window_plain(*a)),
                      ("kernel64", pk.robot_window(*a64))):
      pe = pk._per_env(*got)
      row[name] = {k: float(worst(pe[k][env:env + 1], r64[k][env:env + 1]))
                   for k in ("joint_q", "joint_qd", "ang", "pen_end")}
    print(f"n_sub {n_sub}: {json.dumps(row)}", flush=True)
    if first is None and row["kernel32"]["joint_qd"] > max(
        100 * row["plain32"]["joint_qd"], 1e-3):
      first = n_sub
  if first is None:
    print("the kernel does not part from the plain version", flush=True)
    return
  print(f"env {env} parts at n_sub {first}: tracing substeps 0..{first - 1}",
        flush=True)
  traces = {}
  for which in ("card", "host"):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--root", root,
         "--trace", which, "--env", str(env), "--n_sub", str(first)],
        capture_output=True, text=True)
    if proc.returncode != 0:
      print(f"trace on {which} failed:\n{proc.stderr[-3000:]}", flush=True)
      return
    traces[which] = proc.stdout
  if trace_dir:
    os.makedirs(trace_dir, exist_ok=True)
    for which, text in traces.items():
      pathlib.Path(trace_dir, f"window_trace_{which}.txt").write_text(text)
  c_lines = traces["card"].splitlines()
  h_lines = traces["host"].splitlines()
  print(f"trace of env {env}: {len(c_lines)} card lines, {len(h_lines)} "
        f"host lines", flush=True)
  first_diff = None
  for i, (c, h) in enumerate(zip(c_lines, h_lines)):
    cv, hv = c.split(), h.split()
    if cv[:-1] != hv[:-1] or _rel(cv[-1], hv[-1]) > 1e-3:
      first_diff = i
      break
  if first_diff is None:
    print("traces agree to 1e-3 relative throughout", flush=True)
    return
  for i in range(max(0, first_diff - 10), min(len(c_lines),
                                               first_diff + 30)):
    print(f"  card {c_lines[i]:<64s} host {h_lines[i]}", flush=True)


def time_flags(variants) -> None:
  """Time the window kernel built with the window's own flags and with
  each variant's in place of them, in turns (variant, own, own, variant),
  at chip_smoke.py's shapes: a thin-goal env step's window (1024 envs, 16
  substeps) and an MPC controller tick's hybrid window (1024 envs, 5
  substeps), on states after a few random steps."""
  import torch
  import chip_smoke as smoke
  from vision4leg_torch.ops import nvcc
  from vision4leg_torch.ops import physics_kernel as pk
  dev = torch.device("cuda")
  n = smoke.NUM_ENVS
  env, _, _, _ = smoke.build_main_path(dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  act = lambda e, k: e.action_low + (e.action_high - e.action_low) * \
      torch.rand(n, k, generator=gen, device=dev)
  states, _ = env.reset(n, gen)
  for _ in range(3):
    states, _, _, _, _ = env.step_batch(states, act(env, 6), gen)
  cases = {"rollout": smoke.rollout_window_inputs(
      env, states, env._expand_action(act(env, 6)))}
  mpc_env, _, _, _ = smoke.build_mpc_path(dev)
  states, _ = mpc_env.reset(n, gen)
  for _ in range(2):
    states, _, _, _, _ = mpc_env.step_batch(states, act(mpc_env, 2), gen)
  cases["hybrid"] = smoke.mpc_window_inputs(mpc_env, states,
                                            act(mpc_env, 2))
  with open(pk.SOURCE) as f:
    src = f.read()
  own = " ".join(nvcc.EXTRA_FLAGS["physics_window"])
  with tempfile.TemporaryDirectory() as tmp:
    launches = {}
    for flags in [own] + list(variants):
      d = pathlib.Path(tmp, str(len(launches)))
      d.mkdir()
      launches[flags] = nvcc_launch(src, d, flags.split())
    for name, args in cases.items():
      for variant in variants:
        ms = []
        for flags in (variant, own, own, variant):
          launch = launches[flags]
          ms.append(smoke.time_ms(lambda: pk._launch(*args, launch=launch)))
        print(f"window [{name}, {args[2].shape[0]} envs x {args[8]} "
              f"substeps]: built with {variant}: {ms[0]:.4f} / {ms[3]:.4f} "
              f"ms; with {own}: {ms[1]:.4f} / {ms[2]:.4f} ms (25 "
              f"back-to-back calls each, in turns)", flush=True)


def _rel(a: str, b: str) -> float:
  try:
    x, y = float(a), float(b)
  except ValueError:
    return 0.0 if a == b else float("inf")
  return abs(x - y) / max(abs(x), abs(y), 1e-6)


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))))
  ap.add_argument("--n_sph", type=int, default=2)
  ap.add_argument("--locate", action="store_true")
  ap.add_argument("--variant", action="append", default=None)
  ap.add_argument("--trace_dir", help="with --locate: write both full "
                  "traces there")
  ap.add_argument("--time", action="store_true")
  ap.add_argument("--trace", choices=("card", "host"))
  ap.add_argument("--env", type=int)
  ap.add_argument("--n_sub", type=int)
  args = ap.parse_args()
  import torch
  if not torch.cuda.is_available():
    print("window_case_report: no CUDA device", file=sys.stderr)
    return 2
  root = os.path.abspath(args.root)
  sys.path[:0] = [root, os.path.join(root, "tests")]
  if args.time:
    time_flags(args.variant or ["-fmad=true"])
    return 0
  import test_torch_kernel_cuda as case
  compare = case.pk.compare_with_plain
  seen = []

  def report(window_args, run=None):
    seen.append(window_args)
    ok, rep = compare(window_args, run)
    for k, v in rep["fields"].items():
      print(k, json.dumps({f: v[f] for f in FIELDS}), flush=True)
    return ok, rep

  if args.trace:
    case.pk.compare_with_plain = lambda a, run=None: seen.append(a) or (
        True, None)
    case.test_kernel_matches_plain(torch.device("cuda"), args.n_sph)
    window_args = seen[0][:8] + (args.n_sub,) + seen[0][9:]
    trace_run(case.pk, window_args, args.trace, args.env)
    return 0
  case.pk.compare_with_plain = report
  try:
    case.test_kernel_matches_plain(torch.device("cuda"), args.n_sph)
    passed = True
  except AssertionError:
    passed = False
  case.pk.compare_with_plain = compare
  print(f"{root}: case n_sph={args.n_sph} "
        f"{'passed' if passed else 'failed'}", flush=True)
  if args.locate:
    locate(case, case.pk, seen[0], args.variant or ["-fmad=true"], root,
           args.trace_dir)
  return 0 if passed else 1


if __name__ == "__main__":
  sys.exit(main())
