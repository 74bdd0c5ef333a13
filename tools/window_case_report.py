"""Reports on the physics-window kernel, on the card.

    python3 tools/window_case_report.py [--root DIR] [--n_sph N]
    python3 tools/window_case_report.py --other DIR
    python3 tools/window_case_report.py --locate [--n_sph N] [--trace_dir DIR]
    python3 tools/window_case_report.py --time [--variant FLAGS]
    python3 tools/window_case_report.py --phases

By default runs one case of the card-only test
tests/test_torch_kernel_cuda.py::test_kernel_matches_plain for the
checkout at DIR (default: this one) with
`physics_kernel.compare_with_plain` wrapped so that each field's numbers
are printed (the test's assertion shows them cut short), then prints
whether the case passed.

`--other DIR` holds this checkout's window kernel against that of
another checkout (the parent commit, say, unpacked with `git archive`):
both sources are built by nvcc with the window's flags into this
process, and both run through this checkout's wrapper
(`physics_kernel._launch`, whose C interface they share) on chip_smoke.py's
window batches (`window_cases`): rollout states, the contact batch and
the card test's sphere batch, and the MPC env's hybrid window on its own
states and on a contact batch.  Prints, for each batch in float32 and in
float64, whether every output (state, history, contact read) has the
same bits in both builds, and where not, how many values differ and by
how much; then each build's ptxas counts, and the times of the rollout
and hybrid windows at 1024 envs and at the first 8 envs (eval's size),
built in turns (other, this, this, other): the kernel alone
(`chip_smoke.window_kernel_ms`) and the whole wrapper call with its
env-first <-> env-last packing (`chip_smoke.time_ms`).  Exits 1 if any
output differs.

`--locate` looks for where the float32 kernel parts from the plain
version on the test case, and prints:
* each env whose float32 kernel error against the float64 plain run
  exceeds the gate, with its float32 plain error and spread;
* for the worst env, the errors after n_sub = 1 .. n substeps (kernel
  float32, plain float32 and kernel float64, each against the plain
  float64 run);
* the worst env's per-substep trace (every contact point's ground, box
  and sphere penetration, the PCG's rz / pMp / alpha, the solved vdot)
  from a traced copy of the source built twice: with nvcc for the card
  and with g++ for the host (the build of tests/test_torch_kernel_host.py),
  and the first entry where the two traces part;
* the case's compare_with_plain verdict with the source built by nvcc
  under each of `--variant` extra flags (default: -fmad=true, nvcc's
  contraction of a * b + c into one FMA, which the window's build turns
  off).

`--time` times the window kernel built with its own flags and with each
`--variant`'s in their place, in turns, at chip_smoke.py's shapes (see
`time_flags`).

`--phases` splits one env's window into its phases: a copy of the source
(`clocked_source`) sums the SM clock cycles of each kind of phase for
env 0, which runs the rollout and hybrid batches at 1024 and at 8 envs;
prints cycles per substep by kind and the share of each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    ("  T phi_g = rad - xc.z;\n",
     '  TR("s%d c%d ground %.9e\\n", s, c, (double)phi_g);\n'),
    ("    phib = box_phi(xc, rad, boxes + 9 * k, &n);\n",
     '    TR("s%d c%d box%d %.9e\\n", s, c, k, (double)phib);\n'),
    ("    phib = sphere_phi(xc, rad, spheres + 5 * k, &n);\n",
     '    TR("s%d c%d sphere%d %.9e\\n", s, c, k, (double)phib);\n'),
    ("  T alpha = rz[it & 1] / Fmax(pMp, T(1e-12));\n",
     '  if (i == 0) TR("s%d it%d rz %.9e pMp %.9e alpha %.9e\\n", s, it, '
     '(double)rz[it & 1], (double)pMp, (double)alpha);\n'),
    ("        PW_PHASE(K_CG_BETA, if (lane < NV) pw_cg_beta(x, it, lane));\n"
     "    }\n",
     '    PW_PHASE(K_STEP, if (lane < NV) TR("s%d vdot%d %.9e\\n", s, lane, '
     '(double)x[X_X + lane]));\n'),
)


def traced_source(src: str, env: int) -> str:
  """The kernel source with the trace points for env `env`."""
  out = src.replace("#include <cuda_runtime.h>\n",
                    f"#include <cuda_runtime.h>\n#define TRACE_ENV {env}\n"
                    + _TRACE_HEADER, 1)
  for anchor, line in _TRACE_POINTS:
    if out.count(anchor) != 1:
      raise ValueError(f"trace anchor not found once: {anchor!r}")
    out = out.replace(anchor, anchor + line, 1)
  return out


_CLOCKS = """
// cycles of env 0 by kind of phase (K_*)
__device__ unsigned long long pw_clk[64];
#define PW_PHASE(kind, ...) do {                                     \\
    const long long pw_t0 = clock64();                               \\
    __VA_ARGS__;                                                     \\
    __syncwarp();                                                    \\
    if (lane == 0 && e == 0) pw_clk[kind] += clock64() - pw_t0;      \\
  } while (0)
"""
_CLOCKS_READ = """
extern "C" int pw_clocks(unsigned long long* out) {
  static const unsigned long long zero[64] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(out, pw_clk, sizeof(pw_clk));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(pw_clk, zero, sizeof(zero));
  return (int)err;
}
"""


def clocked_source(src: str):
  """The kernel source with each phase of env 0 timed by clock64() and
  summed by kind into pw_clk (read and zeroed by pw_clocks), and the
  kinds' names, in the order of the source's K_* enum."""
  kinds = re.search(r"enum : int \{\s*(K_STAGE[^}]*?),\s*PW_KINDS", src)
  head = "#include <cuda_runtime.h>\n"
  if kinds is None or src.count(head) != 1 or \
      src.count("#ifdef __CUDACC__\n") != 1:
    raise ValueError("K_* enum, include or CUDA block not found once")
  out = src.replace(head, head + _CLOCKS, 1)
  out = out.replace("#ifdef __CUDACC__\n", "#ifdef __CUDACC__\n" + _CLOCKS_READ)
  return out, [k.strip()[2:].lower() for k in kinds.group(1).split(",")]


def phase_clocks() -> None:
  """Cycles of env 0's phases, by kind, on the rollout and hybrid
  batches at 1024 and 8 envs."""
  import torch
  import chip_smoke as smoke
  from vision4leg_torch.ops import physics_kernel as pk
  print(smoke.card_name(), flush=True)
  cases = window_cases(torch.device("cuda"))
  with open(pk.SOURCE) as f:
    src, kinds = clocked_source(f.read())
  once = ("stage", "out", "read")       # once a window; the rest a substep
  with tempfile.TemporaryDirectory() as tmp:
    fn, _ = nvcc_build(src, pathlib.Path(tmp))
    lib = ctypes.CDLL(str(pathlib.Path(tmp, "k.so")))
    buf = (ctypes.c_ulonglong * 64)()
    lib.pw_clocks(buf)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for cname in ("rollout", "hybrid"):
      for n_env in (smoke.NUM_ENVS, 8):
        args = smoke.take_envs(cases[cname], n_env)
        n_sub = args[8]
        pk._launch(*args, launch=lambda *a: fn(*a, stream()))
        torch.cuda.synchronize()
        if lib.pw_clocks(buf) != 0:
          raise RuntimeError("pw_clocks failed")
        per = {k: buf[i] / n_sub for i, k in enumerate(kinds)
               if k not in once}
        total = sum(per.values())
        print(f"[{cname}, {n_env} envs x {n_sub} substeps] env 0: "
              f"{total:.0f} cycles a substep ("
              + ", ".join(f"{k} {v:.0f} = {v / total:.3f}"
                          for k, v in per.items()) + "); once a window: "
              + ", ".join(f"{k} {buf[kinds.index(k)]}" for k in once)
              + " cycles", flush=True)


def nvcc_build(src: str, d: pathlib.Path, extra=()):
  """Build kernel source text with nvcc (the port's flags, then `extra` in
  place of the window's own) into d; returns (the C launch function, which
  takes the stream last, and ptxas's counts by instantiation)."""
  from vision4leg_torch.ops import nvcc
  (d / "k.cu").write_text(src)
  so = d / "k.so"
  own = tuple(extra) or nvcc.EXTRA_FLAGS["physics_window"]
  proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, *own, "-o", str(so),
                         str(d / "k.cu")], check=True, capture_output=True,
                        text=True)
  fn = ctypes.CDLL(str(so)).physics_window_launch
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
      ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  counts = {"f64" if "IdE" in k else "f32": v for k, v in
            nvcc.ptxas_counts(proc.stdout + proc.stderr).items()}
  return fn, counts


def nvcc_launch(src: str, d: pathlib.Path, extra=()):
  """`nvcc_build`'s function as a launch(*args) on the current stream."""
  import torch
  fn, _ = nvcc_build(src, d, extra)
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
  # a warp's lanes print in another order on the card than one after
  # another on the host: entries are matched by their label
  card = {" ".join(l.split()[:-1]): l for l in traces["card"].splitlines()}
  host = traces["host"].splitlines()
  print(f"trace of env {env}: {len(card)} card entries, {len(host)} host "
        f"lines", flush=True)
  for i, h in enumerate(host):
    c = card.get(" ".join(h.split()[:-1]))
    if c is None or _rel(c.split()[-1], h.split()[-1]) > 1e-3:
      for line in host[max(0, i - 10):i + 30]:
        got = card.get(" ".join(line.split()[:-1]), "(missing)")
        print(f"  card {got:<64s} host {line}", flush=True)
      return
  print("traces agree to 1e-3 relative throughout", flush=True)


def window_cases(dev):
  """chip_smoke.py's window batches (name -> robot_window arguments):
  rollout states after a few random thin-goal steps, its contact batch
  and the card test's sphere batch; the MPC env's first controller tick
  of a step after two random steps, and a contact batch under mixed
  stance masks (hybrid mode).  All at 1024 envs but the sphere batch
  (101)."""
  import torch
  import chip_smoke as smoke
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
  (_, rs, cmd, dyn, _, _, _, _, n_sub) = cases["rollout"]
  tmpl = env.settled_template()
  cases["contact"] = smoke.contact_case(env.model, tmpl, rs.phys.pos[:, :2],
                                        cmd, dyn, n_sub)
  cases["sphere test case"] = smoke.sphere_case(dev)
  mpc_env, _, _, _ = smoke.build_mpc_path(dev)
  states, _ = mpc_env.reset(n, gen)
  for _ in range(2):
    states, _, _, _, _ = mpc_env.step_batch(states, act(mpc_env, 2), gen)
  cases["hybrid"] = smoke.mpc_window_inputs(mpc_env, states,
                                            act(mpc_env, 2))
  cases["hybrid contact"] = smoke.hybrid_contact_case(
      mpc_env, tmpl, cases["hybrid"])
  return cases


def _bits(x):
  """x's bit patterns as integers."""
  import torch
  return x.contiguous().view(torch.int64 if x.dtype == torch.float64
                             else torch.int32)


def compare_other(other: str) -> int:
  """This checkout's window kernel against the other checkout's: bits on
  every batch, ptxas counts, times in turns."""
  import torch
  import chip_smoke as smoke
  from vision4leg_torch.ops import physics_kernel as pk
  dev = torch.device("cuda")
  print(smoke.card_name(), flush=True)
  srcs = {}
  with open(pk.SOURCE) as f:
    srcs["this"] = f.read()
  with open(os.path.join(other, "vision4leg_torch", "ops", "csrc",
                         "physics_window.cu")) as f:
    srcs["other"] = f.read()
  cases = window_cases(dev)
  same_all = True
  with tempfile.TemporaryDirectory() as tmp:
    fns = {}
    for name, src in srcs.items():
      d = pathlib.Path(tmp, name)
      d.mkdir()
      fns[name], counts = nvcc_build(src, d)
      print(f"{name} ({ROOT if name == 'this' else other}): ptxas "
            f"{json.dumps(counts)}", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    launch = {k: (lambda f: lambda *a: f(*a, stream()))(f)
              for k, f in fns.items()}
    for cname, args in cases.items():
      for prec, a in (("float32", args),
                      ("float64", tuple(pk._double(x) for x in args))):
        outs = {k: pk._per_env(*pk._launch(*a, launch=launch[k]))
                for k in launch}
        diff = {}
        for field, x in outs["this"].items():
          y = outs["other"][field]
          n_diff = int((_bits(x) != _bits(y)).sum())
          if n_diff:
            diff[field] = dict(values=n_diff, max_abs=float(
                (x.double() - y.double()).abs().max()))
        same_all &= not diff
        print(f"[{cname}, {args[2].shape[0]} envs x {args[8]} substeps, "
              f"{prec}] this vs other: "
              + ("same bits in every output" if not diff
                 else f"outputs differ: {json.dumps(diff)}"), flush=True)
    for cname in ("rollout", "hybrid"):
      for n_env in (smoke.NUM_ENVS, 8):
        args = smoke.take_envs(cases[cname], n_env)
        kern, wrap = [], []
        for k in ("other", "this", "this", "other"):
          kern.append(smoke.window_kernel_ms(args, fns[k]))
          wrap.append(smoke.time_ms(
              lambda: pk._launch(*args, launch=launch[k])))
        print(f"window [{cname}, {n_env} envs x {args[8]} substeps] in "
              f"turns other / this / this / other: kernel alone "
              + " / ".join(f"{t:.4f}" for t in kern) + " ms; wrapper call "
              + " / ".join(f"{t:.4f}" for t in wrap) + " ms", flush=True)
  print(f"this vs other: {'same bits everywhere' if same_all else 'DIFFER'}",
        flush=True)
  return 0 if same_all else 1


def time_flags(variants) -> None:
  """Time the window kernel built with the window's own flags and with
  each variant's in place of them, in turns (variant, own, own, variant),
  on the rollout and hybrid batches of `window_cases` (1024 envs; 16 and
  5 substeps): the kernel alone, `chip_smoke.window_kernel_ms`."""
  import torch
  import chip_smoke as smoke
  from vision4leg_torch.ops import nvcc
  from vision4leg_torch.ops import physics_kernel as pk
  cases = window_cases(torch.device("cuda"))
  with open(pk.SOURCE) as f:
    src = f.read()
  own = " ".join(nvcc.EXTRA_FLAGS["physics_window"])
  with tempfile.TemporaryDirectory() as tmp:
    fns = {}
    for flags in [own] + list(variants):
      d = pathlib.Path(tmp, str(len(fns)))
      d.mkdir()
      fns[flags], _ = nvcc_build(src, d, flags.split())
    for name in ("rollout", "hybrid"):
      args = cases[name]
      for variant in variants:
        ms = [smoke.window_kernel_ms(args, fns[flags])
              for flags in (variant, own, own, variant)]
        print(f"window [{name}, {args[2].shape[0]} envs x {args[8]} "
              f"substeps]: built with {variant}: {ms[0]:.4f} / {ms[3]:.4f} "
              f"ms; with {own}: {ms[1]:.4f} / {ms[2]:.4f} ms (kernel alone, "
              f"25 back-to-back launches each, in turns)", flush=True)


def _rel(a: str, b: str) -> float:
  try:
    x, y = float(a), float(b)
  except ValueError:
    return 0.0 if a == b else float("inf")
  return abs(x - y) / max(abs(x), abs(y), 1e-6)


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--root", default=ROOT)
  ap.add_argument("--n_sph", type=int, default=2)
  ap.add_argument("--other", help="root of the checkout to compare with")
  ap.add_argument("--locate", action="store_true")
  ap.add_argument("--variant", action="append", default=None)
  ap.add_argument("--trace_dir", help="with --locate: write both full "
                  "traces there")
  ap.add_argument("--time", action="store_true")
  ap.add_argument("--phases", action="store_true")
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
  if args.other:
    return compare_other(os.path.abspath(args.other))
  if args.time:
    time_flags(args.variant or ["-fmad=true"])
    return 0
  if args.phases:
    phase_clocks()
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
