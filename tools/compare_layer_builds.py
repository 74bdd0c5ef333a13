"""The fused layer of this checkout against that of another checkout (the
parent commit, say, unpacked with `git archive`), on the card.

    python3 tools/compare_layer_builds.py --other DIR

Runs each checkout's `fused_transformer_layer` (the inference forward)
and `fused_transformer_layer_ad` (forward + backward under autograd) in
its own process, in turns: other, this, this, other.  Each process builds
its checkout's kernels, runs the forward on the same seeded inputs
(B = 1024, 1000 and 8 at T = 17, D = 64, F = 256, and B = 5 at the
largest shape, T = 32, D = 128, F = 512) and times both functions at B =
1024 with CUDA events (25 calls issued back to back after 3).  Prints
whether the two checkouts' forwards give the same bits on every input,
and the times of each turn, with the card's name and power limit.

Each turn also profiles forward + backward at T = 17 and B = 1024 and 512
(torch.profiler, 20 calls after 3): the device time a call of the saving
forward kernel, the backward kernel, the weight products (GEMMs) and the
other small kernels (transposes, sums, copies) takes on the device
timeline, their sum against the call's time with CUDA events (the card's
busy share), and the host's time to issue a call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1024, 17, 64, 256), (1000, 17, 64, 256), (8, 17, 64, 256),
          (5, 32, 128, 512))
PROFILE_BATCHES = (1024, 512)


def _inputs(B, T, D, F, dev):
  import torch
  gen = torch.Generator(device=dev).manual_seed(B * 7 + T)
  r = lambda *shape, s=1.0: s * torch.randn(*shape, generator=gen,
                                            device=dev)
  w = [r(D, D, s=D ** -0.5), r(D, s=0.1), r(D, D, s=D ** -0.5), r(D, s=0.1),
       r(D, D, s=D ** -0.5), r(D, s=0.1), r(D, D, s=D ** -0.5), r(D, s=0.1),
       1 + r(D, s=0.1), r(D, s=0.1), r(D, F, s=D ** -0.5), r(F, s=0.1),
       r(F, D, s=F ** -0.5), r(D, s=0.1), 1 + r(D, s=0.1), r(D, s=0.1)]
  return r(B, T, D), w


def dump(out_path: str) -> None:
  """Run this process's checkout (first on sys.path) and save its
  outputs and times to out_path."""
  import torch
  from vision4leg_torch.ops import attention as att
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device("cuda")

  def time_ms(fn, n=25, warm=3):
    for _ in range(warm):
      fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    for _ in range(n):
      fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n

  outs = {}
  for shape in SHAPES:
    x, w = _inputs(*shape, dev)
    with torch.no_grad():
      outs[str(shape)] = att.fused_transformer_layer(
          x, att.LayerWeights(*w)).cpu()
  x, w = _inputs(*SHAPES[0], dev)
  g = torch.randn(x.shape, generator=torch.Generator(device=dev)
                  .manual_seed(1), device=dev)
  xi = x.clone().requires_grad_(True)
  wi = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
  with torch.no_grad():
    fwd_ms = time_ms(lambda: att.fused_transformer_layer(x, wi))
  ad_ms = time_ms(lambda: torch.autograd.grad(
      att.fused_transformer_layer_ad(xi, wi), [xi, *wi], g))
  prof = {B: _profile_ad(att, B, dev, time_ms) for B in PROFILE_BATCHES}
  torch.save(dict(outs=outs, fwd_ms=fwd_ms, ad_ms=ad_ms, prof=prof),
             out_path)


def _kernel_group(name: str) -> str:
  if "transformer_layer_bwd" in name:
    return "backward kernel"
  if "transformer_layer" in name:
    return "saving forward kernel"
  if "gemm" in name.lower() or "cutlass" in name.lower():
    return "weight products (GEMM)"
  return "other kernels"


def _profile_ad(att, B, dev, time_ms, n=20, warm=3):
  """Device time per call of fused_transformer_layer_ad's forward +
  backward at (B, 17, 64), F 256, by kernel group; the call's time with
  CUDA events and the host's time to issue it."""
  import time

  import torch
  x, w = _inputs(B, 17, 64, 256, dev)
  g = torch.randn(x.shape, generator=torch.Generator(device=dev)
                  .manual_seed(2), device=dev)
  xi = x.clone().requires_grad_(True)
  wi = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
  call = lambda: torch.autograd.grad(att.fused_transformer_layer_ad(xi, wi),
                                     [xi, *wi], g)
  call_ms = time_ms(call, n=n, warm=warm)
  torch.cuda.synchronize()
  t = time.perf_counter()
  for _ in range(n):
    call()
  host_ms = (time.perf_counter() - t) / n * 1e3
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as p:
    for _ in range(n):
      call()
    torch.cuda.synchronize()
  groups = {}
  for e in p.key_averages():
    if e.device_type != torch.autograd.DeviceType.CUDA:
      continue
    k = _kernel_group(e.key)
    groups[k] = groups.get(k, 0.0) + e.device_time_total / 1e3 / n
  return dict(call_ms=call_ms, host_issue_ms=host_ms, device_ms=groups,
              busy=sum(groups.values()) / call_ms)


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--other", help="root of the other checkout")
  ap.add_argument("--dump", help=argparse.SUPPRESS)
  args = ap.parse_args()
  if args.dump:
    dump(args.dump)
    return 0
  import torch
  if not torch.cuda.is_available():
    print("compare_layer_builds: no CUDA device", file=sys.stderr)
    return 2
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  print(card, flush=True)
  other = os.path.abspath(args.other)
  runs = []
  with tempfile.TemporaryDirectory() as tmp:
    for i, root in enumerate((other, ROOT, ROOT, other)):
      path = os.path.join(tmp, f"{i}.pt")
      env = dict(os.environ, PYTHONPATH=root)
      subprocess.run([sys.executable, os.path.abspath(__file__), "--dump",
                      path], cwd=root, env=env, check=True)
      runs.append((root, torch.load(path)))
  same = {k: bool(torch.equal(runs[0][1]["outs"][k], runs[1][1]["outs"][k]))
          for k in runs[0][1]["outs"]}
  print(f"inference forward, {other} vs {ROOT}: same bits per (B, T, D, F) "
        f"{json.dumps(same)}", flush=True)
  for root, r in runs:
    print(f"{root}: fused_transformer_layer {r['fwd_ms']:.4f} ms, "
          f"fused_transformer_layer_ad forward + backward {r['ad_ms']:.4f} "
          f"ms at B=1024 T=17 D=64 F=256 on {card}", flush=True)
    for B, pr in r["prof"].items():
      parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(pr["device_ms"]
                                                           .items()))
      print(f"{root}: forward + backward at B={B} T=17: {pr['call_ms']:.4f} "
            f"ms a call (CUDA events), host issue {pr['host_issue_ms']:.4f} "
            f"ms, device timeline ms a call: {parts or 'no device events'}; "
            f"busy {pr['busy']:.3f} on {card}", flush=True)
  return 0 if all(same.values()) else 1


if __name__ == "__main__":
  sys.exit(main())
