"""The layer kernels' end-to-end gradient gate over several seeds, on the
card: `attention.compare_grads_with_plain` on x, g ~ N(0, 1) of (B, T, 64)
and the card test's random weights (F 256), one seed each.

  python3 tools/layer_gate_seeds.py [--B 1024] [--T 33] [--seeds 8]

Prints a line a seed (the gate's verdict; its verdict without the ReLU
mask rule, i.e. whether any element failed before that rule; the kernel's
mask flips against the float64 plain layer, those within float32's reach
of zero, the reach; the elements excused by the rule) and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def weights(D, F, dev, seed):
  """The random LayerWeights of tests/test_torch_attention_cuda.py."""
  import torch
  from vision4leg_torch.ops import attention as att
  rng = np.random.default_rng(seed)
  out = []
  for name in att.LayerWeights._fields:
    shape = dict(wq=(D, D), wk=(D, D), wv=(D, D), wo=(D, D), w1=(D, F),
                 w2=(F, D), b1=(F,)).get(name, (D,))
    if len(shape) == 2:
      x = rng.normal(0, 1 / np.sqrt(shape[0]), shape)
    elif "scale" in name:
      x = 1 + 0.1 * rng.normal(size=shape)
    else:
      x = 0.1 * rng.normal(size=shape)
    out.append(torch.tensor(x, dtype=torch.float32, device=dev))
  return att.LayerWeights(*out)


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--B", type=int, default=1024)
  p.add_argument("--T", type=int, default=33)
  p.add_argument("--seeds", type=int, default=8)
  p.add_argument("--device", default="cuda",
                 help="cpu runs the plain path (a rehearsal)")
  args = p.parse_args(argv)
  import torch
  from vision4leg_torch import resolve_device
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import nvcc
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = resolve_device(args.device)
  card = "cpu"
  if dev.type == "cuda":
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc.build(["transformer_layer"])
    att.build_library()
  print(card, flush=True)
  rows = []
  for seed in range(args.seeds):
    w = weights(64, 256, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(args.B, args.T, 64, device=dev, generator=gen)
    g = torch.randn(args.B, args.T, 64, device=dev, generator=gen)
    relu = {}
    ok, rep = att.compare_grads_with_plain(x, w, g, relu=relu)
    failed = sum(r["failed"] for r in rep.values())
    mask_excused = sum(r["mask_excused"] for r in rep.values())
    row = dict(seed=seed, ok=ok, ok_without_mask_rule=failed
               + mask_excused == 0, failed=failed, mask_excused=mask_excused,
               excused=sum(r["excused"] for r in rep.values()), **relu)
    rows.append(row)
    print(json.dumps(row), flush=True)
  print(json.dumps(dict(card=card, B=args.B, T=args.T, seeds=args.seeds,
                        passed=sum(r["ok"] for r in rows),
                        passed_without_mask_rule=sum(
                            r["ok_without_mask_rule"] for r in rows))),
        flush=True)
  return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
  sys.exit(main())
