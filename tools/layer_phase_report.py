"""Where the fused layer's forward kernel spends a tile, on the card.

    python3 tools/layer_phase_report.py [--batches 1024 8]
    python3 tools/layer_phase_report.py --other DIR [--batches 1024 8]

Builds a copy of `vision4leg_torch/ops/csrc/transformer_layer.cu` whose
`TL_PHASE` also records `clock64()` after each phase's barrier, for
thread 0 of block 0, and runs it at T = 17, D = 64, F = 256 on seeded
inputs, in the inference and the residual-saving mode.  Prints, per batch
and mode, the cycles of each phase of block 0's tile by name (load; q,
k, v, attention, Wo, LN1; per chunk of F its W1 and W2 products; LN2),
their total, and the kernel's time with CUDA events (50 launches after 3,
the library called through ctypes with the layer's pointers set once),
with the card's name and power limit.  The recording adds one global
store per phase to thread 0; the kernel's time is that of the
instrumented build.

`--other DIR` instead times the inference forward of this checkout's
kernel and of another checkout's (the parent commit, say, unpacked with
`git archive`), both built as they are, on the same inputs at each batch,
in turns (other, this, this, other), the kernel alone as above.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASE_MACRO = """#ifndef TL_PHASE
#define TL_PHASE(wait, call) \\
  do {                       \\
    call;                    \\
    tl_barrier(wait);        \\
  } while (0)
#endif"""
TIMED_MACRO = """__device__ long long tl_clk[64];
#define TL_PHASE(wait, call)                                   \\
  do {                                                         \\
    call;                                                      \\
    tl_barrier(wait);                                          \\
    if (threadIdx.x == 0 && blockIdx.x == 0 && tl_nph < 64)    \\
      tl_clk[tl_nph++] = clock64();                            \\
  } while (0)"""
TILE_HEAD = """                               float* smem, int tile, int warp, int lane) {
"""
TIMED_HEAD = TILE_HEAD + """  int tl_nph = 0;
  if (threadIdx.x == 0 && blockIdx.x == 0) tl_clk[tl_nph++] = clock64();
"""
GET_CLK = """
extern "C" int tl_get_clk(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, tl_clk, sizeof(long long) * 64);
}
"""


def timed_source(src: str) -> str:
  for old, new in ((PHASE_MACRO, TIMED_MACRO), (TILE_HEAD, TIMED_HEAD)):
    if src.count(old) != 1:
      raise RuntimeError(f"layer_phase_report: the source changed near "
                         f"{old.splitlines()[0]!r}")
    src = src.replace(old, new)
  return src + GET_CLK


def phase_names(D: int, F: int) -> list:
  """The phases of a tile in `tl_tile`'s order."""
  nd, nf = (D + 63) // 64, (F + 63) // 64
  names = ["load"] + [f"{w}{i}" for w in "qkv" for i in range(nd)]
  names += ["attention"] + [f"Wo{i}" for i in range(nd)] + ["LN1"]
  for c in range(nf):
    names += [f"W1 chunk {c}", f"W2 chunk {c}"]
  return names + ["LN2"]


def build(src: str, tmp: str, name: str):
  """The layer's library built from source text `src`, its launch typed."""
  from vision4leg_torch.ops import nvcc
  cu, so = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
  with open(cu, "w") as f:
    f.write(src)
  subprocess.run([nvcc._nvcc(), *nvcc.flags("transformer_layer"), "-o", so,
                  cu], check=True, capture_output=True)
  lib = ctypes.CDLL(so)
  lib.transformer_layer_launch.argtypes = [ctypes.c_void_p] * 18 + [
      ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
  lib.transformer_layer_launch.restype = ctypes.c_int
  return lib


def kernel_ms(launch, n=50, warm=3) -> float:
  """Milliseconds per call of `launch()` (a kernel launch), CUDA events
  around n launches issued back to back after `warm`."""
  import torch
  for _ in range(warm):
    if launch() != 0:
      raise RuntimeError("layer_phase_report: launch failed")
  torch.cuda.synchronize()
  s, e = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
  s.record()
  for _ in range(n):
    launch()
  e.record()
  e.synchronize()
  return s.elapsed_time(e) / n


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--batches", type=int, nargs="+", default=[1024, 8])
  ap.add_argument("--other", help="root of another checkout to time")
  args = ap.parse_args()
  import torch
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import nvcc
  if not torch.cuda.is_available():
    print("layer_phase_report: no CUDA device", file=sys.stderr)
    return 2
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  with open(nvcc.SOURCES["transformer_layer"]) as f:
    src = f.read()
  with tempfile.TemporaryDirectory() as tmp:
    if args.other:
      with open(os.path.join(args.other, "vision4leg_torch", "ops", "csrc",
                             "transformer_layer.cu")) as f:
        libs = {"other": build(f.read(), tmp, "other"),
                "this": build(src, tmp, "this")}
    else:
      lib = build(timed_source(src), tmp, "timed")
  dev = torch.device("cuda")
  T, D, F = 17, 64, 256
  gen = torch.Generator(device=dev).manual_seed(0)
  w = [0.1 * torch.randn(*s, generator=gen, device=dev) for s in
       [(D, D), (D,)] * 4 + [(D,), (D,), (D, F), (F,), (F, D), (D,), (D,),
                             (D,)]]
  print(card, flush=True)
  if args.other:
    for B in args.batches:
      x = torch.randn(B, T, D, generator=gen, device=dev)
      out = torch.empty_like(x)
      ptrs = [x.data_ptr(), out.data_ptr()] + [t.data_ptr() for t in w]
      stream = torch.cuda.current_stream().cuda_stream
      times = [(k, kernel_ms(lambda: libs[k].transformer_layer_launch(
          *ptrs, B, T, D, F, None, stream)))
               for k in ("other", "this", "this", "other")]
      print(f"inference forward at B={B} T={T} D={D} F={F} on {card}, "
            f"kernel alone, ms (other = {args.other}): " + ", ".join(
                f"{k} {ms:.4f}" for k, ms in times), flush=True)
    return 0
  launch = lib.transformer_layer_launch
  lib.tl_get_clk.argtypes = [ctypes.c_void_p]
  names = phase_names(D, F)
  clk = (ctypes.c_longlong * 64)()
  for B in args.batches:
    x = torch.randn(B, T, D, generator=gen, device=dev)
    out = torch.empty_like(x)
    res = torch.empty(sum(int(torch.tensor(s).prod()) for s in
                          att.residual_shapes(B, T, D, F)), device=dev)
    for save in (False, True):
      ptrs = [x.data_ptr(), out.data_ptr()] + [t.data_ptr() for t in w]
      rp = res.data_ptr() if save else None
      stream = torch.cuda.current_stream().cuda_stream
      ms = kernel_ms(lambda: launch(*ptrs, B, T, D, F, rp, stream))
      if lib.tl_get_clk(clk) != 0:
        raise RuntimeError("layer_phase_report: reading the clocks failed")
      cycles = [clk[i + 1] - clk[i] for i in range(len(names))]
      print(f"B={B} T={T} D={D} F={F} {'saving' if save else 'inference'}"
            f" on {card}: {ms:.4f} ms a launch; block "
            f"0's tile {sum(cycles)} cycles: " + ", ".join(
                f"{n} {c}" for n, c in zip(names, cycles)), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
