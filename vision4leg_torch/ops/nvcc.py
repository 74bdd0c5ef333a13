"""Build of the port's CUDA sources: one nvcc per `.cu` file into a shared
library with a plain C interface (loaded with ctypes), cached in
`vision4leg_torch/_build/` by a hash of the source and the flags.

`build(names)` starts the nvcc of every source that is not cached yet at
once and waits for all of them; `load(name)` builds one source if needed
and loads it.  Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {
    "physics_window": os.path.join(_HERE, "csrc", "physics_window.cu"),
    "transformer_layer": os.path.join(_HERE, "csrc", "transformer_layer.cu"),
}
# flags of one source beyond NVCC_FLAGS.  The window rounds every product
# and sum on its own, as its plain version does: a multiply-add that nvcc
# contracts into one FMA moves a contact sphere's height by a few units
# in the last place, enough to flip the sign of a penetration of 1e-8 m,
# and with it a penalty force of tens of newtons (csrc header).
EXTRA_FLAGS = {"physics_window": ("-fmad=false",)}

# per source: seconds, cached, path, ptxas log of the last build/load
INFO: Dict[str, dict] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  path = os.path.join(cuda_home, "bin", "nvcc")
  found = path if os.path.exists(path) else shutil.which("nvcc")
  if found is None:
    raise RuntimeError("nvcc not found (set CUDA_HOME)")
  return found


def flags(name: str) -> tuple:
  """nvcc's flags for one source."""
  return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def so_path(name: str) -> str:
  with open(SOURCES[name], "rb") as f:
    src = f.read()
  digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
  return os.path.join(BUILD_DIR, f"{name}_{digest[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, dict]:
  """Compile every named source that is not cached, all nvcc processes
  started together; returns INFO for those names.  Raises if any build
  fails (after all have ended)."""
  names = list(names)
  t0 = time.perf_counter()
  procs = {}
  for name in names:
    out = so_path(name)
    if os.path.exists(out):
      INFO[name] = dict(cached=True, seconds=0.0, path=out)
      continue
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(tmp + ".log", "w")
    procs[name] = (subprocess.Popen(
        [_nvcc(), *flags(name), "-o", tmp, SOURCES[name]], stdout=log,
        stderr=subprocess.STDOUT), log, tmp, out)
  failed = []
  while procs:
    for name in [n for n, p in procs.items() if p[0].poll() is not None]:
      proc, log, tmp, out = procs.pop(name)
      log.close()
      if proc.returncode != 0:
        with open(tmp + ".log") as f:
          failed.append(f"{name}: nvcc exit {proc.returncode}\n{f.read()}")
        continue
      os.replace(tmp + ".log", out + ".log")
      os.replace(tmp, out)
      INFO[name] = dict(cached=False, seconds=time.perf_counter() - t0,
                        path=out)
    time.sleep(0.05)
  if failed:
    raise RuntimeError("\n".join(failed))
  for name in names:
    with open(INFO[name]["path"] + ".log") as f:
      INFO[name]["log"] = f.read()
  return {n: INFO[n] for n in names}


def load(name: str) -> ctypes.CDLL:
  """The built library of one source (built first if needed)."""
  path = so_path(name)
  if path not in _LOADED:
    if name not in INFO or INFO[name]["path"] != path:
      build([name])
    _LOADED[path] = ctypes.CDLL(path)
  return _LOADED[path]


def sass_counts(name: str, pattern: str) -> Dict[str, int]:
  """Lines of each kernel's SASS in the built library of one source that
  contain `pattern` (e.g. "HMMA": tensor-core instructions), by mangled
  kernel name, from `cuobjdump --dump-sass` of the toolkit nvcc is in."""
  cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
  sass = subprocess.run([cuobjdump, "--dump-sass", INFO[name]["path"]],
                        capture_output=True, text=True, check=True).stdout
  return {chunk.split()[0]: sum(pattern in line
                                for line in chunk.splitlines())
          for chunk in sass.split("Function : ")[1:]}


def ptxas_counts(log: str) -> Dict[str, dict]:
  """Registers, stack frame, spills and shared memory of each entry
  function (by its mangled name) from `ptxas -v`'s log."""
  out = {}
  for chunk in log.split("Compiling entry function")[1:]:
    num = lambda pat: int(m.group(1)) if (m := re.search(pat, chunk)) \
        else None
    out[chunk.split("'")[1]] = dict(
        registers=num(r"Used (\d+) registers"),
        stack_frame_bytes=num(r"(\d+) bytes stack frame"),
        spill_store_bytes=num(r"(\d+) bytes spill stores"),
        spill_load_bytes=num(r"(\d+) bytes spill loads"))
  return out
