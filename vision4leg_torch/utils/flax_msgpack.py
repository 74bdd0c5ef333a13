"""Reader of the JAX package's flax msgpack snapshots (`model_pf_*.flax`,
written by `flax.serialization.to_bytes`) that needs neither JAX, flax nor
the msgpack package, and the loader of a JAX run directory's policy into
this package.

The format is msgpack of a tree of dicts whose leaves carry ext types
(flax/serialization.py `_msgpack_ext_pack`): type 1 an ndarray, type 3 a
numpy scalar, each the msgpack of (shape, dtype name, C-order buffer);
type 2 a Python complex.  Arrays past 2**30 bytes are written as
`{"__msgpack_chunked_array__": True, ...}` dicts.  No policy of this repo
has either of the last two, and the reader raises on both rather than
guess.  `unpack` decodes the msgpack itself (every type of the msgpack
specification but timestamps, which flax does not write), so that the
reader runs where the msgpack package is not installed.
"""
from __future__ import annotations

import os.path as osp
import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from vision4leg_torch import convert
from vision4leg_torch.data.normalizer import NormalizerState

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width types: first byte -> (struct format, bytes)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1),
          0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4),
          0xd3: (">q", 8)}
# first byte -> length bytes of str (s), bin (b), array (a), map (m), ext (e)
_SIZED = {0xd9: ("s", 1), 0xda: ("s", 2), 0xdb: ("s", 4),
          0xc4: ("b", 1), 0xc5: ("b", 2), 0xc6: ("b", 4),
          0xdc: ("a", 2), 0xdd: ("a", 4), 0xde: ("m", 2), 0xdf: ("m", 4),
          0xc7: ("e", 1), 0xc8: ("e", 2), 0xc9: ("e", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def unpack(data: bytes, ext_hook: Callable[[int, bytes], Any],
           raw: bool = False):
  """The object of one msgpack message; ext types through
  ext_hook(code, payload); strings as bytes when `raw`, else str.  Raises
  on a malformed or truncated message or trailing bytes."""
  mv = memoryview(data)
  pos = 0

  def take(n):
    nonlocal pos
    if pos + n > len(mv):
      raise ValueError("msgpack: truncated message")
    pos += n
    return mv[pos - n:pos]

  def length(n):
    return int.from_bytes(take(n), "big")

  def obj():
    b = take(1)[0]
    if b <= 0x7f:
      return b
    if b >= 0xe0:
      return b - 0x100
    if 0x80 <= b <= 0x8f:
      return {obj(): obj() for _ in range(b & 0x0f)}
    if 0x90 <= b <= 0x9f:
      return [obj() for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
      s = bytes(take(b & 0x1f))
      return s if raw else s.decode()
    if b == 0xc0:
      return None
    if b in (0xc2, 0xc3):
      return b == 0xc3
    if b in _FIXED:
      fmt, n = _FIXED[b]
      return struct.unpack(fmt, take(n))[0]
    if b in _FIXEXT:
      code = struct.unpack(">b", take(1))[0]
      return ext_hook(code, bytes(take(_FIXEXT[b])))
    if b in _SIZED:
      kind, nb = _SIZED[b]
      n = length(nb)
      if kind == "s":
        s = bytes(take(n))
        return s if raw else s.decode()
      if kind == "b":
        return bytes(take(n))
      if kind == "a":
        return [obj() for _ in range(n)]
      if kind == "m":
        return {obj(): obj() for _ in range(n)}
      code = struct.unpack(">b", take(1))[0]
      return ext_hook(code, bytes(take(n)))
    raise ValueError(f"msgpack: unknown first byte 0x{b:02x}")

  out = obj()
  if pos != len(mv):
    raise ValueError(f"msgpack: {len(mv) - pos} trailing bytes")
  return out


def _array(data: bytes) -> np.ndarray:
  """An ndarray from flax's (shape, dtype name, buffer) encoding, copied
  out of the snapshot's bytes (writable, C order)."""
  shape, dtype_name, buffer = unpack(data, _no_ext, raw=True)
  name = dtype_name.decode()
  if name == "bfloat16":
    raise ValueError("flax snapshot: a bfloat16 array; numpy has no such "
                     "dtype and this reader does not convert it")
  return np.frombuffer(buffer, dtype=np.dtype(name)).copy().reshape(shape)


def _no_ext(code: int, data: bytes):
  raise ValueError(f"flax snapshot: ext type {code} inside an array")


def _ext_hook(code: int, data: bytes):
  if code == EXT_NDARRAY:
    return _array(data)
  if code == EXT_NPSCALAR:
    return _array(data)[()]
  if code == EXT_COMPLEX:
    raise ValueError("flax snapshot: a complex scalar (ext type 2); no "
                     "policy parameter is complex")
  raise ValueError(f"flax snapshot: unknown msgpack ext type {code}")


def _check_no_chunks(tree, path="") -> None:
  if isinstance(tree, dict):
    if CHUNKED in tree:
      raise ValueError(f"flax snapshot: {path or 'the root'} is a chunked "
                       "array (> 2**30 bytes); this reader does not join "
                       "chunks")
    for k, v in tree.items():
      _check_no_chunks(v, f"{path}/{k}")


def read_flax_bytes(raw: bytes) -> Dict[str, Any]:
  """The tree of a flax msgpack snapshot's bytes: nested dicts of
  np.ndarray (and numpy scalars), as `flax.serialization.msgpack_restore`
  gives them."""
  tree = unpack(raw, _ext_hook)
  _check_no_chunks(tree)
  return tree


def read_flax_snapshot(path: str) -> Dict[str, Any]:
  """`read_flax_bytes` of the file at `path`."""
  with open(path, "rb") as f:
    return read_flax_bytes(f.read())


def read_normalizer(path: str, device="cpu") -> NormalizerState:
  """The obs normalizer of a snapshot (`_obs_normalizer_*.npz`: mean, var,
  count, float32) on `device`."""
  d = np.load(path)
  t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                device=device)
  return NormalizerState(mean=t(d["mean"]), var=t(d["var"]),
                         count=t(d["count"]))


def load_jax_run(work_dir: str, snap: str = "best", device="cpu"
                 ) -> Tuple[Dict[str, torch.Tensor], NormalizerState]:
  """(state_dict, NormalizerState) of a JAX run directory's snapshot
  `snap`: `model/model_pf_{snap}.flax` through `convert.params_from_flax`
  (which raises on a layout it does not know) and
  `model/_obs_normalizer_{snap}.npz`.  The state_dict is on the CPU; the
  normalizer on `device`."""
  model_dir = osp.join(work_dir, "model")
  tree = read_flax_snapshot(osp.join(model_dir, f"model_pf_{snap}.flax"))
  sd = convert.params_from_flax(tree)
  nstate = read_normalizer(
      osp.join(model_dir, f"_obs_normalizer_{snap}.npz"), device)
  return sd, nstate
