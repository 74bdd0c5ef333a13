"""Data parallelism over the env axis (torch counterpart of
vision4leg_tpu.parallel.mesh).

The reference's only parallel axis is environments (SURVEY 2.6).  The
JAX package shards that axis over a `jax.sharding.Mesh` and lets GSPMD
insert the all-reduces; the port runs one process per rank under
`torch.distributed` and makes each reduction itself, so that a sharded
epoch computes what the unsharded one does:

  * rank r steps envs [r E/W, (r + 1) E/W) of the E envs (`env_slice`);
  * every draw is the global draw's rows for the rank's envs: all ranks
    hold the same generators and draw at the global batch (`take_rows`);
  * the parameters, optimizer states, normalizer and generators are
    replicated; gradients are all-reduced to their global mean before the
    optimizer, so every rank takes the same step (`check_replicated`
    holds them to the same bits);
  * batch statistics (the normalizer's moments, the advantages') are
    merged from every rank's in float64, in rank order.

The backend is NCCL for CUDA tensors and gloo for CPU ones; gloo may also
serve ranks whose tensors live on one card (each collective then goes
through host memory).  A `Mesh` of world 1 (`ONE`, the default of every
function that takes one) makes no collective: each helper is then the
identity, and the unsharded run goes through the same code.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import pickle
import queue as queue_lib
import socket
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# the collector fields whose leading axis is the env axis (the JAX rule:
# leaves with a leading env axis shard, the rest replicate)
ENV_FIELDS = ("cs.env_states.", "cs.raw_obs", "cs.ep_steps", "cs.ep_return")
# the collector's episode sums: each rank holds its envs' part
SUM_FIELDS = ("cs.finished_returns_sum", "cs.finished_count",
              "cs.finished_len_sum")


@dataclasses.dataclass(frozen=True)
class Mesh:
  """This process's place among `world` ranks, and its device (None: the
  caller's)."""
  world: int = 1
  rank: int = 0
  device: Optional[torch.device] = None
  backend: str = "none"

  @property
  def sharded(self) -> bool:
    return self.world > 1

  def local_envs(self, num_envs: int) -> int:
    if num_envs % self.world:
      raise ValueError(f"num_envs={num_envs} does not divide over "
                       f"{self.world} ranks")
    return num_envs // self.world

  def env_slice(self, num_envs: int) -> slice:
    n = self.local_envs(num_envs)
    return slice(self.rank * n, (self.rank + 1) * n)

  def own_rows(self, draw: Callable, n: int):
    """This rank's n rows of draw(n * world): the global draw of n rows a
    rank, cut by `take_rows`."""
    total = n * self.world
    return take_rows(draw(total), self.rank * n, n, total)

  # -- collectives (identities at world 1) --------------------------------
  def _run(self, t: torch.Tensor, fn) -> torch.Tensor:
    """fn(tensor on the backend's device) -> result on t's device."""
    if self.backend == "gloo" and t.device.type == "cuda":
      return fn(t.cpu()).to(t.device)
    return fn(t)

  def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                 ) -> torch.Tensor:
    """The reduction of t over the ranks (a new tensor)."""
    if not self.sharded:
      return t

    def go(x):
      x = x.clone()
      dist.all_reduce(x, op=op)
      return x
    return self._run(t, go)

  def all_gather(self, t: torch.Tensor) -> torch.Tensor:
    """(world,) + t.shape: every rank's t in rank order."""
    if not self.sharded:
      return t[None]

    def go(x):
      parts = [torch.empty_like(x) for _ in range(self.world)]
      dist.all_gather(parts, x.contiguous())
      return torch.stack(parts)
    if t.dtype == torch.bool:       # not every backend moves bools
      return self._run(t.to(torch.uint8), go).bool()
    return self._run(t, go)

  def mean_grads(self, grads):
    """Each gradient's mean over the ranks, in one all-reduce (None stays
    None: the loss does not reach that parameter on any rank)."""
    if not self.sharded:
      return grads
    live = [g for g in grads if g is not None]
    flat = self.all_reduce(torch.cat([g.reshape(-1) for g in live]))
    flat = flat / self.world
    out, i = [], 0
    for g in grads:
      if g is None:
        out.append(None)
        continue
      out.append(flat[i:i + g.numel()].view_as(g))
      i += g.numel()
    return out

  def moments(self, x: torch.Tensor, dim=0, correction=0):
    """(mean, variance with `correction`) over `dim` of the global batch
    whose rows are split over the ranks in equal parts: each rank's in x's
    dtype, merged in float64 in rank order (Chan et al.), cast back."""
    mean = torch.mean(x, dim=dim)
    if not self.sharded:
      return mean, torch.var(x, dim=dim, correction=correction)
    var = torch.var(x, dim=dim, correction=0)
    parts = self.all_gather(torch.stack([mean, var]).double())
    m = parts[:, 0].mean(dim=0)
    v = (parts[:, 1] + (parts[:, 0] - m) ** 2).mean(dim=0)
    n = x.shape[dim] * self.world
    return m.to(x.dtype), (v * (n / (n - correction))).to(x.dtype)

  def reduce_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Scalar metrics of equal-sized local batches made global: keys
    ending /max and /min by their extremum, counts (`nonfinite`,
    `_episodes`) by their sum, the rest (means) by their mean."""
    if not self.sharded:
      return metrics
    out = {}
    for k, v in metrics.items():
      if k.endswith("/max"):
        out[k] = self.all_reduce(v, dist.ReduceOp.MAX)
      elif k.endswith("/min"):
        out[k] = self.all_reduce(v, dist.ReduceOp.MIN)
      elif "nonfinite" in k or k.endswith("_episodes"):
        out[k] = self.all_reduce(v)
      else:
        out[k] = self.all_reduce(v) / self.world
    return out

  def check_replicated(self, module: torch.nn.Module, what: str = ""):
    """Raise unless every rank holds the same bits of every parameter."""
    if not self.sharded:
      return
    flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    parts = self.all_gather(flat)
    for r in range(1, self.world):
      if not torch.equal(parts[r], parts[0]):
        diff = float((parts[r] - parts[0]).abs().max())
        raise RuntimeError(f"rank {r}'s parameters part from rank 0's "
                           f"{what}(max |diff| {diff:.3e})")


ONE = Mesh()


def take_rows(tree, start: int, n: int, total: Optional[int] = None):
  """`tree` (tensors, NamedTuples, tuples, dataclasses, None) with every
  tensor cut to rows [start, start + n) of its leading axis, which must
  be `total` long where given."""
  if tree is None:
    return None
  if isinstance(tree, torch.Tensor):
    if total is not None and tree.shape[0] != total:
      raise ValueError(f"take_rows: a draw of {tree.shape[0]} rows, "
                       f"expected {total}")
    return tree[start:start + n]
  if dataclasses.is_dataclass(tree):
    return dataclasses.replace(tree, **{
        f.name: take_rows(getattr(tree, f.name), start, n, total)
        for f in dataclasses.fields(tree)})
  if isinstance(tree, tuple):
    parts = [take_rows(x, start, n, total) for x in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
  raise TypeError(f"take_rows: cannot cut a {type(tree)}")


def is_env_field(path: str) -> bool:
  return path.startswith(ENV_FIELDS)


def shard_collector_state(mesh: Mesh, flat: Dict[str, torch.Tensor],
                          num_envs: int) -> Dict[str, torch.Tensor]:
  """This rank's part of a flattened global collector state (a
  checkpoint's): the env fields cut to its envs, the episode sums kept by
  rank 0 alone, the rest (normalizer) replicated."""
  sl = mesh.env_slice(num_envs)
  out = {}
  for k, v in flat.items():
    if is_env_field(k):
      if v.shape[0] != num_envs:
        raise ValueError(f"checkpoint: {k} has {v.shape[0]} envs, the run "
                         f"{num_envs}")
      v = v[sl]
    elif k in SUM_FIELDS and mesh.rank:
      v = torch.zeros_like(v)
    out[k] = v
  return out


def gather_collector_state(mesh: Mesh, flat: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
  """The flattened global collector state from every rank's part, on
  every rank: env fields concatenated in rank order, the episode sums
  summed, the rest as this rank holds it."""
  out = {}
  for k, v in flat.items():
    if is_env_field(k):
      out[k] = mesh.all_gather(v).flatten(0, 1)
    elif k in SUM_FIELDS:
      out[k] = mesh.all_reduce(v)
    else:
      out[k] = v
  return out


def free_port() -> int:
  """A TCP port of localhost that no one listens on now."""
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def canonical_device(device) -> torch.device:
  """`device` with its index: "cuda" is the current card."""
  device = torch.device(device)
  if device.type == "cuda" and device.index is None:
    return torch.device("cuda", torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)
  return device


def init_rank(rank: int, world: int, port: int, backend: str,
              device=None, timeout_s: float = 300.0) -> Mesh:
  """Join the process group of `world` ranks at tcp://localhost:port and
  return this rank's Mesh (the counterpart of JAX `make_mesh`).  The
  rendezvous and every collective give up after `timeout_s` seconds, so
  that a lost rank fails the others rather than hanging them."""
  dist.init_process_group(
      backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
      rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
  if device is None:
    device = (torch.device("cuda", rank) if backend == "nccl"
              else torch.device("cpu"))
  device = canonical_device(device)
  if device.type == "cuda":
    torch.cuda.set_device(device)
  return Mesh(world=world, rank=rank, device=device, backend=backend)


def shutdown():
  if dist.is_available() and dist.is_initialized():
    dist.destroy_process_group()


def _rank_entry(rank, world, port, backend, device, timeout_s, threads, fn,
                args, results):
  try:
    if threads is not None:
      torch.set_num_threads(threads)
    mesh = init_rank(rank, world, port, backend, device, timeout_s)
    try:
      # pickled here, by value: the queue's own pickler would send tensors
      # as handles to this process's shared memory, gone when it exits
      results.put((rank, True, pickle.dumps(fn(mesh, *args))))
    finally:
      shutdown()
  except BaseException:
    results.put((rank, False, traceback.format_exc()))
    raise


@dataclasses.dataclass
class Ranks:
  """Rank processes started by `start_ranks`, joined by `join_ranks`."""
  procs: list
  results: object
  timeout_s: Optional[float]
  started: float


def start_ranks(fn: Callable, world: int, args: Sequence = (),
                backend: str = "gloo", device=None,
                timeout_s: Optional[float] = 600.0,
                threads: Optional[int] = None) -> Ranks:
  """fn(mesh, *args) in `world` spawned processes, one a rank, joined at
  a free port of localhost.  `fn` and `args` are pickled (fn by import
  path), and so is each result.  `device`: every rank's device, or None
  for cuda:rank under NCCL and the CPU under gloo."""
  ctx = multiprocessing.get_context("spawn")
  results = ctx.Queue()
  port = free_port()
  procs = [ctx.Process(target=_rank_entry, args=(
      r, world, port, backend, device,
      1800.0 if timeout_s is None else timeout_s, threads, fn,
      tuple(args), results), daemon=True) for r in range(world)]
  for p in procs:
    p.start()
  return Ranks(procs, results, timeout_s, time.time())


def join_ranks(ranks: Ranks) -> List:
  """The ranks' results in rank order.  A rank that raises, or ranks that
  outlast their timeout_s seconds from the start (None: no limit), stop
  every rank, and this raises."""
  procs, world = ranks.procs, len(ranks.procs)
  deadline = (None if ranks.timeout_s is None
              else ranks.started + ranks.timeout_s)
  out, failed = {}, []
  try:
    while len(out) < world and not failed:
      try:
        rank, ok, value = ranks.results.get(timeout=1.0)
      except queue_lib.Empty:
        dead = [r for r in range(world) if r not in out
                and not procs[r].is_alive() and procs[r].exitcode]
        if dead:
          failed.append(f"rank(s) {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]}, no result")
        elif deadline is not None and time.time() >= deadline:
          failed.append(f"ranks did not finish in {ranks.timeout_s} s")
        continue
      if ok:
        out[rank] = pickle.loads(value)
      else:
        failed.append(f"rank {rank}:\n{value}")
  finally:
    for p in procs:
      p.join(timeout=0 if failed else 30)
      if p.is_alive():
        p.kill()
        p.join(timeout=10)
  if failed:
    raise RuntimeError("run_ranks: " + "\n".join(failed))
  return [out[r] for r in range(world)]


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              backend: str = "gloo", device=None,
              timeout_s: Optional[float] = 600.0,
              threads: Optional[int] = None) -> List:
  """`start_ranks` then `join_ranks`: the ranks' results in rank
  order."""
  return join_ranks(start_ranks(fn, world, args, backend, device,
                                timeout_s, threads))
