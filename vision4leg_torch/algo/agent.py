"""Training agent: the epoch-driven train loop (torch mirror of
vision4leg_tpu.algo.agent).

Reference: torchrl/algo/rl_algo.py:97-168 (RLAlgo.train): per epoch —
collect -> update -> (interval) eval -> snapshot, tracking
Explore/Train/Eval wall-times, Running_Average_Rewards, and best-model
checkpointing.  The agent runs on the card unless `device="cpu"` is
passed (then every kernel's plain version runs).
"""
from __future__ import annotations

import copy
import dataclasses
import os
import os.path as osp
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from vision4leg_torch import convert, resolve_device
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner
from vision4leg_torch.algo.on_policy_base import AdamState
from vision4leg_torch.collector import rollout as rollout_lib
from vision4leg_torch.data import normalizer as norm
from vision4leg_torch.envs import wrappers
from vision4leg_torch.parallel import mesh as mesh_lib
from vision4leg_torch.utils import flax_msgpack, profiling


def _flatten(x, prefix: str, out: Dict[str, torch.Tensor]):
  """The tensors of a tree of dataclasses, keyed by their field path
  (generators are skipped: they are saved by their state)."""
  if isinstance(x, torch.Tensor):
    out[prefix] = x
  elif dataclasses.is_dataclass(x):
    for f in dataclasses.fields(x):
      _flatten(getattr(x, f.name), f"{prefix}.{f.name}", out)
  elif not isinstance(x, torch.Generator):
    raise TypeError(f"checkpoint: cannot save {prefix} of type {type(x)}")
  return out


def _unflatten(template, flat: Dict[str, torch.Tensor], prefix: str,
               grafted: List[str]):
  """`template` with every tensor replaced by flat[its path].  A path the
  checkpoint lacks (it predates the field) keeps the template's tensor
  and is appended to `grafted`, as the JAX agent grafts an old checkpoint
  onto its template (vision4leg_tpu/algo/agent.py:476-502); a path it has
  must match the template's shape and dtype."""
  if isinstance(template, torch.Tensor):
    if prefix not in flat:
      grafted.append(prefix)
      return template
    x = flat[prefix]
    if x.shape != template.shape or x.dtype != template.dtype:
      raise ValueError(f"checkpoint: {prefix} is {x.dtype}{tuple(x.shape)}, "
                       f"expected {template.dtype}{tuple(template.shape)}")
    return x.to(template.device)
  if dataclasses.is_dataclass(template):
    return dataclasses.replace(template, **{
        f.name: _unflatten(getattr(template, f.name), flat,
                           f"{prefix}.{f.name}", grafted)
        for f in dataclasses.fields(template)})
  return template


def capped_episodes(steps_in, terminals, max_ep: int) -> torch.Tensor:
  """(T,) the episodes of a rollout that ended at the episode cap at each
  step, the collector's time-limit truncation (`ep_steps >= max_ep`; a
  fall on that very step counts too): each env's step count is replayed
  from `steps_in` (E,) through `terminals` (T, E)."""
  steps = steps_in.clone()
  capped = []
  for term in terminals:
    steps = steps + 1
    capped.append(torch.sum(term & (steps >= max_ep)))
    steps = torch.where(term, 0, steps)
  return torch.stack(capped).float()


def _seeds(seed: int, n: int):
  """n independent seeds derived from one."""
  return [int(s) for s in
          np.random.SeedSequence(seed).generate_state(n, np.uint64) >> 1]


class PPOAgent:
  def __init__(self, env, ac_module, cfg: PPOConfig, num_envs: int,
               seed: int, logger, save_dir: str,
               eval_interval: int = 10, save_interval: int = 100,
               num_eval_envs: int = 2, obs_norm: bool = True,
               env_time_limit: int = 1000, reward_scale: float = 1.0,
               inference_dtype=None, mesh=None,
               fused_attention: Optional[bool] = None,
               fused_update: Optional[bool] = None,
               eval_env=None, eval_horizon: Optional[int] = None,
               device=None):
    """`ac_module` is an uninitialized actor-critic (its weights are
    drawn here from `seed`); it is moved to the agent's device.

    fused_attention runs the collection forward (`pi_v`) through the
    fused transformer layer; fused_update also the PPO update's `pi`/`v`,
    the bootstraps and eval.  fused_update defaults, as in the JAX agent,
    to fused_attention and V4L_FUSED_UPDATE set to a value other than 0.
    A module without `pi_v` (the Nature-CNN models) is collected with `pi`
    then `v`, as the JAX collector does; it has no fused layer, and asking
    for one raises where the JAX agent turns it off.

    inference_dtype (torch.bfloat16) runs the collection forward on a
    reduced-precision twin of the module (`collect_module`, its weights
    cast down once per rollout; collector/rollout.py).  That forward takes
    the unfused layer: the JAX layer routes a non-float32 input there even
    with fused=True (vision4leg_tpu/models/base.py:233-238); the update
    and eval stay float32 with their fused setting.
    eval_env evaluates on another env (sim-to-sim transfer, reference
    starter/ppo_nature_cnn_sim2sim.py:43-60) with the training
    collector's obs normalizer, the same object; eval_horizon defaults to
    max_episode_frames.  An env config with `curriculum` caps each epoch's
    episodes by the curriculum ramp (`_curriculum_episode_cap`).

    mesh (parallel.mesh.Mesh, on the agent's device) shards the env axis
    over ranks, one agent per rank, as the JAX agent does over a device
    mesh (vision4leg_tpu/algo/agent.py:141-145, 236-240): each steps its
    num_envs / world envs, draws the global draws' rows for them, and
    all-reduces gradients and batch statistics; parameters stay the same
    bits on every rank (checked after each epoch).  Every rank evaluates,
    as the replicated JAX eval does; rank 0 alone logs and writes
    snapshots, and checkpoints hold the global collector state (gathered
    from every rank), which a restore re-shards over its own ranks.
    """
    self.device = resolve_device(device)
    if mesh is None:
      mesh = mesh_lib.Mesh(device=self.device)
    elif (mesh_lib.canonical_device(mesh.device)
          != mesh_lib.canonical_device(self.device)):
      raise ValueError(f"PPOAgent: mesh on {mesh.device}, agent on "
                       f"{self.device}")
    self.mesh = mesh
    self.writer = mesh.rank == 0
    for e in (env, eval_env):
      if e is not None and e.device != self.device:
        raise ValueError(f"PPOAgent: env on {e.device}, agent on "
                         f"{self.device}")
    self.env = env
    self.eval_env = eval_env if eval_env is not None else env
    self.cfg = cfg
    self.num_envs = num_envs
    self.num_eval_envs = num_eval_envs
    self.logger = logger
    self.save_dir = save_dir
    self.eval_interval = eval_interval
    self.save_interval = save_interval
    # wall-clock floor between full resume checkpoints (see train());
    # V4L_CKPT_SECS<=0 (or a malformed value) disables the time trigger
    try:
      _ckpt_secs = float(os.environ.get("V4L_CKPT_SECS", "300"))
    except ValueError:
      _ckpt_secs = 300.0
    self.ckpt_secs = _ckpt_secs if _ckpt_secs > 0 else np.inf
    self.obs_norm = obs_norm
    os.makedirs(save_dir, exist_ok=True)

    s_init, s_coll, s_update, s_eval = _seeds(seed, 4)
    ac_module.init_weights(torch.Generator().manual_seed(s_init))
    self.module = ac_module.to(self.device)
    self.update_gen = torch.Generator(device=self.device).manual_seed(
        s_update)
    self.eval_gen = torch.Generator(device=self.device).manual_seed(s_eval)

    if fused_attention is None:
      fused_attention = False
    if fused_update is None:
      fused_update = (fused_attention and os.environ.get(
          "V4L_FUSED_UPDATE", "") not in ("", "0"))
    has_fused = hasattr(ac_module, "pi_v")
    if (fused_attention or fused_update) and not has_fused:
      raise NotImplementedError(
          f"fused_attention / fused_update: {type(ac_module).__name__} has "
          "no transformer layer to fuse (the JAX agent turns them off "
          "quietly; the port refuses)")
    self.fused_attention, self.fused_update = fused_attention, fused_update
    fused_kw = {"fused": fused_update} if has_fused else {}

    def apply_pi(m, x):
      return m.pi(x, **fused_kw)

    def apply_v(m, x):
      return m.v(x, **fused_kw)

    if inference_dtype == torch.float32:
      inference_dtype = None
    self.inference_dtype = inference_dtype
    # the collection forward's module and fused setting (routing by dtype,
    # decided here, before any launch)
    coll, fused_collect, coll_kw = self.module, fused_attention, fused_kw
    if inference_dtype is not None:
      coll = copy.deepcopy(self.module).to(inference_dtype)
      fused_collect, coll_kw = False, {k: False for k in fused_kw}
      if fused_attention or fused_update:
        self._log(
            f"{inference_dtype} collection: its forward runs the unfused "
            "transformer layer, as the JAX layer routes a non-float32 input "
            "(vision4leg_tpu/models/base.py:233-238); the update keeps the "
            "fused layer")
    self.collect_module = coll

    if has_fused:
      def apply_pi_v(x):
        return coll.pi_v(x, fused=fused_collect)
    else:
      def apply_pi_v(x):
        return coll.pi(x), coll.v(x)

    self.apply_pi = apply_pi
    self.learner = PPOLearner(cfg, apply_pi, apply_v, self.module,
                              self.mesh)
    self.train_state = self.learner.init_state(self.module)

    horizon = cfg.epoch_frames // num_envs
    self.horizon = horizon
    if horizon < 64:
      # PARITY.md horizon ablation: GAE(tau=0.95) truncated below T=64
      # routes nearly all credit through V-bootstraps; transient V-fit
      # error then poisons every advantage.
      warnings.warn(
          f"derived GAE horizon T = epoch_frames/num_envs = "
          f"{cfg.epoch_frames}/{num_envs} = {horizon} < 64: policy-level "
          f"oscillation is expected (see PARITY.md horizon ablation). "
          f"Use --num_envs <= {cfg.epoch_frames // 64} for T >= 64.",
          stacklevel=2)
    # CurriculumWrapperEnv (curriculum_wrapper_env.py:27-92): episode
    # length ramped 1000 -> 2000 on a cubic schedule, fed to the collector
    # as each epoch's episode cap (JAX agent.py:218-226)
    self.curriculum = bool(getattr(env.cfg, "curriculum", False))
    self._curric = (1000, 2000, 10_000_000)
    if self.curriculum:
      env_time_limit = max(env_time_limit, self._curric[1])
    self.rollout = rollout_lib.make_rollout_fn(
        env, apply_pi_v, lambda x: coll.v(x, **coll_kw), horizon,
        cfg.max_episode_frames, cfg.discount, env.cfg.proprio_dim,
        obs_norm=obs_norm, action_low=env.action_low,
        action_high=env.action_high, env_time_limit=env_time_limit,
        reward_scale=reward_scale, inference_dtype=inference_dtype,
        weights=(self.module, coll), mesh=self.mesh)
    self.collector_state = rollout_lib.init_collector(
        env, num_envs,
        torch.Generator(device=self.device).manual_seed(s_coll), self.mesh)
    self.eval_horizon = (eval_horizon if eval_horizon is not None
                         else cfg.max_episode_frames)
    self.best_eval = -np.inf
    self.total_frames = 0
    self.phase_seconds: Dict[str, float] = {}

  # ------------------------------------------------------------------
  def _sync(self, site: str):
    """Wait for the card; the wait is the host sync `v4l.sync.<site>`."""
    if self.device.type == "cuda":
      with profiling.span(f"v4l.sync.{site}"):
        torch.cuda.synchronize(self.device)

  def _log(self, msg: str):
    if not self.writer:
      return
    if self.logger is not None:
      self.logger.log(msg)
    else:
      print(msg, flush=True)

  @torch.no_grad()
  def evaluate(self):
    """Deterministic eval rollout (collector/base.py:235-288: action
    tanh(mean), frozen normalizer) of num_eval_envs fresh envs of the
    eval env over eval_horizon steps; returns (returns, steps) per env.
    The observations are normalized by the training collector's
    normalizer and the actions mapped into the training env's bounds, as
    the JAX agent does.  An env's rewards after its done are left out by
    selection, where the JAX agent multiplies them by 0: its return of an
    env whose physics diverges after the done (a fallen robot stepped on)
    is NaN, the port's the return up to the done.  Steps go through
    env.step_batch, which the JAX package declares semantically identical
    to its vmapped per-env step (envs/env.py:585-593); the port has no
    per-env step."""
    env = self.eval_env
    low, high = self.env.action_low, self.env.action_high
    nrm = self.collector_state.normalizer
    states, raw = env.reset(self.num_eval_envs, self.eval_gen)
    zeros = lambda: torch.zeros(self.num_eval_envs, device=self.device)
    ret, done_seen, steps = zeros(), zeros(), zeros()
    for _ in range(self.eval_horizon):
      obs = (norm.filt_with_img_tail(nrm, raw, env.cfg.proprio_dim)
             if self.obs_norm else raw)
      mean, _, _ = self.apply_pi(self.module, obs)
      env_act = low + (torch.tanh(mean) + 1.0) * 0.5 * (high - low)
      states, raw, rew, done, _ = env.step_batch(states, env_act,
                                                 self.eval_gen)
      # selected, not multiplied: an env stepped on after its done can
      # diverge to NaN, and 0 * NaN would end its return as NaN
      ret = ret + torch.where(done_seen > 0, 0.0, rew)
      steps = steps + (1.0 - done_seen)
      done_seen = torch.maximum(done_seen, done.float())
    return ret, steps

  @staticmethod
  def _epoch_metrics(traj, nrm):
    """Trajectory statistics, the non-finite guard and the obs-normalizer
    drift, as tensors (fetched with the other epoch scalars at once)."""
    return {
        "Training/avg_reward": traj.rewards.mean(),
        "diagnostics/nonfinite_obs": torch.sum(
            ~torch.isfinite(traj.obs)).float(),
        "diagnostics/nonfinite_reward": torch.sum(
            ~torch.isfinite(traj.rewards)).float(),
        "diagnostics/terminal_rate": traj.terminals.float().mean(),
        "diagnostics/obs_norm_mean_l2": torch.linalg.norm(nrm.mean),
        "diagnostics/obs_norm_var_max": (
            torch.max(nrm.var) if nrm.var.numel()
            else torch.zeros((), device=nrm.var.device)),
    }

  def _curriculum_episode_cap(self) -> Optional[int]:
    """This epoch's episode-length cap from the curriculum ramp, or None
    (JAX agent.py:515-534): each env counts its own steps, and the
    reference's env_builder.py:350-354 passes num_parallel_envs=8, which
    divides the ramp's length by 8."""
    if not self.curriculum:
      return None
    start, end, total = self._curric
    return int(wrappers.curriculum_episode_length(
        self.total_frames // self.num_envs, episode_length_start=start,
        episode_length_end=end, curriculum_steps=total,
        num_parallel_envs=8))

  def train_epoch(self, max_ep: Optional[int] = None):
    """Collect one epoch (episodes capped at max_ep, else
    max_episode_frames) and update on it; returns the metrics (tensors)
    and records the seconds of each phase in `phase_seconds`."""
    with profiling.span("v4l.epoch"):
      t0 = time.perf_counter()
      steps_in = self.collector_state.ep_steps
      with profiling.span("v4l.collect"):
        cs, traj, last_value = self.rollout(self.collector_state, max_ep)
      self._sync("collected")
      t1 = time.perf_counter()
      epoch_metrics = self._epoch_metrics(traj, cs.normalizer)
      epoch_metrics["diagnostics/capped_episodes"] = capped_episodes(
          steps_in, traj.terminals[..., 0],
          self.cfg.max_episode_frames if max_ep is None else max_ep).sum()
      metrics = self.mesh.reduce_metrics(epoch_metrics)
      with profiling.span("v4l.update"):
        ts, up_metrics = self.learner.update_per_epoch(
            self.train_state, traj, last_value, gen=self.update_gen)
        self.mesh.check_replicated(self.module, "after an epoch ")
      self._sync("updated")
      self.phase_seconds = {"Explore_Time": t1 - t0,
                            "Update_Time": time.perf_counter() - t1}
    metrics.update(up_metrics)
    self.train_state, self.collector_state = ts, cs
    return metrics

  # ------------------------------------------------------------------
  def save_checkpoint(self, epoch: int):
    """Full training checkpoint: params, both optimizer states, the
    collector (normalizer, env states, episode counters), every
    generator's state, epoch, best eval and total frames — a true resume
    point.  Written to `checkpoint_new`, then swapped in by two renames,
    so a crash at any time leaves a complete checkpoint behind.  Under a
    sharded mesh every rank must call it (the collector is gathered); rank
    0 writes."""
    path = osp.join(osp.abspath(self.save_dir), "checkpoint")
    ts, cs = self.train_state, self.collector_state
    collector = mesh_lib.gather_collector_state(
        self.mesh, _flatten(cs, "cs", {}))
    if self.writer:
      self._write_checkpoint(path, ts, collector, epoch)
    # under ranks, the checkpoint is whole once any rank returns
    self.mesh.all_reduce(torch.zeros(1, device=self.device))

  def _write_checkpoint(self, path, ts, collector, epoch: int):
    cs = self.collector_state
    opt = lambda s: dict(count=s.count, mu=s.mu, nu=s.nu)
    ckpt = {"module": self.module.state_dict(),
            "pf_opt": opt(ts.pf_opt), "vf_opt": opt(ts.vf_opt),
            "train_epoch": ts.epoch,
            "collector": collector,
            "generators": {"collect": cs.gen.get_state(),
                           "update": self.update_gen.get_state(),
                           "eval": self.eval_gen.get_state()},
            "epoch": epoch, "best_eval": float(self.best_eval),
            "total_frames": self.total_frames}
    new, old = path + "_new", path + "_old"
    for stale in (new, old):
      if osp.exists(stale):
        os.remove(stale)
    torch.save(ckpt, new)
    if osp.exists(path):
      os.rename(path, old)
    os.rename(new, path)
    if osp.exists(old):
      os.remove(old)

  def _warm_start_from_snapshot(self) -> int:
    """Fallback resume when the full checkpoint is gone but the best
    snapshot + log.csv survived, e.g. a copy of a run the JAX package
    trained and committed (full checkpoints are too large to commit;
    snapshots are not).  Restores params + obs normalizer from
    model_pf_best.pt or, where there is none, from the JAX package's
    model_pf_best.flax (`utils.flax_msgpack`, no JAX needed), and picks
    epoch / total_frames / best_eval back up from log.csv; optimizer and
    env states restart fresh (a warm start, not a bit-exact resume)."""
    pf = osp.join(self.save_dir, "model_pf_best.pt")
    pf_flax = osp.join(self.save_dir, "model_pf_best.flax")
    nz = osp.join(self.save_dir, "_obs_normalizer_best.npz")
    log_csv = osp.join(osp.dirname(osp.abspath(self.save_dir)), "log.csv")
    from_flax = not osp.exists(pf) and osp.exists(pf_flax)
    if not ((osp.exists(pf) or from_flax) and osp.exists(nz)
            and osp.exists(log_csv)):
      return 0
    with open(log_csv) as f:
      header = f.readline().rstrip("\n").split(",")
      if "EPOCH" not in header or "Total Frames" not in header:
        return 0
      i_ep = header.index("EPOCH")
      i_fr = header.index("Total Frames")
      i_ev = (header.index("Eval_Rewards_Average")
              if "Eval_Rewards_Average" in header else None)
      last_epoch, total_frames, best = -1, 0, -np.inf
      for line in f:
        row = line.rstrip("\n").split(",")
        try:
          last_epoch = int(float(row[i_ep]))
          total_frames = int(float(row[i_fr]))
        except (ValueError, IndexError):
          continue
        if i_ev is not None and i_ev < len(row) and row[i_ev]:
          try:
            best = max(best, float(row[i_ev]))
          except ValueError:
            pass
    if last_epoch < 0:
      return 0
    if from_flax:
      sd = convert.params_from_flax(flax_msgpack.read_flax_snapshot(pf_flax))
    else:
      sd = torch.load(pf, map_location=self.device, weights_only=True)
    self.module.load_state_dict(sd)
    self.collector_state = self.collector_state.replace(
        normalizer=flax_msgpack.read_normalizer(nz, self.device))
    self.total_frames = total_frames
    if np.isfinite(best):
      self.best_eval = float(best)
    self._log(
        f"warm start from best snapshot "
        f"({osp.basename(pf_flax if from_flax else pf)}): epoch "
        f"{last_epoch + 1}, {total_frames} frames, best_eval "
        f"{self.best_eval:.1f} (no full checkpoint found; optimizer/env "
        "state reinitialized)")
    return last_epoch + 1

  def restore_checkpoint(self) -> int:
    """Restore a full checkpoint if present; returns the next epoch.
    Falls back to a snapshot warm start when no checkpoint exists."""
    path = osp.join(osp.abspath(self.save_dir), "checkpoint")
    if not osp.exists(path) and self.writer:
      # a crash between save_checkpoint's two renames leaves the complete
      # checkpoint under _new (or the previous one under _old)
      for alt in (path + "_new", path + "_old"):
        if osp.exists(alt):
          os.rename(alt, path)
          break
    # under ranks, the others wait for that rename
    self.mesh.all_reduce(torch.zeros(1, device=self.device))
    if not osp.exists(path):
      return self._warm_start_from_snapshot()
    ckpt = torch.load(path, map_location=self.device, weights_only=True)
    self.module.load_state_dict(ckpt["module"])
    opt = lambda d: AdamState(count=d["count"], mu=list(d["mu"]),
                              nu=list(d["nu"]))
    self.train_state = self.train_state.replace(
        pf_opt=opt(ckpt["pf_opt"]), vf_opt=opt(ckpt["vf_opt"]),
        epoch=ckpt["train_epoch"])
    gens = ckpt["generators"]
    grafted: List[str] = []
    # the global collector cut to this rank's envs
    # (vision4leg_tpu/algo/agent.py:509-512)
    flat = mesh_lib.shard_collector_state(self.mesh, ckpt["collector"],
                                          self.num_envs)
    cs = _unflatten(self.collector_state, flat, "cs", grafted)
    if grafted:
      self._log(f"checkpoint predates {len(grafted)} collector field(s); "
                f"kept their fresh values: {', '.join(grafted)}")
    cs.gen.set_state(gens["collect"].cpu())
    self.update_gen.set_state(gens["update"].cpu())
    self.eval_gen.set_state(gens["eval"].cpu())
    self.collector_state = cs
    self.best_eval = ckpt["best_eval"]
    self.total_frames = ckpt["total_frames"]
    return int(ckpt["epoch"]) + 1

  def snapshot(self, suffix: str):
    """Save params + normalizer (rl_algo.py:84-95 naming scheme); under a
    sharded mesh rank 0 alone."""
    if not self.writer:
      return
    torch.save(self.module.state_dict(),
               osp.join(self.save_dir, f"model_pf_{suffix}.pt"))
    nrm = self.collector_state.normalizer
    np.savez(osp.join(self.save_dir, f"_obs_normalizer_{suffix}.npz"),
             mean=nrm.mean.cpu().numpy(), var=nrm.var.cpu().numpy(),
             count=nrm.count.cpu().numpy())

  def _checkpoint_due(self, last_ckpt: float) -> bool:
    """Whether ckpt_secs have passed since the last checkpoint; under a
    sharded mesh, on any rank (the ranks must agree: a checkpoint is a
    collective)."""
    due = time.time() - last_ckpt >= self.ckpt_secs
    flag = torch.tensor([float(due)], device=self.device)
    return bool(self.mesh.all_reduce(flag, mesh_lib.dist.ReduceOp.MAX))

  def train(self, resume: bool = False, stop_epoch: Optional[int] = None):
    """Train epochs up to cfg.num_epochs, from the checkpoint's next epoch
    with `resume`.  stop_epoch ends this call before that epoch, on a full
    checkpoint, so that a run is trained in segments joined by `resume`:
    the learning-rate schedule keeps spanning cfg.num_epochs (a shorter
    num_epochs would decay it to 0 at the segment's end)."""
    cfg = self.cfg
    end = cfg.num_epochs if stop_epoch is None else min(stop_epoch,
                                                         cfg.num_epochs)
    start = time.time()
    start_epoch = self.restore_checkpoint() if resume else 0
    if start_epoch and self.writer:
      self.logger.log(f"resumed from checkpoint at epoch {start_epoch}")
      # drop stale log.csv rows from the crashed segment past the
      # checkpoint so the resumed run doesn't append duplicate epochs
      if hasattr(self.logger, "truncate_epochs_from"):
        self.logger.truncate_epochs_from(start_epoch)
    last_ckpt = time.time()
    for epoch in range(start_epoch, end):
      t0 = time.time()
      metrics = self.train_epoch(self._curriculum_episode_cap())
      # one device->host transfer for all epoch scalars
      cs = self.collector_state
      keys = list(metrics)
      finished = self.mesh.all_reduce(torch.stack(
          [cs.finished_count, cs.finished_returns_sum,
           cs.finished_len_sum]))
      stacked = torch.stack(
          [metrics[k].reshape(()).float() for k in keys]
          + list(finished)).cpu().numpy()
      train_time = time.time() - t0
      self.total_frames += cfg.epoch_frames
      infos = dict(zip(keys, map(float, stacked[:-3])))
      fin = float(stacked[-3])
      if fin > 0:
        infos["Running_Average_Rewards"] = float(stacked[-2]) / fin
        infos["Running_Average_Eplen"] = float(stacked[-1]) / fin
      zero = torch.zeros((), device=self.device)
      self.collector_state = cs.replace(
          finished_returns_sum=zero.clone(), finished_count=zero.clone(),
          finished_len_sum=zero.clone())
      infos["Train___Time"] = train_time
      infos.update(self.phase_seconds)

      if (epoch + 1) % self.eval_interval == 0:
        t0 = time.time()
        rets, _ = self.evaluate()
        mean_ret = float(rets.mean())
        infos["Eval_Rewards_Average"] = mean_ret
        infos["Eval____Time"] = time.time() - t0
        if mean_ret > self.best_eval:
          self.best_eval = mean_ret
          self.snapshot("best")

      if (epoch + 1) % self.save_interval == 0:
        self.snapshot(str(epoch + 1))
        self.save_checkpoint(epoch)
        last_ckpt = time.time()
      elif epoch + 1 == end < cfg.num_epochs or self._checkpoint_due(
          last_ckpt):
        # a segment's end, or the wall-clock checkpoint floor: bounds the
        # replay after a kill to ckpt_secs instead of save_interval epochs
        self.save_checkpoint(epoch)
        last_ckpt = time.time()

      if self.device.type == "cuda":
        # the process's peak so far, this epoch's eval included
        infos["diagnostics/cuda_max_memory_gib"] = (
            torch.cuda.max_memory_allocated(self.device) / 2 ** 30)
      if self.writer:
        self.logger.add_epoch_info(epoch, self.total_frames,
                                   time.time() - start, infos)
    if end == cfg.num_epochs:
      self.snapshot("finish")
