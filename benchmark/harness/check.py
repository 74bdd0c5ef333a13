"""Whether the timed path is correct: what the program produced in its
first (warm-up) epoch, through the window's own call `train_epoch`, held
against the plain reference (`reference/locotransformer.py`) after the
window has closed.

The same agent object goes on into the window.  Captured in that epoch:
  * each step's raw proprio observations as the normalizer takes them,
    and the normalized observations the policy saw;
  * the collection's policy means and values, on the time rows that the
    first three minibatches take (the learner's own permutation,
    replayed from its generator's state);
  * the whole epoch's rewards, values, terminals, time limits and
    bootstrap values (GAE's inputs), actions and behaviour log-probs;
  * the first three minibatch steps: each one's value and policy loss,
    both optimizers' first moments after the first step (0.1 times the
    gradient each optimizer got), and the parameters after the third.
The reference (the configuration's `reference` module) starts from the
same benchmark-made weights, recomputes the normalizer from the raw
observations, the forward, GAE from the collection's rewards and values,
and three PPO steps, and the numbers below compare the two sides.  The
env reference (its `env_reference` module) follows the sampled envs'
steps and resets, and settles its own standing template.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Dict, List

import torch

from harness.spans import Patches

N_STEPS = 3
B1 = 0.9
ENV_SAMPLE = 64


def _cpu(x):
  return x.detach().to("cpu", copy=True)


def take(x, idx):
  """The rows `idx` of every tensor of a tree of dataclasses and named or
  plain tuples whose tensors all lead with the env axis, on the host."""
  if x is None:
    return None
  if isinstance(x, torch.Tensor):
    return _cpu(x[idx.to(x.device)])
  if dataclasses.is_dataclass(x):
    return type(x)(**{f.name: take(getattr(x, f.name), idx)
                      for f in dataclasses.fields(x)})
  if isinstance(x, tuple):
    items = [take(v, idx) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
  raise TypeError(f"take: {type(x)}")


def to_device(x, dev):
  """A tree as `take` builds it, moved whole to `dev`."""
  if x is None:
    return None
  if isinstance(x, torch.Tensor):
    return x.to(dev)
  if dataclasses.is_dataclass(x):
    return type(x)(**{f.name: to_device(getattr(x, f.name), dev)
                      for f in dataclasses.fields(x)})
  items = [to_device(v, dev) for v in x]
  return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def env_sample(num_envs: int, seed: int) -> torch.Tensor:
  """The envs whose steps and resets the reference follows, drawn from
  the seed."""
  g = torch.Generator().manual_seed(seed % 2 ** 63)
  return torch.randperm(num_envs, generator=g)[:ENV_SAMPLE].sort().values


def reset_rows(n: int, sample: torch.Tensor) -> torch.Tensor:
  """The rows of a reset of n envs that the reference follows: the
  sample where all envs reset, else the first ENV_SAMPLE of them."""
  if n > int(sample.max()):
    return sample
  return torch.arange(min(n, ENV_SAMPLE))


@contextlib.contextmanager
def first_resets(env_cls, store: list, sample: torch.Tensor):
  """Record the sampled rows of every reset that `env_cls` makes inside
  the block (the collector's reset of all envs at its start)."""
  p = Patches()
  reset_from = env_cls.reset_from

  def rec(self, n, draws):
    out = reset_from(self, n, draws)
    rows = reset_rows(n, sample)
    store.append(dict(draws=take(draws, rows), obs=take(out[1], rows)))
    return out
  p.set(env_cls, "reset_from", rec)
  try:
    yield
  finally:
    p.restore()


def warm_start(cell, seed: int, device, log=lambda s: None):
  """Set-up's program: the agent built from the seed with the
  benchmark's weights, through its first epoch with the capture on.
  Returns (agent, capture)."""
  from harness import cell as cell_lib
  t0 = time.perf_counter()
  resets: list = []
  with first_resets(cell.program.env_class(), resets,
                    env_sample(cell.num_envs, seed)):
    agent = cell.program.build_agent(cell, seed, device)
  weights = cell_lib.make_weights(cell, seed, device)
  agent.module.load_state_dict(weights, strict=True)
  t1 = time.perf_counter()
  cap = cell.program.Capture(agent, weights, seed, resets, cell.reference,
                             cell.env_reference)
  with cap.first_epoch():
    agent.train_epoch()
  log(f"set-up: env, reset and agent {t1 - t0:.3f} s, warm epoch "
      f"{time.perf_counter() - t1:.3f} s")
  return agent, cap


class Capture:
  """The first epoch of a PPO agent (the program's `PPOAgent`), recorded
  for the check, and the reference's side of it."""

  def __init__(self, agent, weights: Dict[str, torch.Tensor], seed: int,
               resets, reference, env_reference):
    self.agent = agent
    self.ref, self.env_ref = reference, env_reference
    self.sample = env_sample(agent.num_envs, seed)
    self.resets = list(resets)
    self.env_steps: List[dict] = []
    self.device = agent.device
    self.w0 = {k: _cpu(v) for k, v in weights.items()}
    self.names = {"vf": list(agent.learner.vf_tx.names),
                  "pf": list(agent.learner.pf_tx.names)}

  @contextlib.contextmanager
  def first_epoch(self):
    """Hooks on the agent for the epoch run inside this block."""
    from vision4leg_torch.data import normalizer
    agent = self.agent
    self.gen_state = agent.update_gen.get_state().clone()
    nrm = agent.collector_state.normalizer
    self.norm0 = (_cpu(nrm.mean), _cpu(nrm.var), float(nrm.count))
    self.raw: List[torch.Tensor] = []
    self.out: dict = {}
    self.steps: List[dict] = []
    p = Patches()
    update, rollout = normalizer.update, agent.rollout
    minibatch = agent.learner._minibatch_update
    env = agent.env
    step_from, reset_from = env.step_from, env.reset_from

    def rec_step(states, actions, draws):
      out = step_from(states, actions, draws)
      rows = self.sample
      self.env_steps.append(dict(
          state=take(states, rows), action=take(actions, rows),
          draws=take(draws, rows), obs=take(out[1], rows),
          rew=take(out[2], rows), done=take(out[3], rows)))
      return out

    def rec_reset(n, draws):
      out = reset_from(n, draws)
      rows = reset_rows(n, self.sample)
      self.resets.append(dict(draws=take(draws, rows),
                              obs=take(out[1], rows)))
      return out

    def rec_update(state, batch, *a, **kw):
      self.raw.append(batch.detach().clone())
      return update(state, batch, *a, **kw)

    def rec_rollout(cs, max_ep=None):
      cs, traj, last_value = rollout(cs, max_ep)
      self.out.update(traj=traj, last_value=last_value)
      return cs, traj, last_value

    def rec_minibatch(ts, batch):
      ts, m = minibatch(ts, batch)
      k = len(self.steps)
      entry = {}
      if k < N_STEPS:
        entry = {"vf_loss": float(m["Training/vf_loss"]),
                 "pf_loss": float(m["Training/policy_loss"])}
        if k == 0:
          entry["mu"] = {"vf": [_cpu(x) for x in ts.vf_opt.mu],
                         "pf": [_cpu(x) for x in ts.pf_opt.mu]}
        if k == N_STEPS - 1:
          entry["params"] = {n: _cpu(q) for n, q in
                             agent.module.named_parameters()}
      self.steps.append(entry)
      return ts, m

    p.set(normalizer, "update", rec_update)
    p.set(agent, "rollout", rec_rollout)
    p.set(agent.learner, "_minibatch_update", rec_minibatch)
    p.set(env, "step_from", rec_step)
    p.set(env, "reset_from", rec_reset)
    try:
      yield
    finally:
      p.restore()
    self._keep()

  def _keep(self):
    """Keep on the host what the reference needs, and nothing more."""
    traj, lv = self.out.pop("traj"), self.out.pop("last_value")
    T = traj.rewards.shape[0]
    g = torch.Generator(device=self.device)
    g.set_state(self.gen_state)
    perm = torch.randperm(T, generator=g, device=self.device)
    rows = max(self.agent.learner.cfg.batch_size // self.agent.num_envs, 1)
    self.rows = [perm[k * rows:(k + 1) * rows].cpu() for k in range(N_STEPS)]
    P = self.agent.env.cfg.proprio_dim
    take = lambda x, k: _cpu(x[self.rows[k].to(x.device)].reshape(
        (-1,) + x.shape[2:]))
    self.batch = [{f: take(getattr(traj, f), k)
                   for f in ("obs", "acts", "log_probs", "means", "values")}
                  for k in range(N_STEPS)]
    self.gae_in = {f: _cpu(getattr(traj, f)[..., 0]) for f in
                   ("rewards", "values", "terminals", "time_limits")}
    self.gae_in["last_value"] = _cpu(lv)
    self.obs_head = _cpu(traj.obs[..., :P])
    self.raw = [_cpu(x) for x in self.raw]
    self.template = to_device(self.agent.env.settled_template(), "cpu")

  def env_numbers(self, params: dict) -> dict:
    """env_mismatch: the share (%) of the sampled env steps and resets
    whose outputs the env reference does not reproduce (its `mismatch`),
    each step followed from the program's own state, each reset placed
    from the reference's own settled template; template_gap: the widest
    gap of the program's settled template from the reference's."""
    env_ref = self.env_ref
    eb = params["env"]["env_build"]
    er = env_ref.EnvRef(eb, self.device)
    P = self.ref.proprio_dim(eb)
    bad, n = 0, 0
    for e in self.env_steps:
      d = lambda x: to_device(x, self.device)
      obs, rew, done = er.step(d(e["state"]), d(e["action"]), d(e["draws"]))
      bad += int(env_ref.mismatch(e["obs"], e["rew"], e["done"], obs, rew,
                                  done, P).sum())
      n += e["obs"].shape[0]
    for r in self.resets:
      obs = er.reset(to_device(r["draws"], self.device))
      bad += int(env_ref.mismatch(r["obs"], None, None, obs, None, None,
                                  P).sum())
      n += r["obs"].shape[0]
    return {"env_mismatch": 100.0 * bad / max(n, 1),
            "template_gap": env_ref.template_gap(self.template, er.settle())}

  # ------------------------------------------------------------------
  def program_side(self) -> dict:
    s = self.steps
    return {
        "obs_head": self.obs_head,
        "means": [b["means"] for b in self.batch],
        "values": [b["values"] for b in self.batch],
        "losses": [(e["vf_loss"], e["pf_loss"]) for e in s[:N_STEPS]],
        "grads": {k: [m / (1 - B1) for m in s[0]["mu"][k]]
                  for k in ("vf", "pf")},
        "params": s[N_STEPS - 1]["params"],
    }

  def reference_side(self, params: dict, tf32: bool,
                     norm_dtype=torch.float64, dtype=torch.float32) -> dict:
    """The plain reference on the captured inputs, its matrix products in
    TF32 where `tf32` (the control), else in float32 (or in `dtype`).
    The forward and the steps take the observations as the program
    normalized them; norm_gap holds every element of that normalization
    to the reference's own (PERF.md gives why the forward does not take
    the reference's)."""
    ref = self.ref
    dev = self.device
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
      net = ref.Net(params)
      w = {k: v.to(dev, dtype).clone() for k, v in self.w0.items()}
      obs = [b["obs"] for b in self.batch]
      means, values = [], []
      with torch.no_grad():
        for o in obs:
          (m, _), v = net.pi_v(w, o.to(dev, dtype))
          means.append(m.cpu())
          values.append(v.cpu())
      gi = self.gae_in
      advs, rets = ref.gae(gi["rewards"], gi["values"], gi["terminals"],
                           gi["time_limits"], gi["last_value"],
                           params["general_setting"]["discount"],
                           params["ppo"]["tau"])
      batches = []
      for k, b in enumerate(self.batch):
        r = self.rows[k]
        batches.append(tuple(x.to(dev, dtype) for x in (
            obs[k], b["acts"], advs[r].reshape(-1, 1),
            rets[r].reshape(-1, 1), b["log_probs"])))
      losses, first, sets = ref.ppo_steps(params, w, batches, N_STEPS)
      by_name = {k: dict(zip(sets[k], first[k])) for k in sets}
      grads = {k: [by_name[k][n].cpu() for n in self.names[k]]
               for k in ("vf", "pf")}
      return {"obs_head": normalize(self.norm0, self.raw, norm_dtype),
              "means": means, "values": values, "losses": losses,
              "grads": grads, "params": {k: v.cpu() for k, v in w.items()},
              "names": self.names}
    finally:
      torch.backends.cuda.matmul.allow_tf32 = old


def normalize(norm0, raw: List[torch.Tensor], dtype) -> torch.Tensor:
  """The normalized proprio head of every step: running mean and
  variance merged batch by batch, (x - mean) / (std + 1e-4) clipped to
  +-10."""
  mean, var, count = (norm0[0].to(dtype), norm0[1].to(dtype),
                      torch.tensor(norm0[2], dtype=dtype))
  out = []
  for x in raw:
    x = x.to(dtype)
    n = x.shape[0]
    b_mean = x.mean(dim=0)
    b_var = x.var(dim=0, unbiased=False)
    delta = b_mean - mean
    tot = count + n
    mean = mean + delta * n / tot
    var = (var * count + b_var * n + delta * delta * count * n / tot) / tot
    count = tot
    out.append(torch.clamp((x - mean) / (torch.sqrt(var) + 1e-4), -10, 10))
  return torch.stack(out).float()


def _rms(xs) -> float:
  x = torch.cat([t.reshape(-1).double() for t in xs])
  return float(torch.sqrt(torch.mean(x * x)))


def _widest(a, b) -> float:
  return max(float((x.double() - y.double()).abs().max())
             for x, y in zip(a, b))


def numbers(side: dict, ref: dict, w0: Dict[str, torch.Tensor]) -> dict:
  """The compared numbers of `side` against the reference `ref`:
  collect_gap  widest gap of the collection's means and values, over
               the RMS of the reference's;
  norm_gap     widest gap of the normalized proprio observations;
  loss_gap     worst gap of the first steps' losses: the value loss's
               over its size, the policy loss's over its size or 1,
               whichever is larger (a mean of terms of the scale of the
               minibatch's unit-variance advantages, which can pass
               through 0);
  grad_gap     the median leaf's gap between the norms of the first
               step's gradient, each over that leaf's or the median
               leaf's norm, whichever is larger, among the leaves whose
               reference gradient is at least a thousandth of the median
               leaf's (the same leaves as change_gap's).  The median, not
               the worst leaf: that is a query or key weight, whose
               gradient at initialization (attention near uniform) is a
               difference of near-equal terms, and the float32 reference
               itself reads up to 0.22 against float64 there (`grad_gaps`
               gives every leaf's);
  change_gap   the median leaf's gap between the norms of the
               parameters' change after the steps, each over that leaf's
               or the median leaf's change, whichever is larger, among the
               leaves whose reference gradient is at least a thousandth of
               the median leaf's.  The median, not the worst leaf: the
               worst is a leaf whose gradient elements lie near 0, where
               Adam's first steps (g / (|g| + eps)) take the sign of
               rounding, and it swings from seed to seed (`change_gaps`
               gives every leaf's)."""
  collect = max(_widest(side["means"], ref["means"]) / _rms(ref["means"]),
                _widest(side["values"], ref["values"]) / _rms(ref["values"]))
  norm = _widest([side["obs_head"]], [ref["obs_head"]])
  loss = max(max(abs(sv - rv) / abs(rv), abs(sp - rp) / max(abs(rp), 1.0))
             for (sv, sp), (rv, rp) in zip(side["losses"], ref["losses"]))
  return {"collect_gap": collect, "norm_gap": norm, "loss_gap": loss,
          "grad_gap": statistics.median(grad_gaps(side, ref).values()),
          "change_gap": change_gap(side, ref, w0)}


def grad_gaps(side: dict, ref: dict, keep=None) -> Dict[str, float]:
  """Per optimizer and kept leaf (by default those of `moved_leaves`),
  the gap between the norms of the first gradient."""
  keep = set(moved_leaves(ref, ref["names"]) if keep is None else keep)
  g_ref = {(k, n): float(x.double().norm())
           for k in ref["grads"] for n, x in zip(ref["names"][k],
                                                 ref["grads"][k])
           if n in keep}
  g_side = {(k, n): float(x.double().norm())
            for k in side["grads"] for n, x in zip(ref["names"][k],
                                                   side["grads"][k])}
  med = statistics.median(g_ref.values())
  return {f"{k}:{n}": abs(g_side[(k, n)] - b) / max(b, med)
          for (k, n), b in g_ref.items()}


def moved_leaves(ref: dict, names: Dict[str, List[str]]) -> List[str]:
  """The leaves whose first reference gradient, in some optimizer, is at
  least a thousandth of the median leaf's; the others move under Adam by
  round-off alone."""
  norms = {}
  for k, ns in names.items():
    for n, g in zip(ns, ref["grads"][k]):
      norms[n] = max(norms.get(n, 0.0), float(g.double().norm()))
  med = statistics.median(norms.values())
  return [n for n, v in norms.items() if v >= 1e-3 * med]


def change_gaps(side: dict, ref: dict, w0) -> Dict[str, float]:
  """Per kept leaf, the gap between the norms of its change."""
  keep = moved_leaves(ref, ref["names"])
  d_ref = {n: float((ref["params"][n].double() - w0[n].double()).norm())
           for n in keep}
  d_side = {n: float((side["params"][n].double() - w0[n].double()).norm())
            for n in keep}
  med = statistics.median(d_ref.values())
  return {n: abs(d_side[n] - d_ref[n]) / max(d_ref[n], med) for n in keep}


def change_gap(side: dict, ref: dict, w0) -> float:
  return statistics.median(change_gaps(side, ref, w0).values())
