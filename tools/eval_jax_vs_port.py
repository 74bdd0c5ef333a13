"""One snapshot of a JAX-trained run, evaluated by the JAX package and by
the port on the CPU under the agents' eval protocol, and the rule that
decides whether the two agree.

  JAX_PLATFORMS=cpu python3 tools/eval_jax_vs_port.py \\
      --run runs/mmdr_moving_10M/A1MoveGround/0 --snap best \\
      [--envs 32] [--steps 999] [--seeds 0 1 2] [--package jax port]
  python3 tools/eval_jax_vs_port.py --decide jax.out port.out

The protocol is the agents' own eval (vision4leg_tpu/algo/agent.py:248-271,
vision4leg_torch/algo/agent.py `evaluate`): `envs` fresh envs of the run's
params.json, tanh(mean) actions mapped into the action bounds, the
snapshot's frozen observation normalizer, `steps` steps, each env's
return and step count masked after its first done.  The JAX side is the
JAX PPOAgent's jitted `_eval` on the snapshot's flax params; the port's is
`PPOAgent.evaluate` with device="cpu" on the same snapshot read without
JAX (`utils.flax_msgpack`).  Each seed is one eval pass: a JAX PRNGKey, a
torch generator; the two packages draw differently, so their episodes
are compared as samples, not one by one.

For each package it prints one JSON line: the mean return with its
standard error, the fall share (episodes done before `steps`) and the
mean episode length; then the decision line (`decide`): the packages
agree if both the means and the fall shares differ by at most
AGREE_SE standard errors of their difference (Welch's for the means,
the two binomial errors' for the shares).

Time on the CPU at 32 envs x 999 steps: see README.md.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

AGREE_SE = 2.5


def summary(returns, steps, horizon: int) -> dict:
  """Mean return, its standard error, the fall share and the mean episode
  length of one package's episodes; an episode whose return is not finite
  is counted (`nonfinite`) and left out of the return's statistics."""
  r = np.asarray(returns, np.float64).reshape(-1)
  s = np.asarray(steps, np.float64).reshape(-1)
  fin = np.isfinite(r)
  n = int(fin.sum())
  return dict(episodes=r.size, nonfinite=int(r.size - n),
              mean_return=float(r[fin].mean()),
              se_return=float(r[fin].std(ddof=1) / math.sqrt(n)),
              fall_share=float(np.mean(s < horizon)),
              mean_episode_length=float(s.mean()))


def decide(a: dict, b: dict, k: float = AGREE_SE) -> dict:
  """Whether two `summary`s agree: |mean_a - mean_b| <= k sqrt(se_a^2 +
  se_b^2) (Welch), and |fall_a - fall_b| <= k sqrt(p_a (1 - p_a) / n_a +
  p_b (1 - p_b) / n_b)."""
  d_mean = a["mean_return"] - b["mean_return"]
  se_mean = math.hypot(a["se_return"], b["se_return"])
  pa, pb = a["fall_share"], b["fall_share"]
  d_fall = pa - pb
  se_fall = math.sqrt(pa * (1 - pa) / a["episodes"]
                      + pb * (1 - pb) / b["episodes"])
  means = abs(d_mean) <= k * se_mean
  falls = abs(d_fall) <= k * se_fall
  return dict(mean_diff=d_mean, mean_diff_se=se_mean,
              mean_diff_in_se=(d_mean / se_mean if se_mean else 0.0),
              means_agree=means, fall_diff=d_fall, fall_diff_se=se_fall,
              fall_diff_in_se=(d_fall / se_fall if se_fall else 0.0),
              falls_agree=falls, agree=means and falls, k=k)


def load_params(run: str) -> dict:
  with open(osp.join(run, "params.json")) as f:
    return json.load(f)


def eval_jax(run: str, snap: str, envs: int, steps: int, seeds):
  """(returns, steps) of each seed's eval pass by the JAX agent."""
  os.environ.setdefault("JAX_PLATFORMS", "cpu")
  import warnings

  import jax
  import jax.numpy as jnp
  jax.config.update("jax_platforms", "cpu")
  from flax import serialization
  from starter import ppo_locotransformer as jax_starter
  from vision4leg_tpu.algo.agent import PPOAgent as JaxAgent
  from vision4leg_tpu.algo.ppo import PPOConfig as JaxPPOConfig
  from vision4leg_tpu.data import normalizer as jnorm
  from vision4leg_tpu.envs.get_env import get_env as jax_get_env
  params = load_params(run)
  env, meta = jax_get_env(params["env_name"], params["env"])
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    agent = JaxAgent(
        env=env, ac_module=jax_starter.build_module(env, params),
        cfg=JaxPPOConfig(epoch_frames=2, max_episode_frames=steps),
        num_envs=2, seed=0, logger=None,
        save_dir=osp.join(os.environ.get("TMPDIR", "/tmp"), "eval_jax"),
        num_eval_envs=envs, obs_norm=meta["obs_norm"],
        env_time_limit=meta["horizon"], reward_scale=meta["reward_scale"],
        eval_horizon=steps)
  model = osp.join(run, "model")
  with open(osp.join(model, f"model_pf_{snap}.flax"), "rb") as f:
    flax_params = serialization.msgpack_restore(f.read())
  z = np.load(osp.join(model, f"_obs_normalizer_{snap}.npz"))
  nrm = jnorm.NormalizerState(mean=jnp.asarray(z["mean"]),
                              var=jnp.asarray(z["var"]),
                              count=jnp.asarray(z["count"]))
  out = []
  for seed in seeds:
    rets, st = agent._eval(flax_params, nrm, jax.random.PRNGKey(seed))
    out.append((np.asarray(rets), np.asarray(st)))
  return out


def trace_nonfinite(env, log):
  """Wrap env.step_batch to append to `log`, for each env whose reward
  first turns non-finite, the step and its state before that step: base
  height, the body z axis's up component, base speeds, the fastest joint
  and the nearest box centre's distance in the plane."""
  step_batch, count, seen = env.step_batch, [0], set()

  def traced(states, actions, gen):
    out = step_batch(states, actions, gen)
    bad = (~torch.isfinite(out[2])).nonzero()[:, 0].tolist()
    for i in bad:
      if i in seen:
        continue
      seen.add(i)
      ph = states.robot.phys
      w, x, y, _ = ph.quat[i].tolist()
      boxes = states.terrain.boxes[i, :, :2]
      log.append(dict(
          env=i, step=count[0], base_z=float(ph.pos[i, 2]),
          up=1 - 2 * (x * x + y * y),
          lin_speed=float(ph.lin[i].norm()), ang_speed=float(ph.ang[i].norm()),
          joint_qd_max=float(ph.joint_qd[i].abs().max()),
          nearest_box=float((boxes - ph.pos[i, :2]).norm(dim=-1).min()),
          action=[round(v, 4) for v in actions[i].tolist()]))
    count[0] += 1
    return out

  env.step_batch = traced


def eval_port(run: str, snap: str, envs: int, steps: int, seeds,
              trace=None):
  """(returns, steps) of each seed's eval pass by the port's agent on the
  CPU; `trace`, a list where given, receives `trace_nonfinite`'s records
  (with the seed)."""
  import warnings

  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.envs.get_env import get_env
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  from vision4leg_torch.utils import flax_msgpack
  params = load_params(run)
  env, meta = get_env(params["env_name"], params["env"], device="cpu")
  cfg = dataclasses.replace(common.ppo_config(params), epoch_frames=2)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    agent = PPOAgent(
        env=env, ac_module=starter.build_module(env, params), cfg=cfg,
        num_envs=2, seed=0, logger=None,
        save_dir=osp.join(os.environ.get("TMPDIR", "/tmp"), "eval_port"),
        num_eval_envs=envs, obs_norm=meta["obs_norm"],
        env_time_limit=meta["horizon"], reward_scale=meta["reward_scale"],
        eval_horizon=steps, device="cpu")
  sd, nrm = flax_msgpack.load_jax_run(run, snap)
  agent.module.load_state_dict(sd)
  agent.collector_state = agent.collector_state.replace(normalizer=nrm)
  log = []
  if trace is not None:
    trace_nonfinite(env, log)
  out = []
  for seed in seeds:
    agent.eval_gen.manual_seed(seed)
    rets, st = agent.evaluate()
    out.append((rets.numpy(), st.numpy()))
    if trace is not None:
      trace.extend(dict(r, seed=seed) for r in log)
      log.clear()
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--run", default="runs/mmdr_moving_10M/A1MoveGround/0")
  p.add_argument("--snap", default="best")
  p.add_argument("--envs", type=int, default=32)
  p.add_argument("--steps", type=int, default=999)
  p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
  p.add_argument("--package", nargs="+", default=["jax", "port"],
                 choices=["jax", "port"])
  p.add_argument("--trace", action="store_true",
                 help="the port: print the state before each episode's "
                      "first non-finite reward")
  p.add_argument("--decide", nargs=2, metavar=("JAX_OUT", "PORT_OUT"),
                 help="print the decision line of two earlier runs' "
                      "outputs (one package each) and evaluate nothing")
  args = p.parse_args(argv)
  if args.decide:
    lines = {}
    for path in args.decide:
      with open(path) as f:
        for line in f:
          if line.startswith('{"package"'):
            d = json.loads(line)
            lines[d["package"]] = d
    keys = ("episodes", "nonfinite", "mean_return", "se_return",
            "fall_share", "mean_episode_length")
    print(json.dumps(dict(
        decision=decide(*({k: lines[pkg][k] for k in keys}
                          for pkg in ("jax", "port"))),
        run=lines["jax"]["run"], snap=lines["jax"]["snap"])), flush=True)
    return 0
  results = {}
  for pkg in args.package:
    t = time.time()
    trace = [] if args.trace and pkg == "port" else None
    if pkg == "jax":
      passes = eval_jax(args.run, args.snap, args.envs, args.steps,
                        args.seeds)
    else:
      passes = eval_port(args.run, args.snap, args.envs, args.steps,
                         args.seeds, trace)
    for record in trace or ():
      print(json.dumps(dict(nonfinite_trace=record)), flush=True)
    rets = np.concatenate([r for r, _ in passes])
    st = np.concatenate([s for _, s in passes])
    results[pkg] = summary(rets, st, args.steps)
    line = dict(package=pkg, run=args.run, snap=args.snap, envs=args.envs,
                steps=args.steps, seeds=args.seeds,
                seconds=time.time() - t, **results[pkg],
                per_seed_mean=[float(r.mean()) for r, _ in passes],
                episode_returns=[round(float(v), 3) for v in rets],
                episode_steps=[int(v) for v in st])
    print(json.dumps(line), flush=True)
  if len(results) == 2:
    print(json.dumps(dict(decision=decide(results["jax"], results["port"]),
                          run=args.run, snap=args.snap)), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
