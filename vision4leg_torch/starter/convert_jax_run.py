"""Convert a run of the JAX package (a work dir of `runs/`: params.json,
model/model_pf_{snap}.flax, model/_obs_normalizer_{snap}.npz) into this
port's snapshot: model_pf_{snap}.pt and _obs_normalizer_{snap}.npz in a
directory the caller names.  The policy is rebuilt from params.json by
its starter's module (`--starter`), loaded strictly and run once on the
card (or with --device cpu) on the normalized zero observation, so that
a conversion that does not load or run fails here.  It never writes into
the run it reads.

  python -m vision4leg_torch.starter.convert_jax_run \
      --run runs/mmdr_moving_10M/A1MoveGround/0 --out <dir>/model \
      [--snap best] [--starter ppo_locotransformer] [--device cpu]
"""
from __future__ import annotations

import argparse
import importlib
import os
import os.path as osp

import numpy as np
import torch

from vision4leg_torch import resolve_device
from vision4leg_torch.data import normalizer as norm
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.starter.viewer_common import build_policy
from vision4leg_torch.utils import flax_msgpack
from vision4leg_torch.utils.args import get_params


def convert_run(run_dir: str, out_dir: str, snap: str = "best",
                starter: str = "ppo_locotransformer", device=None) -> dict:
  """Write out_dir/model_pf_{snap}.pt and _obs_normalizer_{snap}.npz from
  the JAX run in run_dir; returns the paths and the probe's outputs."""
  run_dir, out_dir = osp.realpath(run_dir), osp.realpath(out_dir)
  if out_dir == run_dir or out_dir.startswith(run_dir + os.sep):
    raise ValueError(f"convert_jax_run: {out_dir} lies inside the run it "
                     f"reads ({run_dir}); name a directory outside it")
  device = resolve_device(device)
  params = get_params(osp.join(run_dir, "params.json"))
  env, meta = get_env(params["env_name"], params["env"], device=device)
  sd, nstate = flax_msgpack.load_jax_run(run_dir, snap, device)
  build = importlib.import_module(
      f"vision4leg_torch.starter.{starter}").build_module
  module = build_policy(env, params, build, sd)
  with torch.no_grad():
    obs = torch.zeros(1, env.obs_dim, device=device)
    if meta["obs_norm"]:
      obs = norm.filt_with_img_tail(nstate, obs, env.cfg.proprio_dim)
    mean, _, _ = module.pi(obs)
  if not torch.isfinite(mean).all():
    raise ValueError("convert_jax_run: the converted policy's mean is not "
                     "finite")
  os.makedirs(out_dir, exist_ok=True)
  pt = osp.join(out_dir, f"model_pf_{snap}.pt")
  nz = osp.join(out_dir, f"_obs_normalizer_{snap}.npz")
  torch.save(sd, pt)
  np.savez(nz, mean=nstate.mean.cpu().numpy(), var=nstate.var.cpu().numpy(),
           count=nstate.count.cpu().numpy())
  return dict(model=pt, normalizer=nz, module=type(module).__name__,
              probe_mean=mean[0].cpu().numpy())


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--run", type=str, required=True,
                 help="the JAX run's work dir (params.json, model/)")
  p.add_argument("--out", type=str, required=True,
                 help="directory for the port's snapshot")
  p.add_argument("--snap", type=str, default="best")
  p.add_argument("--starter", type=str, default="ppo_locotransformer",
                 help="the port starter whose build_module fits the run")
  p.add_argument("--device", type=str, default=None,
                 help="cpu to run without a card (default: the card)")
  args = p.parse_args(argv)
  r = convert_run(args.run, args.out, args.snap, args.starter, args.device)
  print(f"{r['module']}: wrote {r['model']} and {r['normalizer']}; probe "
        f"mean action {np.round(r['probe_mean'], 4)}")
  return r


if __name__ == "__main__":
  main()
