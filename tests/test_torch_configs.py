"""The JSON configs the port runs, on the CPU: all of them.

Each config builds its env (on the CPU, without a reset) and its torch
starter's actor-critic at the config's width, and the module takes a
batch of the env's observation layout.  The starter
follows the config's directory, as the reference's README pairs them:
LocoTransformer for `locotransformer*` (the challenge terrains'
`challenge/locotransformer` among them), the vision-only LocoTransformer
for `mpc_vision_only/locotransformer`, the Nature-CNN baseline for
`naive_baseline`, `frame_extract4*`, `mpc/baseline` and
`challenge/baseline`, its vision-only form for `mpc_vision_only/baseline`,
and the proprio-only `ppo_state` for `state-only-baseline`.  Each
thin-random-shape config builds with a warning: `random_shape` is
ignored, as the JAX env ignores it.  The MPC env refuses the MMDR options
and moving obstacles, which the JAX MPC env ignores.
"""
import glob
import json
import os

import pytest
import torch

from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.starter import (ppo_locotransformer,
                                      ppo_locotransformer_vision_only,
                                      ppo_nature_cnn,
                                      ppo_nature_cnn_vision_only, ppo_state)

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config")
FLAT = ("thin-goal", "thin", "thin-wide")
RL_STATIC = ("frame_extract4", "frame_extract4_fixed_delay",
             "frame_extract4_interpolation", "frame_extract4_random_delay",
             "locotransformer_random_delay", "naive_baseline")
RL_MOVING = ("frame_extract4", "frame_extract4_random_delay",
             "locotransformer", "locotransformer_random_delay",
             "naive_baseline")
MPC = ("mpc/baseline", "mpc_vision_only/baseline")


CHALLENGE = ("chair_desk", "hill", "mountain", "stairs")


def _ported():
  """The 42 configs on the sparse-family terrains (flat ground, boxes),
  the 22 of the heightfield and challenge terrains, the 4 MPC ones on the
  heightfield and the 16 thin-random-shape ones."""
  out = [f"rl/static/{d}/{t}" for d in RL_STATIC for t in FLAT]
  out.append("rl/static/locotransformer/thin-wide")
  out += [f"rl/moving/{d}/{t}" for d in RL_MOVING for t in FLAT]
  out += [f"{d}/{t}" for d in MPC for t in FLAT]
  out += ["mpc/locotransformer/thin-wide",
          "mpc_vision_only/locotransformer/thin-wide"]
  out += [f"rl/static/{d}/thin-heightfield"
          for d in RL_STATIC + ("locotransformer",)]
  out += [f"rl/moving/{d}/thin-heightfield" for d in RL_MOVING]
  out.append("rl/static/state-only-baseline")
  out += [f"rl/challenge/{d}/{t}" for d in ("baseline", "locotransformer")
          for t in CHALLENGE]
  out.append("rl/challenge/locotransformer/chair_desk_ent")
  out += [f"{d}/thin-heightfield" for d in MPC + (
      "mpc/locotransformer", "mpc_vision_only/locotransformer")]
  out += [f"rl/{d}/thin-random-shape" for d in
          [f"static/{d}" for d in RL_STATIC + ("locotransformer",)]
          + [f"moving/{d}" for d in RL_MOVING]]
  out += [f"{d}/thin-random-shape" for d in MPC + (
      "mpc/locotransformer", "mpc_vision_only/locotransformer")]
  return out


PORTED = _ported()


def _starter(name):
  if name.endswith("state-only-baseline"):
    return ppo_state
  if "vision_only" in name:
    return (ppo_locotransformer_vision_only if "locotransformer" in name
            else ppo_nature_cnn_vision_only)
  return ppo_locotransformer if "locotransformer" in name else ppo_nature_cnn


def _params(name):
  with open(os.path.join(ROOT, name + ".json")) as f:
    return json.load(f)


def test_the_port_runs_all_84_configs():
  assert len(PORTED) == len(set(PORTED)) == 84
  for name in PORTED:
    assert os.path.exists(os.path.join(ROOT, name + ".json")), name
  # every config of the repo but the experiments' and the seven of the
  # main paths, which other files hold; none is refused
  every = {os.path.relpath(p, ROOT)[:-5] for p in glob.glob(
      os.path.join(ROOT, "**", "*.json"), recursive=True)}
  assert len(every) == 91
  assert every - set(PORTED) == {
      "experiments/locotransformer/thin-goal-cvf",
      "mpc/locotransformer/thin-goal", "mpc/locotransformer/thin",
      "mpc_vision_only/locotransformer/thin-goal",
      "mpc_vision_only/locotransformer/thin",
      "rl/static/locotransformer/thin-goal",
      "rl/static/locotransformer/thin"}
  assert sum(n.endswith("thin-random-shape") for n in PORTED) == 16


@pytest.mark.parametrize("name", PORTED)
def test_config_builds_env_and_module(name):
  params = _params(name)
  if params["env"]["env_build"].get("random_shape"):
    with pytest.warns(UserWarning, match="random_shape=True is ignored"):
      env, meta = get_env(params["env_name"], params["env"], device="cpu")
  else:
    env, meta = get_env(params["env_name"], params["env"], device="cpu")
  module = _starter(name).build_module(env, params)
  obs = torch.zeros(2, env.obs_dim)
  with torch.no_grad():
    mean, std, _ = module.pi(obs)
    value = module.v(obs)
  assert mean.shape == std.shape == (2, env.cfg.action_dim)
  assert value.shape == (2, 1) and meta["obs_norm"]


@pytest.mark.parametrize("option", ["reset_frame_idx",
                                    "reset_frame_idx_each_step",
                                    "interpolation", "moving"])
def test_mpc_env_refuses_what_the_jax_mpc_env_ignores(option):
  params = _params("mpc/baseline/thin-goal")
  params["env"]["env_build"].update({option: True, "frame_extract": 4})
  with pytest.raises(NotImplementedError, match="accepts and ignores"):
    get_env(params["env_name"], params["env"], device="cpu")
