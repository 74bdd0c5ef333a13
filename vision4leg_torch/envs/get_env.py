"""Environment construction from the reference JSON config schema (torch
mirror of vision4leg_tpu.envs.get_env; reference vision4leg/get_env.py +
env_dict.py).  NormAct and obs normalization live in the collector,
TimeLimit in the rollout bookkeeping, reward_scale in `meta`."""
from __future__ import annotations

import dataclasses

from vision4leg_torch.envs.env import A1GymEnv, EnvConfig

TIMELIMIT = {"A1MoveGround": 1000, "A1MoveGroundMPC": 1000}

_DIRECT_KEYS = {
    "motor_control_mode", "z_constrain", "other_direction_penalty",
    "z_penalty", "diagonal_act", "num_action_repeat", "time_step_s",
    "add_last_action_input", "enable_action_interpolation",
    "enable_action_filter", "domain_randomization", "get_image",
    "depth_image", "depth_norm", "grayscale", "rgbd", "terrain_type",
    "alive_reward", "fall_reward", "target_vel", "random_init_range",
    "check_contact", "frame_extract", "goal", "subgoal", "goal_coeff",
    "subgoal_reward", "no_displacement", "get_image_interval",
    "reset_frame_idx", "reset_frame_idx_each_step", "random_shape",
    "moving", "curriculum", "interpolation", "fixed_delay_observation",
    "empty_image", "random_dir", "dir_update_interval", "rotate_sensor",
    "record_video",
}


def env_config_from_build_params(env_build: dict) -> EnvConfig:
  kwargs = {}
  for k, v in env_build.items():
    if k in _DIRECT_KEYS:
      kwargs[k] = v
    elif k == "clip_num":
      kwargs["clip_num"] = tuple(v) if v is not None else None
    elif k == "fric_coeff":
      kwargs["fric_coeff"] = tuple(v)
    else:
      raise KeyError(f"unknown env_build key: {k}")
  return EnvConfig(**kwargs)


def get_env(env_name: str, env_params: dict, device=None):
  """Returns (env, meta); meta carries reward_scale / obs_norm / horizon
  for the collector.  The env runs on `device` ("cuda" by default)."""
  if "rew_norm" in env_params:
    raise NotImplementedError("rew_norm is not wired into the collector "
                              "(no shipped config sets it)")
  meta = {
      "reward_scale": env_params.get("reward_scale", 1.0),
      "obs_norm": env_params.get("obs_norm", False),
      "horizon": env_params.get("horizon", TIMELIMIT.get(env_name, 1000)),
  }
  if env_name == "A1MoveGround":
    cfg = env_config_from_build_params(dict(env_params.get("env_build", {})))
    return A1GymEnv(cfg, device=device), meta
  if env_name == "A1MoveGroundMPC":
    from vision4leg_torch.envs.mpc_env import A1MPCGymEnv, MpcEnvConfig
    env_build = dict(env_params.get("env_build", {}))
    policy_freq = env_build.pop("policy_freq", 10)
    vision_only = env_build.pop("vision_only", False)
    base = env_config_from_build_params(env_build)
    cfg = MpcEnvConfig(**dataclasses.asdict(base), policy_freq=policy_freq,
                       vision_only=vision_only)
    return A1MPCGymEnv(cfg, device=device), meta
  raise NotImplementedError(f"unknown env {env_name}")
