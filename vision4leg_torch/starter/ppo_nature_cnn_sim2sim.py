"""Sim-to-sim transfer variant of the Nature-CNN baseline, on the card
(torch mirror of starter/ppo_nature_cnn_sim2sim.py; reference
starter/ppo_nature_cnn_sim2sim.py): the network of ppo_nature_cnn, but
evaluation runs on a transfer env rebuilt from a changed copy of the
config (reference :43-60):

  * reset_frame_idx_each_step = True (the MMDR frame pick is redrawn
    every step instead of per episode);
  * horizon 2000 (twice the training episode budget);
  * a get_image_interval > 1 training env evals as the frame_extract
    equivalent (and interval 1 + extract 1 becomes frame_extract 4);
  * curriculum / interpolation / fixed_delay_observation off.

The train env's obs normalizer serves the eval env, as in the reference
(`eval_env._obs_normalizer = env._obs_normalizer`).

Usage (the reference's CLI):
  python -m vision4leg_torch.starter.ppo_nature_cnn_sim2sim \
      --config config/rl/static/frame_extract4_random_delay/thin-goal.json \
      --num_envs 1024 --seed 0 --log_dir ./log --id nature_sim2sim
"""
from vision4leg_torch.starter.common import run_experiment
from vision4leg_torch.starter.ppo_nature_cnn import build_module


def sim2sim_eval_params(env_params):
  """The reference's eval-env mutation (ppo_nature_cnn_sim2sim.py:43-56),
  in place; returns env_params."""
  build = env_params["env_build"]
  build["reset_frame_idx_each_step"] = True
  env_params["horizon"] = 2000
  if build.get("get_image_interval", 1) > 1:
    build["frame_extract"] = build["get_image_interval"]
    build["get_image_interval"] = 1
  elif (build.get("get_image_interval", 1) == 1
        and build.get("frame_extract", 1) == 1):
    build["frame_extract"] = 4
  for key in ("curriculum", "interpolation", "fixed_delay_observation"):
    if key in build:
      build[key] = False
  return env_params


if __name__ == "__main__":
  run_experiment(build_module, eval_params_transform=sim2sim_eval_params)
