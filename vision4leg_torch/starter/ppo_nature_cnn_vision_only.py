"""Vision-only Nature-CNN PPO, on the card (torch mirror of
starter/ppo_nature_cnn_vision_only.py): MLP heads over one shared Nature
CNN on the 4 depth frames; the proprio head of the observation is
ignored.

Usage (the reference's CLI):
  python -m vision4leg_torch.starter.ppo_nature_cnn_vision_only \
      --config config/mpc_vision_only/baseline/thin-goal.json \
      --num_envs 1024 --seed 0 --log_dir ./log --id nature_vision_only
  (or config/mpc_vision_only/baseline/thin.json / thin-wide.json)
"""
from vision4leg_torch.models.actor_critic import VisualNetActorCritic
from vision4leg_torch.starter.common import nature_kwargs, run_experiment


def build_module(env, params):
  """The vision-only actor-critic of a JSON config.  The encoder's
  hidden_shapes and visual_dim have no layer here: the reference's
  NatureEncoder swallows both unused."""
  kw = nature_kwargs(env, params)
  del kw["encoder_hidden_shapes"], kw["visual_dim"]
  return VisualNetActorCritic(**kw)


if __name__ == "__main__":
  run_experiment(build_module)
