"""Vision-only LocoTransformer PPO, on the card (torch mirror of
starter/ppo_locotransformer_vision_only.py): the transformer runs over the
depth tokens alone and the proprio head of the observation is ignored.

Usage (the reference's CLI):
  python -m vision4leg_torch.starter.ppo_locotransformer_vision_only \
      --config config/mpc_vision_only/locotransformer/thin-goal.json \
      --num_envs 1024 --seed 0 --log_dir ./log --id vision_only
  (or --config config/mpc_vision_only/locotransformer/thin.json)
"""
from vision4leg_torch.models.actor_critic import \
    VisionOnlyTransformerActorCritic
from vision4leg_torch.starter.common import (locotransformer_kwargs,
                                             run_experiment)


def build_module(env, params):
  """The vision-only actor-critic of a JSON config."""
  return VisionOnlyTransformerActorCritic(
      **locotransformer_kwargs(env, params))


if __name__ == "__main__":
  run_experiment(build_module)
