"""LocoTransformer PPO on A1MoveGround and A1MoveGroundMPC, on the card
(torch mirror of starter/ppo_locotransformer.py; reference
starter/ppo_locotransformer.py:27-121).

Usage (the reference's CLI):
  python -m vision4leg_torch.starter.ppo_locotransformer \
      --config config/rl/static/locotransformer/thin-goal.json \
      --num_envs 1024 --seed 0 --log_dir ./log --id thin_goal
  (or --config config/mpc/locotransformer/thin-goal.json / thin.json, the
  thin-heightfield configs, or config/rl/challenge/locotransformer/
  mountain.json, hill.json, stairs.json, chair_desk*.json)
"""
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
from vision4leg_torch.starter.common import (locotransformer_kwargs,
                                             run_experiment)


def build_module(env, params):
  """The actor-critic of a JSON config."""
  return LocoTransformerActorCritic(**locotransformer_kwargs(env, params))


if __name__ == "__main__":
  run_experiment(build_module)
