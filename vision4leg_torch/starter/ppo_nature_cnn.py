"""Nature-CNN baseline PPO on A1MoveGround and A1MoveGroundMPC, on the
card (torch mirror of starter/ppo_nature_cnn.py; reference
starter/ppo_nature_cnn.py:81-100): a shared NatureFuseEncoder (the Nature
CNN on the 4 depth frames, projected, beside a proprio MLP) with separate
MLP heads.

Usage (the reference's CLI):
  python -m vision4leg_torch.starter.ppo_nature_cnn \
      --config config/rl/static/naive_baseline/thin-goal.json \
      --num_envs 1024 --seed 0 --log_dir ./log --id nature_naive
  (or the MMDR configs config/rl/static/frame_extract4*/ and
  config/rl/moving/{naive_baseline,frame_extract4*}/ on thin-goal, thin,
  thin-wide and thin-heightfield, config/mpc/baseline/, or
  config/rl/challenge/baseline/)
"""
from vision4leg_torch.models.actor_critic import NatureFuseActorCritic
from vision4leg_torch.starter.common import nature_kwargs, run_experiment


def build_module(env, params):
  """The actor-critic of a JSON config."""
  return NatureFuseActorCritic(**nature_kwargs(env, params))


if __name__ == "__main__":
  run_experiment(build_module)
