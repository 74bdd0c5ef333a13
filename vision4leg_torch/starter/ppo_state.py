"""Proprio-only PPO on A1MoveGround, on the card (torch mirror of
starter/ppo_state.py; reference starter/ppo_state.py:93-104): one MLP
base shared by the policy and the value under separate MLP heads.

Usage (the reference's CLI):
  python -m vision4leg_torch.starter.ppo_state \
      --config config/rl/static/state-only-baseline.json \
      --num_envs 1024 --seed 0 --log_dir ./log --id state_baseline
"""
from vision4leg_torch.models.actor_critic import StateActorCritic
from vision4leg_torch.starter.common import run_experiment


def build_module(env, params):
  """The actor-critic of a JSON config (`net.hidden_shapes`,
  `net.append_hidden_shapes` and the `policy` kwargs)."""
  net = params.get("net", {})
  return StateActorCritic(
      action_dim=env.cfg.action_dim, state_input_shape=env.obs_dim,
      hidden_shapes=tuple(net.get("hidden_shapes", (256, 256))),
      append_hidden_shapes=tuple(net.get("append_hidden_shapes",
                                         (256, 256))),
      **params.get("policy", {}))


if __name__ == "__main__":
  run_experiment(build_module)
