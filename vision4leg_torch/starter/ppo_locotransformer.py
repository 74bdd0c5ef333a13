"""LocoTransformer PPO on A1MoveGround, on the card (torch mirror of
starter/ppo_locotransformer.py; reference starter/ppo_locotransformer.py:
27-121).

Usage (the reference's CLI):
  python -m vision4leg_torch.starter.ppo_locotransformer \
      --config config/rl/static/locotransformer/thin-goal.json \
      --num_envs 1024 --seed 0 --log_dir ./log --id thin_goal
"""
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
from vision4leg_torch.starter.common import run_experiment


def build_module(env, params):
  """The actor-critic of a JSON config (4 depth frames; rgbd is rejected
  by the env)."""
  enc = params.get("encoder", {})
  net = params.get("net", {})
  return LocoTransformerActorCritic(
      action_dim=env.cfg.action_dim,
      state_input_shape=env.cfg.proprio_dim,
      visual_input_shape=(4, 64, 64),
      encoder_hidden_shapes=tuple(enc.get("hidden_shapes", (256, 256))),
      transformer_params=tuple(
          tuple(p) for p in net.get("transformer_params",
                                    ((1, 256), (1, 256)))),
      append_hidden_shapes=tuple(net.get("append_hidden_shapes",
                                         (256, 256))),
      max_pool=net.get("max_pool", False),
      **params.get("policy", {}),
  )


if __name__ == "__main__":
  run_experiment(build_module)
