"""The port's multi-rank dry run (counterpart of `__graft_entry__.py`
`dryrun_multichip`): the flagship workload (LocoTransformer policy, depth
raycaster and image ring on random_blocks_sparse) at tiny widths, one PPO
epoch (collection, GAE, minibatch updates) with the env axis sharded over
`n` gloo ranks on the CPU, 2 envs a rank; rank 0 prints the policy loss,
which must be finite.  The widths and settings are the JAX dry run's
(`__graft_entry__.py:89-100`).

  python -m vision4leg_torch.parallel.dryrun [n]      # n ranks, default 2
"""
from __future__ import annotations

import math
import sys
import tempfile
import warnings


from vision4leg_torch.algo.agent import PPOAgent
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.envs.env import A1GymEnv, EnvConfig
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
from vision4leg_torch.parallel import mesh as mesh_lib


def flagship_agent(mesh, num_envs: int, save_dir: str) -> PPOAgent:
  env = A1GymEnv(EnvConfig(
      motor_control_mode="POSITION", clip_num=(0.05, 0.5, 0.5) * 4,
      time_step_s=0.0025, num_action_repeat=4, add_last_action_input=True,
      no_displacement=True, diagonal_act=True, alive_reward=-0.05,
      terrain_type="random_blocks_sparse", settle_steps=20,
      get_image=True, depth_norm=True, frame_extract=1), device=mesh.device)
  module = LocoTransformerActorCritic(
      action_dim=6, state_input_shape=env.cfg.proprio_dim,
      visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32,),
      transformer_params=((1, 32),), append_hidden_shapes=(32,),
      token_dim=16)
  cfg = PPOConfig(plr=1e-4, vlr=1e-4, opt_epochs=1,
                  batch_size=num_envs * 2, epoch_frames=num_envs * 4,
                  max_episode_frames=8, num_epochs=2)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    return PPOAgent(env=env, ac_module=module, cfg=cfg, num_envs=num_envs,
                    seed=0, logger=None, save_dir=save_dir, obs_norm=True,
                    mesh=mesh, device=mesh.device)


def _dryrun_rank(mesh, num_envs: int, save_dir: str) -> float:
  agent = flagship_agent(mesh, num_envs, save_dir)
  metrics = agent.train_epoch()
  return float(metrics["Training/policy_loss"])


def dryrun_multichip(n_ranks: int = 2) -> float:
  """One PPO epoch over `n_ranks` gloo ranks; returns the policy loss."""
  with tempfile.TemporaryDirectory() as save_dir:
    losses = mesh_lib.run_ranks(_dryrun_rank, n_ranks,
                                (2 * n_ranks, save_dir), backend="gloo",
                                timeout_s=600, threads=1)
  if not all(l == losses[0] for l in losses):
    raise AssertionError(f"the ranks report different losses {losses}")
  if not math.isfinite(losses[0]):
    raise AssertionError(f"policy loss {losses[0]}")
  print(f"dryrun_multichip({n_ranks}): one PPO step OK, "
        f"policy_loss={losses[0]:.4f}")
  return losses[0]


if __name__ == "__main__":
  dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
