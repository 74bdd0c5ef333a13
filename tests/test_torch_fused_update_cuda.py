"""The PPO update with the fused layer's kernels (forward and backward)
against the unfused update, on the card (skipped without one: run
`python -m pytest --noconftest tests/test_torch_fused_update_cuda.py` on
the card).

From one seeded state, four PPO minibatches with fused_update on and
four with it off (`chip_smoke.fused_update_check`, which phase 11 of
chip_smoke.py runs too): the LocoTransformer at full width on B = 1024
observations of a short thin-goal rollout, and the MPC config's model on
B = 512 of an MPC rollout.  The parameters must stay within the float32
ReLU-kink band that tests/test_torch_ppo.py documents (1.5e-4 after four
minibatches): the kernels' forward runs in 3xTF32 and may put an FFN
pre-activation within ~1e-7 of zero on the other side of the ReLU than
the plain layer does.  A larger difference is a fault of the kernels.
"""
import pytest
import torch

import chip_smoke

CASES = {"thin-goal": (chip_smoke.CONFIG, 1024),
         "mpc": (chip_smoke.MPC_CONFIG, 512)}


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_update_matches_unfused_on_the_card(cuda, case):
  from vision4leg_torch.collector import rollout as rollout_lib
  config, B = CASES[case]
  env, meta, net, params = chip_smoke.build_main_path(cuda, config)
  rollout = rollout_lib.make_rollout_fn(
      env, net.pi_v, net.v, horizon=4, max_episode_frames=999,
      discount=0.99, proprio_dim=env.cfg.proprio_dim,
      obs_norm=meta["obs_norm"], action_low=env.action_low,
      action_high=env.action_high)
  cs = rollout_lib.init_collector(
      env, B, torch.Generator(device=cuda).manual_seed(0))
  _, traj, _ = rollout(cs)
  diff, moved, _ = chip_smoke.fused_update_check(net, traj.obs, params)
  assert moved > 1e-5              # the update moved the parameters
  assert diff <= chip_smoke.FUSED_UPDATE_BAND, (diff, moved)
