"""Replay a trained ppo_nature_cnn_vision_only snapshot on the card (torch mirror of
starter/nature_cnn_vision_only_viewer.py): the policy of vision4leg_torch.starter.
ppo_nature_cnn_vision_only rebuilt from params.json + obs normalizer + model_pf
snapshot (the port's .pt or the JAX package's .flax) and rolled
deterministically; see viewer_common for the flags."""
from vision4leg_torch.starter.ppo_nature_cnn_vision_only import build_module
from vision4leg_torch.starter.viewer_common import run_viewer

if __name__ == "__main__":
  run_viewer(build_module)
