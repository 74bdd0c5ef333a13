"""Replay a trained LocoTransformer snapshot on the card (torch mirror of
starter/locotransformer_viewer.py; reference starter/
locotransformer_viewer.py:70-120): params.json + obs normalizer +
model_pf snapshot (the port's .pt or the JAX package's .flax), the policy
rebuilt, rolled deterministically; see viewer_common for the flags.

  python -m vision4leg_torch.starter.locotransformer_viewer \
      --config <run>/params.json --log_dir <dir> --id <id> --seed 0 \
      [--snap best] [--episodes 2] [--video out.mp4] [--device cpu]
"""
from vision4leg_torch.starter.viewer_common import run_viewer


def build_module_for_config(env, params, config_path):
  """The actor-critic of the starter that produced the run: the
  state-only one without a camera, else the LocoTransformer (kept for
  total_randomize_statistics, which sweeps runs of both)."""
  del config_path
  if not env.cfg.get_image:
    from vision4leg_torch.starter.ppo_state import build_module
  else:
    from vision4leg_torch.starter.ppo_locotransformer import build_module
  return build_module(env, params)


def _build_module(env, params):
  return build_module_for_config(env, params, None)


if __name__ == "__main__":
  run_viewer(_build_module)
