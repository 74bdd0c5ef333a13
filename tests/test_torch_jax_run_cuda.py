"""A policy the JAX package trained (runs/mmdr_moving_10M), read without
JAX and converted, on the card: its `pi_v` with the fused layer (the
forward kernel, four launches) against its plain `pi_v` on the same
observations (skipped without a card: run
`python -m pytest --noconftest tests/test_torch_jax_run_cuda.py` on the
card).  The observations are made from a seed: the proprio head normal
around the run's normalizer mean, the depth frames uniform in [0, 1].
Tolerance: the layer's (tests/test_pallas.py's forward 2e-5 / 1e-4)
through two layers and the MLP heads, 1e-4 / 1e-4; TF32 off."""
import os.path as osp

import numpy as np
import pytest
import torch

from vision4leg_torch.data import normalizer as norm
from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.ops import attention as att
from vision4leg_torch.starter import ppo_locotransformer
from vision4leg_torch.starter.viewer_common import build_policy
from vision4leg_torch.utils import flax_msgpack
from vision4leg_torch.utils.args import get_params

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RUN = osp.join(ROOT, "runs", "mmdr_moving_10M", "A1MoveGround", "0")


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


@pytest.mark.cuda
def test_converted_pi_v_fused_matches_plain(cuda):
  params = get_params(osp.join(RUN, "params.json"))
  env, _ = get_env(params["env_name"], params["env"], device=cuda)
  sd, nstate = flax_msgpack.load_jax_run(RUN, device=cuda)
  net = build_policy(env, params, ppo_locotransformer.build_module, sd)
  rng = np.random.default_rng(0)
  p = env.cfg.proprio_dim
  raw = rng.uniform(0.0, 1.0, (256, env.obs_dim)).astype(np.float32)
  raw[:, :p] = nstate.mean.cpu().numpy() + rng.normal(size=(256, p)) * \
      np.sqrt(nstate.var.cpu().numpy())
  obs = norm.filt_with_img_tail(nstate, torch.tensor(raw, device=cuda), p)
  before = att.fused_transformer_layer.launches
  with torch.no_grad():
    (m_f, _, _), v_f = net.pi_v(obs, fused=True)
    (m_p, _, _), v_p = net.pi_v(obs, fused=False)
  assert att.fused_transformer_layer.launches == before + 4
  torch.testing.assert_close(m_f, m_p, atol=1e-4, rtol=1e-4)
  torch.testing.assert_close(v_f, v_p, atol=1e-4, rtol=1e-4)
