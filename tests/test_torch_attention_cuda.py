"""The CUDA fused-transformer-layer kernel against its plain PyTorch
version, on the card (skipped without one: run
`python -m pytest --noconftest tests/test_torch_attention_cuda.py` on the
card).  Tolerances of tests/test_pallas.py: forward atol 2e-5 / rtol
1e-4, gradients atol 3e-5 / rtol 1e-4; TF32 off."""
import numpy as np
import pytest
import torch

from vision4leg_torch.ops import attention as att


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def _weights(D, F, dev, seed=0):
  rng = np.random.default_rng(seed)
  out = []
  for name in att.LayerWeights._fields:
    shape = dict(wq=(D, D), wk=(D, D), wv=(D, D), wo=(D, D), w1=(D, F),
                 w2=(F, D), b1=(F,)).get(name, (D,))
    if len(shape) == 2:
      x = rng.normal(0, 1 / np.sqrt(shape[0]), shape)
    elif "scale" in name:
      x = 1 + 0.1 * rng.normal(size=shape)
    else:
      x = 0.1 * rng.normal(size=shape)
    out.append(torch.tensor(x, dtype=torch.float32, device=dev))
  return att.LayerWeights(*out)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,F", [(1024, 17, 64, 256), (1000, 17, 64, 256),
                                     (8, 17, 64, 256), (1, 17, 64, 256),
                                     (5, 32, 128, 512), (3, 7, 24, 40)])
def test_kernel_matches_plain(cuda, B, T, D, F):
  w = _weights(D, F, cuda, seed=B)
  x = torch.randn(B, T, D, device=cuda, generator=torch.Generator(
      device=cuda).manual_seed(B))
  before = att.fused_transformer_layer.launches
  got = att.fused_transformer_layer(x, w)
  torch.cuda.synchronize()
  assert att.fused_transformer_layer.launches == before + 1
  torch.testing.assert_close(got, att.layer_math(x, w), atol=2e-5,
                             rtol=1e-4)


@pytest.mark.cuda
def test_kernel_gradient_matches_plain(cuda):
  w = _weights(64, 256, cuda)
  x = torch.randn(1000, 17, 64, device=cuda)
  g = torch.randn_like(x)
  xa = x.clone().requires_grad_(True)
  wa = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
  (att.fused_transformer_layer_ad(xa, wa) * g).sum().backward()
  xp = x.clone().requires_grad_(True)
  wp = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
  (att.layer_math(xp, wp) * g).sum().backward()
  torch.testing.assert_close(xa.grad, xp.grad, atol=3e-5, rtol=1e-4)
  for a, b in zip(wa, wp):
    torch.testing.assert_close(a.grad, b.grad, atol=3e-5, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
  w = _weights(64, 256, cuda)
  with pytest.raises(ValueError, match="T <= 32"):
    att.fused_transformer_layer(torch.zeros(2, 33, 64, device=cuda), w)
  with pytest.raises(TypeError, match="float32"):
    att.fused_transformer_layer(torch.zeros(2, 17, 64, device=cuda,
                                            dtype=torch.float64), w)
  with pytest.raises(ValueError, match="x on"):
    att.fused_transformer_layer(torch.zeros(2, 17, 64, device=cuda),
                                w._replace(wq=w.wq.cpu()))
