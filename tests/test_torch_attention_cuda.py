"""The CUDA fused-transformer-layer kernel against its plain PyTorch
version, on the card (skipped without one: run
`python -m pytest --noconftest tests/test_torch_attention_cuda.py` on the
card).  Tolerances of tests/test_pallas.py: forward atol 2e-5 / rtol
1e-4, gradients atol 3e-5 / rtol 1e-4; TF32 off.  What the backward
kernel writes is held against `layer_backward_rows` on the residuals the
forward kernel wrote, so that both take the ReLU mask from the same h."""
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


# Tile edges of the forward kernel (tiles of G <= 8 samples, G = ceil(B /
# SMs)): B = 7, 8, 9 around G = 8, and, on a 132-SM card, 1023 (128 tiles,
# the last with 7 samples) and 1057 (G = 8 capped: 133 tiles, the last
# with one).  The training paths' other shapes: B = 512 (G = 4), and the
# vision-only model's T = 16 (128 rows a tile of 8, padded to 144).  The
# large attention instantiation (T > 32): the 16-channel LocoTransformer's
# T = 33 (tiles of G <= 4) at the rollout's, eval's and a ragged batch,
# and T = 48 at the largest D and F.
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,F", [(1024, 17, 64, 256), (1000, 17, 64, 256),
                                     (8, 17, 64, 256), (1, 17, 64, 256),
                                     (5, 32, 128, 512), (3, 7, 24, 40),
                                     (7, 17, 64, 256), (9, 17, 64, 256),
                                     (1023, 17, 64, 256),
                                     (1057, 17, 64, 256),
                                     (512, 17, 64, 256), (512, 16, 64, 256),
                                     (1024, 16, 64, 256), (8, 16, 64, 256),
                                     (1024, 33, 64, 256), (8, 33, 64, 256),
                                     (1001, 33, 64, 256),
                                     (7, 48, 128, 512)])
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
def test_saving_mode_same_bits_and_repeatable(cuda):
  """At the rollout shape: the saving forward's output has the inference
  forward's bits, and two calls of each give the same bits (no
  atomics)."""
  w = _weights(64, 256, cuda, seed=11)
  x = torch.randn(1024, 17, 64, device=cuda, generator=torch.Generator(
      device=cuda).manual_seed(11))
  with torch.no_grad():
    out = [att.fused_transformer_layer(x, w) for _ in range(2)]
    saved = [att.fused_layer_forward_saved(x, w) for _ in range(2)]
  torch.cuda.synchronize()
  assert torch.equal(out[0], out[1])
  assert torch.equal(saved[0][0], out[0])
  assert torch.equal(saved[1][0], out[0])
  assert all(torch.equal(a, b) for a, b in zip(saved[0][1], saved[1][1]))


@pytest.mark.cuda
def test_kernel_gradient_matches_plain(cuda):
  """End to end through both kernels, against autograd of the plain
  layer by `attention.compare_grads_with_plain`: within atol 3e-5 / rtol
  1e-4 of the float32 autograd, or within twice the plain layer's own
  float32 spread of the float64 autograd (a weight gradient sums 17,000
  products here)."""
  w = _weights(64, 256, cuda)
  x = torch.randn(1000, 17, 64, device=cuda)
  g = torch.randn_like(x)
  before = att.fused_transformer_layer_bwd.launches
  ok, report = att.compare_grads_with_plain(x, w, g)
  assert att.fused_transformer_layer_bwd.launches == before + 1
  assert ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1024, 8])
def test_kernel_gradient_matches_plain_at_33_tokens(cuda, B):
  """As above at the 16-channel LocoTransformer's T = 33 (the forward's
  large attention instantiation), at the update's and eval's batch."""
  w = _weights(64, 256, cuda, seed=33)
  gen = torch.Generator(device=cuda).manual_seed(33)
  x = torch.randn(B, 33, 64, device=cuda, generator=gen)
  g = torch.randn(B, 33, 64, device=cuda, generator=gen)
  before = att.fused_transformer_layer_bwd.launches
  ok, report = att.compare_grads_with_plain(x, w, g)
  assert att.fused_transformer_layer_bwd.launches == before + 1
  assert ok, report


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
  w = _weights(64, 256, cuda)
  with pytest.raises(ValueError, match="T <= 48"):
    att.fused_transformer_layer(torch.zeros(2, 49, 64, device=cuda), w)
  with pytest.raises(TypeError, match="float32"):
    att.fused_transformer_layer(torch.zeros(2, 17, 64, device=cuda,
                                            dtype=torch.float64), w)
  with pytest.raises(ValueError, match="x on"):
    att.fused_transformer_layer(torch.zeros(2, 17, 64, device=cuda),
                                w._replace(wq=w.wq.cpu()))


BWD_SHAPES = [(1024, 17, 64, 256), (1000, 17, 64, 256), (8, 17, 64, 256),
              (1, 17, 64, 256), (5, 32, 128, 512), (3, 7, 24, 40),
              (512, 17, 64, 256), (512, 16, 64, 256), (1024, 16, 64, 256),
              (8, 16, 64, 256), (1024, 33, 64, 256), (8, 33, 64, 256),
              (5, 40, 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,F", BWD_SHAPES)
def test_backward_kernel_matches_plain(cuda, B, T, D, F):
  w = _weights(D, F, cuda, seed=B + 1)
  gen = torch.Generator(device=cuda).manual_seed(B + 1)
  x = torch.randn(B, T, D, device=cuda, generator=gen)
  g = torch.randn(B, T, D, device=cuda, generator=gen)
  before = (att.fused_transformer_layer.launches,
            att.fused_transformer_layer_bwd.launches)
  out, res = att.fused_layer_forward_saved(x, w)
  got = att.fused_transformer_layer_bwd(res, g, w)
  torch.cuda.synchronize()
  assert (att.fused_transformer_layer.launches,
          att.fused_transformer_layer_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
  rows = att.fused_layer_backward_rows(res, g, w)
  # the saving mode leaves the inference output as it was, bit for bit
  assert torch.equal(out, att.fused_transformer_layer(x, w))
  ref_out, ref_res = att.layer_forward_saved(x, w)
  torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=1e-4)
  for name, a, b in zip(att.Residuals._fields, res, ref_res):
    torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4, msg=name)
  want = att.layer_backward_rows(res, g, w)
  for name, a, b in zip(att.BackwardRows._fields, rows, want):
    torch.testing.assert_close(a, b, atol=3e-5, rtol=1e-4, msg=name)
  grads = att.weight_grads(res, rows)
  assert all(torch.equal(a, b) for a, b in zip(got, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1000, 1024])
def test_backward_key_bias_sum_is_exact(cuda, B):
  """The backward kernel's key-bias sums (csrc tlb_phase 12: from the
  softmax's shift invariance, the row sums of P in double) against the
  float64 sums of dk's rows computed from the kernel's own residuals.
  Summed from dk's float32 rows, they were rounding noise up to 3.9e-05
  from the float64 autograd at B = 1000 on a card, more than twice the
  plain layer's float32 spread (chip_smoke.py phase 5)."""
  w = _weights(64, 256, cuda, seed=B + 2)
  gen = torch.Generator(device=cuda).manual_seed(B + 2)
  x = torch.randn(B, 17, 64, device=cuda, generator=gen)
  g = torch.randn(B, 17, 64, device=cuda, generator=gen)
  _, res = att.fused_layer_forward_saved(x, w)
  rows = att.fused_layer_backward_rows(res, g, w)
  torch.cuda.synchronize()
  d = lambda t: t.double()
  rows64 = att.layer_backward_rows(att.Residuals(*map(d, res)), d(g),
                                   att.LayerWeights(*map(d, w)))
  ref = rows64.dqkv[..., 64:128].sum(1)
  torch.testing.assert_close(rows.sums[:, 64:128].double(), ref, atol=1e-9,
                             rtol=0)


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(cuda):
  w = _weights(64, 256, cuda, seed=5)
  gen = torch.Generator(device=cuda).manual_seed(5)
  x = torch.randn(1024, 17, 64, device=cuda, generator=gen)
  g = torch.randn(1024, 17, 64, device=cuda, generator=gen)
  grads = []
  for _ in range(2):
    xi = x.clone().requires_grad_(True)
    wi = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
    grads.append(torch.autograd.grad(att.fused_transformer_layer_ad(xi, wi),
                                     [xi, *wi], g))
  assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_backward_rejects_bad_inputs(cuda):
  w = _weights(64, 256, cuda)
  x = torch.randn(4, 17, 64, device=cuda)
  _, res = att.fused_layer_forward_saved(x, w)
  with pytest.raises(ValueError, match="g must be"):
    att.fused_transformer_layer_bwd(res, torch.zeros(4, 17, 64), w)
  with pytest.raises(ValueError, match="residual"):
    att.fused_transformer_layer_bwd(res._replace(p=res.p.clone()),
                                    torch.zeros_like(x), w)
