"""Fused LocoTransformer encoder layer: wrapper of the CUDA kernel
`ops/csrc/transformer_layer.cu` (torch counterpart of
vision4leg_tpu.ops.attention).

`fused_transformer_layer(x, w)` launches the hand-written kernel on CUDA
tensors or raises; on CPU tensors it runs the plain PyTorch version
`layer_math` (the same math as the JAX package's `_layer_math`).
`fused_transformer_layer_ad` makes it differentiable as the JAX package
does: the forward is the kernel, the backward recomputes `layer_math`
under autograd (the JAX package has no backward kernel either).  The
kernel is built with nvcc at first use (`ops/nvcc.py`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from vision4leg_torch.ops import nvcc

# shapes the kernel takes: one sample's layer in shared memory, at most
# 136 KB here (csrc tl_smem_floats), within the 227 KB a block may use
MAX_T, MAX_D, MAX_F = 32, 128, 512


class LayerWeights(NamedTuple):
  """The JAX package's layout: matrices are (in, out)."""
  wq: torch.Tensor   # (D, D)
  bq: torch.Tensor   # (D,)
  wk: torch.Tensor
  bk: torch.Tensor
  wv: torch.Tensor
  bv: torch.Tensor
  wo: torch.Tensor
  bo: torch.Tensor
  ln1_scale: torch.Tensor  # (D,)
  ln1_bias: torch.Tensor
  w1: torch.Tensor   # (D, F)
  b1: torch.Tensor   # (F,)
  w2: torch.Tensor   # (F, D)
  b2: torch.Tensor   # (D,)
  ln2_scale: torch.Tensor
  ln2_bias: torch.Tensor


def layer_norm(x, scale, bias, eps: float = 1e-6):
  """Mean first, then the mean of the squared deviations (attention.py
  `_layer_norm`)."""
  mu = torch.mean(x, dim=-1, keepdim=True)
  var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
  return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def layer_math(x, w: LayerWeights):
  """The plain version: (B, T, D) -> (B, T, D), the math of the JAX
  package's `_layer_math`."""
  B, T, D = x.shape
  flat = x.reshape(B * T, D)
  q = (flat @ w.wq + w.bq).reshape(B, T, D)
  k = (flat @ w.wk + w.bk).reshape(B, T, D)
  v = (flat @ w.wv + w.bv).reshape(B, T, D)
  scores = torch.bmm(q, k.transpose(1, 2)) / (D ** 0.5)
  attn = torch.softmax(scores, dim=-1)
  ctx = torch.bmm(attn, v)
  out = (ctx.reshape(B * T, D) @ w.wo + w.bo).reshape(B, T, D)
  y = layer_norm(x + out, w.ln1_scale, w.ln1_bias)
  h = torch.relu(y.reshape(B * T, D) @ w.w1 + w.b1)
  f = (h @ w.w2 + w.b2).reshape(B, T, D)
  return layer_norm(y + f, w.ln2_scale, w.ln2_bias)


def layer_cost(B: int, T: int, D: int, F: int) -> Tuple[int, int]:
  """(bytes, operations) the layer needs at least: x read and out written
  once, every weight read once; the FLOPs of its matrix products (QKV,
  scores, context, out-projection, the two FFN products)."""
  n_weights = 4 * D * D + 2 * D * F + 9 * D + F
  nbytes = 4 * (2 * B * T * D + n_weights)
  flops = B * (2 * T * D * D * 4 + 2 * 2 * T * T * D + 2 * 2 * T * D * F)
  return nbytes, flops


def layer_grad_cost(B: int, T: int, D: int, F: int) -> Tuple[int, int]:
  """(bytes, operations) of the layer's forward and backward together
  (`fused_transformer_layer_ad`): x, the output gradient and the weights
  read once, dx and the weight gradients written once; each matrix
  product once forward and twice backward (its two input gradients)."""
  nbytes, flops = layer_cost(B, T, D, F)
  n_weights = 4 * D * D + 2 * D * F + 9 * D + F
  return 4 * (3 * B * T * D + 2 * n_weights), 3 * flops


_LIB = {}


def build_library() -> ctypes.CDLL:
  """Compile the kernel (once per source+flags hash) and load it."""
  if "lib" not in _LIB:
    lib = nvcc.load("transformer_layer")
    fn = lib.transformer_layer_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB["lib"] = lib
  return _LIB["lib"]


def check_inputs(x, w: LayerWeights) -> Tuple[int, int, int, int]:
  """Raise on what the kernel does not take; returns (B, T, D, F)."""
  if x.dim() != 3:
    raise ValueError(f"transformer_layer: x must be (B, T, D), got "
                     f"{tuple(x.shape)}")
  B, T, D = x.shape
  F = w.w1.shape[-1]
  if not (B >= 1 and 1 <= T <= MAX_T and 1 <= D <= MAX_D
          and 1 <= F <= MAX_F):
    raise ValueError(f"transformer_layer: takes B >= 1, T <= {MAX_T}, "
                     f"D <= {MAX_D}, F <= {MAX_F}; got B={B} T={T} D={D} "
                     f"F={F}")
  shapes = dict(wq=(D, D), bq=(D,), wk=(D, D), bk=(D,), wv=(D, D), bv=(D,),
                wo=(D, D), bo=(D,), ln1_scale=(D,), ln1_bias=(D,),
                w1=(D, F), b1=(F,), w2=(F, D), b2=(D,), ln2_scale=(D,),
                ln2_bias=(D,))
  for name, t in [("x", x)] + list(zip(LayerWeights._fields, w)):
    if t.dtype != torch.float32:
      raise TypeError(f"transformer_layer: {name} must be float32, got "
                      f"{t.dtype}")
    if t.device != x.device:
      raise ValueError(f"transformer_layer: {name} on {t.device}, x on "
                       f"{x.device}")
    if not t.is_contiguous():
      raise ValueError(f"transformer_layer: {name} is not contiguous")
    if name != "x" and tuple(t.shape) != shapes[name]:
      raise ValueError(f"transformer_layer: {name} has shape "
                       f"{tuple(t.shape)}, expected {shapes[name]}")
  return B, T, D, F


def _launch(x, w: LayerWeights, launch=None):
  """Check, allocate the output and launch; `launch(*pointers_and_sizes)`
  defaults to the built kernel on the current CUDA stream."""
  B, T, D, F = check_inputs(x, w)
  if launch is None:
    fn = build_library().transformer_layer_launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = lambda *args: fn(*args, stream)
  out = torch.empty_like(x)
  err = launch(x.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in w],
               B, T, D, F)
  if err != 0:
    raise RuntimeError(f"transformer_layer_launch failed: cudaError {err}")
  fused_transformer_layer.launches += 1
  return out


def fused_transformer_layer(x, w: LayerWeights):
  """x: (B, T, D) float32 -> (B, T, D), the single-head post-norm layer.
  CUDA tensors: the kernel (or an error); CPU tensors: `layer_math`."""
  if x.device.type == "cuda":
    return _launch(x, w)
  if x.device.type != "cpu":
    raise ValueError(f"transformer_layer: unsupported device {x.device}")
  return layer_math(x, w)


fused_transformer_layer.launches = 0


class _FusedLayerAD(torch.autograd.Function):
  """Forward: the fused layer; backward: autograd of `layer_math`
  recomputed from the saved (x, w), as the JAX package's `_ad_bwd`."""

  @staticmethod
  def forward(ctx, x, *w):
    ctx.save_for_backward(x, *w)
    return fused_transformer_layer(x, LayerWeights(*w))

  @staticmethod
  def backward(ctx, g):
    saved = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(True) for t in saved]
    with torch.enable_grad():
      out = layer_math(inputs[0], LayerWeights(*inputs[1:]))
      return torch.autograd.grad(out, inputs, g)


def fused_transformer_layer_ad(x, w: LayerWeights):
  """Differentiable fused layer: kernel forward, plain-math backward."""
  return _FusedLayerAD.apply(x, *w)


def weights_from_layer(layer) -> LayerWeights:
  """LayerWeights of a `models.base.TransformerEncoderLayer` (torch Linear
  weights are (out, in): transposed into contiguous (in, out) copies,
  through which gradients flow back to the layer's parameters)."""
  wt = lambda lin: lin.weight.t().contiguous()
  return LayerWeights(
      wq=wt(layer.query), bq=layer.query.bias,
      wk=wt(layer.key), bk=layer.key.bias,
      wv=wt(layer.value), bv=layer.value.bias,
      wo=wt(layer.out), bo=layer.out.bias,
      ln1_scale=layer.norm1.weight, ln1_bias=layer.norm1.bias,
      w1=wt(layer.ff1), b1=layer.ff1.bias,
      w2=wt(layer.ff2), b2=layer.ff2.bias,
      ln2_scale=layer.norm2.weight, ln2_bias=layer.norm2.bias)
