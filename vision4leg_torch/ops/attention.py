"""Fused LocoTransformer encoder layer: wrapper of the CUDA kernel
`ops/csrc/transformer_layer.cu` (torch counterpart of
vision4leg_tpu.ops.attention).

`fused_transformer_layer(x, w)` launches the hand-written kernel on CUDA
tensors or raises; on CPU tensors it runs the plain PyTorch version
`layer_math` (the same math as the JAX package's `_layer_math`).
`fused_transformer_layer_ad` makes it differentiable, with the gradient
of the JAX package's `_ad_bwd`: on CUDA tensors its forward is the same
kernel writing the residuals of the layer to device memory
(`fused_layer_forward_saved`), and its backward a second kernel of the
same source that computes the row gradients from them
(`fused_transformer_layer_bwd`), the weight gradients being large plain
matrix products left to torch.matmul.  On CPU tensors the two are their
plain versions, `layer_forward_saved` and `layer_backward_math` (the
hand-derived backward written with torch ops).  The kernels are built
with nvcc at first use (`ops/nvcc.py`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from vision4leg_torch.ops import nvcc

# shapes the kernels take, within the 227 KB of shared memory a block may
# use: the forward holds a tile of G samples and two weight panels (208.5
# KB at T = 17 or 33, D = 64 with G = 8 or 4; G = 1 at the largest shape,
# 176 KB: csrc tl_plan), the backward one sample (`bwd_smem_bytes`, which
# `check_grad_inputs` holds to SMEM_MAX: 94.8 KB at T = 33, D = 64, F =
# 256).  T <= 32 runs the forward's small attention instantiation, T <= 48
# its large one (csrc TL_ATTN_SMALL, TL_ATTN_LARGE)
MAX_T, MAX_D, MAX_F = 48, 128, 512
SMEM_MAX = 232448


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


class Residuals(NamedTuple):
  """What the backward needs of one forward: the input and the layer's
  intermediates.  On the card the fields after x are views of one buffer,
  in this order, as the kernel writes them (csrc R_* and tl_res)."""
  x: torch.Tensor       # (B, T, D) the layer's input
  q: torch.Tensor       # (B, T, D)
  k: torch.Tensor
  v: torch.Tensor
  ctx: torch.Tensor     # softmax(q k^T / sqrt(D)) v
  xhat1: torch.Tensor   # LN1's normalized x + ctx Wo + bo
  y: torch.Tensor       # LN1's output
  xhat2: torch.Tensor   # LN2's normalized y + h W2 + b2
  h: torch.Tensor       # (B, T, F) relu(y W1 + b1); h > 0 is the mask
  p: torch.Tensor       # (B, T, T) the softmax
  rstd1: torch.Tensor   # (B, T) LN1's 1 / sqrt(var + eps)
  rstd2: torch.Tensor


def residual_shapes(B: int, T: int, D: int, F: int):
  """Shapes of the residual fields after x, in the buffer's order."""
  return [(B, T, D)] * 7 + [(B, T, F), (B, T, T), (B, T), (B, T)]


@functools.lru_cache(maxsize=None)
def _residual_layout(B: int, T: int, D: int, F: int):
  """(floats, ((shape, stride, offset), ...)) of the residual fields in
  one buffer, in its order: the saving forward builds the fields'
  views with one as_strided each, a host cost that a call pays."""
  fields, off = [], 0
  for s in residual_shapes(B, T, D, F):
    fields.append((s, tuple(math.prod(s[i + 1:]) for i in range(len(s))),
                   off))
    off += math.prod(s)
  return off, tuple(fields)


def _normalize(z, eps: float = 1e-6):
  """LayerNorm before its scale and bias, the mean first and then the mean
  of the squared deviations (attention.py `_layer_norm`): (x̂, 1 /
  sqrt(var + eps)) of each row."""
  mu = torch.mean(z, dim=-1, keepdim=True)
  rstd = torch.rsqrt(torch.mean((z - mu) ** 2, dim=-1, keepdim=True) + eps)
  return (z - mu) * rstd, rstd[..., 0]


def layer_forward_saved(x, w: LayerWeights, relu_mask=None):
  """The plain version of the layer's forward with its residuals: (out,
  Residuals) for x (B, T, D), the math of the JAX package's
  `_layer_math`.  relu_mask (B, T, F) bool, where given, replaces the
  FFN's ReLU by that fixed mask (`compare_grads_with_plain`)."""
  B, T, D = x.shape
  flat = x.reshape(B * T, D)
  q = (flat @ w.wq + w.bq).reshape(B, T, D)
  k = (flat @ w.wk + w.bk).reshape(B, T, D)
  v = (flat @ w.wv + w.bv).reshape(B, T, D)
  scores = torch.bmm(q, k.transpose(1, 2)) / (D ** 0.5)
  attn = torch.softmax(scores, dim=-1)
  ctx = torch.bmm(attn, v)
  out = (ctx.reshape(B * T, D) @ w.wo + w.bo).reshape(B, T, D)
  xhat1, rstd1 = _normalize(x + out)
  y = xhat1 * w.ln1_scale + w.ln1_bias
  pre = y.reshape(B * T, D) @ w.w1 + w.b1
  h = (torch.relu(pre) if relu_mask is None
       else pre * relu_mask.reshape(pre.shape).to(pre.dtype))
  f = (h @ w.w2 + w.b2).reshape(B, T, D)
  xhat2, rstd2 = _normalize(y + f)
  return xhat2 * w.ln2_scale + w.ln2_bias, Residuals(
      x=x, q=q, k=k, v=v, ctx=ctx, xhat1=xhat1, y=y, xhat2=xhat2,
      h=h.reshape(B, T, -1), p=attn, rstd1=rstd1, rstd2=rstd2)


def layer_math(x, w: LayerWeights, relu_mask=None):
  """The plain version: (B, T, D) -> (B, T, D), the math of the JAX
  package's `_layer_math` (relu_mask: `layer_forward_saved`)."""
  return layer_forward_saved(x, w, relu_mask)[0]


def _ln_backward(d, xhat, rstd, scale):
  """Gradient of LayerNorm's input from that of its output d."""
  ds = d * scale
  return rstd[..., None] * (ds - ds.mean(-1, keepdim=True)
                            - xhat * (ds * xhat).mean(-1, keepdim=True))


class BackwardRows(NamedTuple):
  """What the backward kernel computes: the gradients of the layer's rows
  and, per sample, the column sums over its T rows that the bias and
  LayerNorm gradients need."""
  dx: torch.Tensor      # (B, T, D)
  dqkv: torch.Tensor    # (B, T, 3 D): dq | dk | dv
  dr1: torch.Tensor     # (B, T, D) gradient of x + ctx Wo + bo
  dh: torch.Tensor      # (B, T, F) gradient of y W1 + b1
  dz2: torch.Tensor     # (B, T, D) gradient of y + h W2 + b2
  sums: torch.Tensor    # (B, 9 D + F): bq bk bv bo ln1s ln1b b1 b2 ln2s ln2b


def layer_backward_rows(res: Residuals, g, w: LayerWeights) -> BackwardRows:
  """The plain version of the backward kernel: BackwardRows of
  sum(layer_math(x, w) * g) from one forward's residuals, by the
  hand-derived formulas the kernel computes (csrc tlb_phase)."""
  D = g.shape[-1]
  dz2 = _ln_backward(g, res.xhat2, res.rstd2, w.ln2_scale)
  dh = (dz2 @ w.w2.t()) * (res.h > 0)
  dy = dz2 + dh @ w.w1.t()
  dr1 = _ln_backward(dy, res.xhat1, res.rstd1, w.ln1_scale)
  dctx = dr1 @ w.wo.t()
  dp = dctx @ res.v.transpose(1, 2)
  dv = res.p.transpose(1, 2) @ dctx
  c = (dp * res.p).sum(-1, keepdim=True)
  ds = res.p * (dp - c) / (D ** 0.5)
  dq = ds @ res.k
  dk = ds.transpose(1, 2) @ res.q
  dx = dr1 + dq @ w.wq.t() + dk @ w.wk.t() + dv @ w.wv.t()
  # bk's sum over dk's rows: sum_u q[u] rowsum(ds)[u], and ds's row sums
  # are c (1 - rowsum(p)) / sqrt(D) (softmax is unchanged by a shift
  # along the keys); 1 - rowsum(p), of the order of p's rounding, taken
  # in float64, far below it (csrc tlb_phase 12)
  gap = (1 - res.p.double().sum(-1, keepdim=True)).to(res.p.dtype)
  dbk = (res.q * (c * gap)).sum(1) / (D ** 0.5)
  sums = torch.cat([dq.sum(1), dbk] + [t.sum(1) for t in (
      dv, dr1, dy * res.xhat1, dy, dh, dz2, g * res.xhat2, g)], -1)
  return BackwardRows(dx=dx, dqkv=torch.cat([dq, dk, dv], -1), dr1=dr1,
                      dh=dh, dz2=dz2, sums=sums)


def weight_grads(res: Residuals, rows: BackwardRows):
  """(dx, *dw) in LayerWeights' order from the backward's rows: the
  weight gradients as products over all B * T rows (x^T dq, ..., h^T dz2),
  the bias and LayerNorm gradients as one sum of the per-sample sums
  over the samples; no float atomics."""
  B, T, D = res.x.shape
  F = res.h.shape[-1]
  flat = lambda t: t.reshape(B * T, -1)
  dwq, dwk, dwv = (flat(res.x).t() @ flat(rows.dqkv)).split(D, dim=1)
  dwo = flat(res.ctx).t() @ flat(rows.dr1)
  dw1 = flat(res.y).t() @ flat(rows.dh)
  dw2 = flat(res.h).t() @ flat(rows.dz2)
  (dbq, dbk, dbv, dbo, dln1s, dln1b, db1, db2, dln2s,
   dln2b) = rows.sums.sum(0).split([D] * 6 + [F] + [D] * 3)
  return (rows.dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dln1s, dln1b,
          dw1, db1, dw2, db2, dln2s, dln2b)


def layer_backward_math(res: Residuals, g, w: LayerWeights):
  """The plain version of the whole backward: the gradients (dx, *dw) of
  sum(layer_math(x, w) * g) from one forward's residuals."""
  return weight_grads(res, layer_backward_rows(res, g, w))


def layer_cost(B: int, T: int, D: int, F: int) -> Tuple[int, int]:
  """(bytes, operations) the layer needs at least: x read and out written
  once, every weight read once; the FLOPs of its matrix products (QKV,
  scores, context, out-projection, the two FFN products)."""
  n_weights = 4 * D * D + 2 * D * F + 9 * D + F
  nbytes = 4 * (2 * B * T * D + n_weights)
  flops = B * (2 * T * D * D * 4 + 2 * 2 * T * T * D + 2 * 2 * T * D * F)
  return nbytes, flops


def layer_saved_cost(B: int, T: int, D: int, F: int) -> Tuple[int, int]:
  """(bytes, operations) of the saving forward (`fused_layer_forward_saved`):
  `layer_cost` and the residuals written once."""
  nbytes, flops = layer_cost(B, T, D, F)
  return nbytes + 4 * sum(math.prod(s) for s in residual_shapes(
      B, T, D, F)), flops


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
  """Compile the kernels (once per source+flags hash) and load them."""
  if "lib" not in _LIB:
    lib = nvcc.load("transformer_layer")
    fn = lib.transformer_layer_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    fn = lib.transformer_layer_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.transformer_layer_tile_samples
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    _LIB["lib"] = lib
  return _LIB["lib"]


def tile_samples(B: int, T: int, D: int, F: int) -> int:
  """Samples of a tile of the forward kernel (G) at this shape on the
  current card (csrc tl_make_plan)."""
  G = build_library().transformer_layer_tile_samples(B, T, D, F)
  if G <= 0:
    raise RuntimeError(f"transformer_layer_tile_samples failed: cudaError "
                       f"{-G}")
  return G


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


def _launch(x, w: LayerWeights, launch=None, save: bool = False):
  """Check, allocate the output (and, with `save`, the residuals) and
  launch; `launch(*pointers_and_sizes)` defaults to the built kernel on
  the current CUDA stream.  Returns out, or (out, Residuals) with save."""
  B, T, D, F = check_inputs(x, w)
  if launch is None:
    fn = build_library().transformer_layer_launch
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = lambda *args: fn(*args, stream)
  out = torch.empty_like(x)
  res = None
  if save:
    floats, fields = _residual_layout(B, T, D, F)
    buf = torch.empty(floats, dtype=torch.float32, device=x.device)
    res = Residuals(x, *[buf.as_strided(s, st, o) for s, st, o in fields])
  err = launch(x.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in w],
               B, T, D, F, None if res is None else res.q.data_ptr())
  if err != 0:
    raise RuntimeError(f"transformer_layer_launch failed: cudaError {err}")
  fused_transformer_layer.launches += 1
  return out if res is None else (out, res)


def fused_transformer_layer(x, w: LayerWeights):
  """x: (B, T, D) float32 -> (B, T, D), the single-head post-norm layer.
  CUDA tensors: the kernel (or an error); CPU tensors: `layer_math`."""
  if x.device.type == "cuda":
    return _launch(x, w)
  if x.device.type != "cpu":
    raise ValueError(f"transformer_layer: unsupported device {x.device}")
  return layer_math(x, w)


fused_transformer_layer.launches = 0


def fused_layer_forward_saved(x, w: LayerWeights):
  """The layer's forward with its residuals: (out, Residuals).  CUDA
  tensors: the kernel in its saving mode (or an error); CPU tensors:
  `layer_forward_saved`."""
  if x.device.type == "cuda":
    return _launch(x, w, save=True)
  if x.device.type != "cpu":
    raise ValueError(f"transformer_layer: unsupported device {x.device}")
  return layer_forward_saved(x, w)


def bwd_smem_bytes(T: int, D: int, F: int) -> int:
  """Shared memory of one backward block (csrc tlb_smem_floats)."""
  return 4 * (6 * T * (D + 1) + 2 * T * (T + 1) + T * (F + 1) + 3 * T)


def check_grad_inputs(res: Residuals, g, w: LayerWeights):
  """Raise on what the backward kernel does not take; returns (B, T, D,
  F).  The residuals must be the saving forward's: views of one buffer at
  the kernel's offsets."""
  B, T, D, F = check_inputs(res.x, w)
  if bwd_smem_bytes(T, D, F) > SMEM_MAX:
    raise ValueError(f"transformer_layer_bwd: T={T} D={D} F={F} needs "
                     f"{bwd_smem_bytes(T, D, F)} bytes of shared memory, "
                     f"more than {SMEM_MAX}")
  if g.shape != res.x.shape or g.dtype != torch.float32 or \
     g.device != res.x.device or not g.is_contiguous():
    raise ValueError(f"transformer_layer_bwd: g must be a contiguous "
                     f"float32 {tuple(res.x.shape)} tensor on "
                     f"{res.x.device}, got {g.dtype} {tuple(g.shape)} on "
                     f"{g.device}")
  base, off = res.q.data_ptr(), 0
  for name, t, s in zip(Residuals._fields[1:], res[1:],
                        residual_shapes(B, T, D, F)):
    if (tuple(t.shape) != s or t.dtype != torch.float32
        or t.device != g.device or not t.is_contiguous()
        or t.data_ptr() != base + 4 * off):
      raise ValueError(f"transformer_layer_bwd: residual {name} is not "
                       f"the saving forward's")
    off += math.prod(s)
  return B, T, D, F


def _launch_bwd(res: Residuals, g, w: LayerWeights,
                launch=None) -> BackwardRows:
  """Check, allocate and launch the backward kernel; returns what it
  wrote.  `launch` as in `_launch`."""
  B, T, D, F = check_grad_inputs(res, g, w)
  if launch is None:
    fn = build_library().transformer_layer_bwd_launch
    stream = torch.cuda.current_stream(g.device).cuda_stream
    launch = lambda *args: fn(*args, stream)
  # (out, in) row-major: the transposed products read rows of these
  wt = [t.t().contiguous() for t in (w.wq, w.wk, w.wv, w.wo, w.w1, w.w2)]
  new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                    device=g.device)
  rows = BackwardRows(dx=new(B, T, D), dqkv=new(B, T, 3 * D),
                      dr1=new(B, T, D), dh=new(B, T, F), dz2=new(B, T, D),
                      sums=new(B, 9 * D + F))
  err = launch(g.data_ptr(), res.q.data_ptr(), *[t.data_ptr() for t in wt],
               w.ln1_scale.data_ptr(), w.ln2_scale.data_ptr(),
               *[t.data_ptr() for t in rows], B, T, D, F)
  if err != 0:
    raise RuntimeError(f"transformer_layer_bwd_launch failed: cudaError "
                       f"{err}")
  fused_transformer_layer_bwd.launches += 1
  return rows


def fused_layer_backward_rows(res: Residuals, g,
                              w: LayerWeights) -> BackwardRows:
  """The backward's rows from the residuals of `fused_layer_forward_saved`:
  CUDA tensors: the backward kernel (or an error); CPU tensors:
  `layer_backward_rows`."""
  dev = res.x.device
  if dev.type == "cuda":
    return _launch_bwd(res, g, w)
  if dev.type != "cpu":
    raise ValueError(f"transformer_layer_bwd: unsupported device {dev}")
  return layer_backward_rows(res, g, w)


def fused_transformer_layer_bwd(res: Residuals, g, w: LayerWeights):
  """Gradients (dx, *dw) of sum(out * g) from the residuals of
  `fused_layer_forward_saved`: `weight_grads` of
  `fused_layer_backward_rows`."""
  return weight_grads(res, fused_layer_backward_rows(res, g, w))


fused_transformer_layer_bwd.launches = 0


class _FusedLayerAD(torch.autograd.Function):
  """Forward: the layer, saving its residuals; backward:
  `fused_transformer_layer_bwd` on them (the gradient of the JAX
  package's `_ad_bwd`, with nothing recomputed).

  The backward carries no graph, so the layer is once-differentiable: a
  backward asked to build a graph (create_graph=True: a Hessian-vector
  product, TRPO's Fisher-vector product) raises, as forward-mode
  differentiation of the JAX custom_vjp layer does, instead of giving a
  second derivative that is silently wrong.  It raises there, at the
  first backward, rather than through torch's once_differentiable: that
  one errs only if the second backward runs its error node, and a second
  grad taken with allow_unused=True never does (it returns None, read as
  zero)."""

  @staticmethod
  def forward(ctx, x, *w):
    out, res = fused_layer_forward_saved(x, LayerWeights(*w))
    ctx.save_for_backward(*res, *w)
    return out

  @staticmethod
  def backward(ctx, g):
    if torch.is_grad_enabled():
      raise RuntimeError(
          "fused transformer layer: once-differentiable, no second "
          "derivative (its backward runs on saved residuals); take "
          "second derivatives through the unfused layer")
    saved = ctx.saved_tensors
    n = len(Residuals._fields)
    return fused_transformer_layer_bwd(
        Residuals(*saved[:n]), g.contiguous(), LayerWeights(*saved[n:]))


def fused_transformer_layer_ad(x, w: LayerWeights):
  """Differentiable fused layer: where a gradient is needed, the kernel
  forward saving residuals and the backward kernel on them; elsewhere
  (no_grad: collection, bootstraps, eval) the inference forward."""
  if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w)):
    return _FusedLayerAD.apply(x, *w)
  return fused_transformer_layer(x, w)


# tests/test_pallas.py's tolerance for the JAX fused layer's gradients
GRAD_TOL = dict(atol=3e-5, rtol=1e-4)
ROUNDING_SAMPLES = 8


def _grads(fn, x, w, g):
  """(dx, *dw) of sum(fn(x, w) * g) by autograd."""
  inputs = [x.detach().clone().requires_grad_(True)] + [
      t.detach().clone().requires_grad_(True) for t in w]
  out = fn(inputs[0], LayerWeights(*inputs[1:]))
  return torch.autograd.grad(out, inputs, g)


def ffn_preactivation(x, w: LayerWeights):
  """The FFN's pre-activations y W1 + b1 (B, T, F) of the plain layer."""
  with torch.no_grad():
    y = layer_forward_saved(x, w)[1].y
    return y @ w.w1 + w.b1


def compare_grads_with_plain(x, w: LayerWeights, g, run=None, saved=None,
                             relu=None):
  """Hold the gradients (dx, *dw) of sum(run(x, w) * g) (default run:
  `fused_transformer_layer_ad`) against autograd of `layer_math`.

  Per gradient tensor and element: within GRAD_TOL (atol + rtol |ref|) of
  the float32 autograd, or, where float32 itself cannot do better, within
  twice the tensor's float32 spread of the float64 autograd.  The spread
  s is the largest error of the plain layer's float32 autograd against
  its float64 autograd over the tensor, on the inputs and on
  ROUNDING_SAMPLES copies of x, w and g moved by one float32 rounding
  unit (relative 2**-24) at random: the rule of
  `physics_kernel.compare_with_plain`, per tensor where that one is per
  env.  Float32 parts from float32 there for two reasons: a weight
  gradient sums B * T products, so at B = 1024 two float32 computations
  of it part by ~1e-4 wherever the sum cancels to less than ~1, while
  their rows agree to ~1e-6; and an FFN pre-activation within ~1e-7 of
  zero can take the other side of the ReLU in two float32 forwards,
  which moves that sample's gradients, and every weight gradient, by
  O(0.1-1).  The nudged copies of the plain layer flip such kinks too.
  An element that passes only by the second term is counted as excused.

  A kink the nudged copies missed is decided by the ReLU mask of `run`'s
  own forward (`saved(x, w)`'s residual h > 0; default
  `fused_layer_forward_saved`, the kernel's): where it differs from the
  float64 plain mask only at pre-activations within float32's reach of
  zero (twice the largest distance of the plain float32 pre-activations,
  on the inputs and the nudged copies, from the float64 ones), the plain
  gradient is recomputed under that mask, and an element that fails the
  rule above passes (`mask_excused`) if that recomputation moved its
  float64 reference and it meets the same rule against the masked
  references.  Every other element is held as before; a flip beyond the
  reach excuses nothing.  Returns (ok, report); `relu`, a dict where
  given, receives the flips, those within reach, the reach and the flips'
  float64 pre-activations.
  """
  run = fused_transformer_layer_ad if run is None else run
  saved = fused_layer_forward_saved if saved is None else saved
  got = _grads(run, x, w, g)
  d = lambda t: t.double()
  x64, w64, g64 = d(x), LayerWeights(*map(d, w)), d(g)
  p32 = _grads(layer_math, x, w, g)
  p64 = _grads(layer_math, x64, w64, g64)
  gen = torch.Generator(device=x.device).manual_seed(0)
  nudge = lambda t: t * (1 + (2 * torch.rand(
      t.shape, generator=gen, device=t.device) - 1) * 2.0 ** -24)
  copies = [(nudge(x), LayerWeights(*map(nudge, w)), nudge(g))
            for _ in range(ROUNDING_SAMPLES)]
  nudged = [_grads(layer_math, *c) for c in copies]

  ok, report, failed = True, {}, []
  for i, name in enumerate(("x",) + LayerWeights._fields):
    err = (got[i] - p32[i]).abs()
    within = err <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * p32[i].abs()
    spread = max(float((n[i].double() - p64[i]).abs().max())
                 for n in [p32] + nudged)
    excused = ~within & ((got[i].double() - p64[i]).abs() <= 2 * spread)
    failed.append(~within & ~excused)
    report[name] = dict(max_abs_err=float(err.max()), f32_spread=spread,
                        excused=int(excused.sum()), mask_excused=0)
  if relu is not None or any(bool(f.any()) for f in failed):
    # the ReLU kinks: run's own mask against the float64 plain one (its
    # forward runs again only here)
    pre64 = ffn_preactivation(x64, w64)
    reach = 2 * max(float((ffn_preactivation(cx, cw).double() - pre64)
                          .abs().max()) for cx, cw in [(x, w)] + [
                              c[:2] for c in copies])
    with torch.no_grad():
      mask = saved(x, w)[1].h > 0
    flips = mask != (pre64 > 0)
    near = pre64.abs() <= reach
    decided = bool(flips.any()) and not bool((flips & ~near).any())
    if decided:
      m32 = _grads(lambda a, b: layer_math(a, b, mask), x, w, g)
      m64 = _grads(lambda a, b: layer_math(a, b, mask), x64, w64, g64)
      for i, name in enumerate(("x",) + LayerWeights._fields):
        masked_ok = (((got[i] - m32[i]).abs() <= GRAD_TOL["atol"]
                      + GRAD_TOL["rtol"] * m32[i].abs())
                     | ((got[i].double() - m64[i]).abs()
                        <= 2 * report[name]["f32_spread"]))
        excused = failed[i] & (m64[i] != p64[i]) & masked_ok
        failed[i] = failed[i] & ~excused
        report[name]["mask_excused"] = int(excused.sum())
    if relu is not None:
      relu.update(flips=int(flips.sum()),
                  flips_within_reach=int((flips & near).sum()), reach=reach,
                  decided=decided,
                  flip_preactivations=pre64[flips][:8].tolist())
  for name, f in zip(report, failed):
    report[name]["failed"] = int(f.sum())
    ok &= not bool(f.any())
  return ok, report


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
