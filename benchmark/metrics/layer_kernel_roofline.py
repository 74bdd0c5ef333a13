"""The fused layer's two hand-written kernels' share of their roofline, read
by name from the device trace: the least time of the layer work the
traced kernels did, over their own device time.  Every kernel the card
ran counts, launched one by one or replayed from a CUDA graph (a trace
names a replayed kernel as it names an eager one), and nothing else:
the torch operations around the kernels (the weight gradients' products,
the sums, the transposes) are neither timed nor counted.

The calls' shapes are those the harness's `layer` span recorded; how many
of them ran is read from the kernels.  Each backward kernel is one
forward-and-backward of the recorded gradient calls' shapes, and each
forward kernel beyond the backwards one inference forward of the
recorded inference calls' shapes (mean least time over the recorded
calls of each kind: their sum where every call ran eagerly, the capture's
calls times the replays where a graph replayed them).

The work of each kind, from the frozen counts of harness/costs.py: an
inference forward is `layer_cost`; a forward-and-backward is
`layer_grad_cost` less what torch's products do outside the kernels (the
weight gradients: one product for each of the forward's weight products,
and their writes)."""
import numpy as np

from harness import costs

D = 64
FORWARD = "transformer_layer_kernel"        # both modes: inference, saving
BACKWARD = "transformer_layer_bwd_kernel"


def kernel_grad_least_s(B: int, T: int, D: int, F: int) -> float:
  """The least time of the saving forward and the backward kernel of one
  call: `layer_grad_cost` without the weight gradients, which torch
  computes after the backward kernel."""
  nbytes, flops = costs.layer_grad_cost(B, T, D, F)
  n_weights = 4 * D * D + 2 * D * F + 9 * D + F
  weight_products = B * (2 * T * D * D * 4 + 2 * 2 * T * D * F)
  return max((nbytes - 4 * n_weights) / costs.PEAK["hbm_bytes"],
             (flops - weight_products) / costs.F32_TC_FLOPS)


def read(ctx):
  if ctx.trace is None or not ctx.calls or not ctx.calls["layer"]:
    return None
  names = [o.name for o in ctx.trace.ops]
  bwd = np.asarray([BACKWARD in n for n in names], bool)
  fwd = np.asarray([FORWARD in n for n in names], bool)
  n_grad, n_inf = int(bwd.sum()), int(fwd.sum() - bwd.sum())
  grad = [c for c in ctx.calls["layer"] if c[3]]
  inf = [c for c in ctx.calls["layer"] if not c[3]]
  if n_grad + n_inf == 0 or n_inf < 0 or (n_grad and not grad) or (
      n_inf and not inf):
    return None
  least = 0.0
  if n_grad:
    least += n_grad * float(np.mean(
        [kernel_grad_least_s(B, T, D, F) for B, T, F, _ in grad]))
  if n_inf:
    least += n_inf * float(np.mean(
        [costs.layer_least_s(B, T, D, F, False) for B, T, F, _ in inf]))
  mine = fwd | bwd
  dev = sum(o.end - o.start for o, m in zip(ctx.trace.ops, mine) if m)
  if dev <= 0:
    return None
  return 100.0 * least / (dev * 1e-9)
