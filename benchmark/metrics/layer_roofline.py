"""The fused transformer layer's share of its roofline: the least time of
every traced forward (`layer_cost`) and forward-and-backward
(`layer_grad_cost`) call, bound by the larger of its bytes over HBM's
rate and its products over the float32-exact tensor-core rate (three
TF32 products each), over the device time of the operations launched
inside the spans around `attention.fused_transformer_layer_ad` and its
backward."""
from harness import costs

D = 64


def read(ctx):
  if ctx.trace is None or not ctx.calls or not ctx.calls["layer"]:
    return None
  dev = ctx.trace.device_s("layer") + ctx.trace.device_s("layer_bwd")
  if dev <= 0:
    return None
  least = sum(costs.layer_least_s(B, T, D, F, grad)
              for B, T, F, grad in ctx.calls["layer"])
  return 100.0 * least / dev
