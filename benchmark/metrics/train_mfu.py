"""The whole training step's share of the card's peak: the model FLOPs of
the window's epochs (harness/costs.epoch_flops over the configuration's
reference's `forward_flops`: the collection's pi_v, the bootstrap
values, the update's forward and backward of both nets) over the
window's seconds times the dense TF32 peak, the fastest rate of any
float32 operation of this model, in %."""
from harness import costs


def read(ctx):
  if not ctx.epochs or ctx.window_s <= 0:
    return None
  c = ctx.cell
  _, n_mb, batch = c.minibatch
  flops = costs.epoch_flops(c.reference.forward_flops(c.params),
                            c.num_envs, c.horizon, n_mb, batch)
  return 100.0 * flops * len(ctx.epochs) / (
      ctx.window_s * costs.PEAK["tf32_flops"])
