"""The device's idle share of the traced window: 1 - the union of its
operations' intervals on the timeline over the window, in %."""
from harness.trace import idle_share


def read(ctx):
  if ctx.trace is None or not ctx.trace.ops:
    return None
  return idle_share(ctx.trace.busy_s(), ctx.trace.window_s())
