"""The physics window's share of its roofline: the least time the card
could take for the traced windows (the work their inputs need, counted by
harness/costs.py with the benchmark's own plain window), over the device
time of every operation launched inside the span around the program's
`physics_kernel.robot_window`."""
from harness import costs


def read(ctx):
  if ctx.trace is None or not ctx.calls or not ctx.calls["window"]:
    return None
  dev = ctx.trace.device_s("window")
  if dev <= 0:
    return None
  least = sum(costs.window_least_s(c, ctx.dt) for c in ctx.calls["window"])
  return 100.0 * least / dev
