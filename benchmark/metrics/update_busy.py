"""The device's busy share of the update's minibatches: the union of the
device's operations within the program's `v4l.learner.minibatch` spans,
over those spans' length, in %."""
from harness import program_spans


def read(ctx):
  ps = program_spans.of(ctx)
  if ps is None or not ctx.trace.ops:
    return None
  share = ps.busy_share("v4l.learner.minibatch")
  return None if share is None else 100.0 * share
