"""Device operations launched in an env step of the collection: those
launched inside the program's `v4l.collector.step` spans (policy, env
step, partial resets), over the number of those spans."""
from harness import program_spans


def read(ctx):
  ps = program_spans.of(ctx)
  if ps is None or not ps.count("v4l.collector.step") or not ctx.trace.ops:
    return None
  return ps.launches("v4l.collector.step") / ps.count("v4l.collector.step")
