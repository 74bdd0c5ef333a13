"""Device operations launched in a minibatch of the update: those launched
inside the program's `v4l.learner.minibatch` spans (on any thread: the
backward's launch on autograd's), over the number of those spans."""
from harness import program_spans


def read(ctx):
  ps = program_spans.of(ctx)
  if ps is None or not ps.count("v4l.learner.minibatch") \
      or not ctx.trace.ops:
    return None
  return ps.launches("v4l.learner.minibatch") / ps.count(
      "v4l.learner.minibatch")
