"""The share of the update's minibatches that replayed a CUDA graph of the
step: the program's `v4l.learner.replay` spans over its
`v4l.learner.minibatch` spans in the traced epochs, in %.  A program that
steps eagerly reads 0.0; one that records no spans gives None."""
from harness import program_spans


def read(ctx):
  ps = program_spans.of(ctx)
  if ps is None or not ps.count("v4l.learner.minibatch"):
    return None
  return 100.0 * ps.count("v4l.learner.replay") / ps.count(
      "v4l.learner.minibatch")
