"""Host syncs of the collection per env step: the copies between host and
device that the device trace shows launched inside the program's
`v4l.collect` spans (each waits for the card), over the traced env steps
(`v4l.collector.step` spans).  The trace counts them all: the reads of
device values, which also carry a `v4l.sync.*` span, and the copies of
host constants to the card, which carry none."""
from harness import program_spans


def read(ctx):
  ps = program_spans.of(ctx)
  if ps is None or not ps.count("v4l.collector.step") or not ctx.trace.ops:
    return None
  return ps.copies("v4l.collect") / ps.count("v4l.collector.step")
