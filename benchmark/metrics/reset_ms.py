"""Host milliseconds of the collection's partial resets per env step: the
program's `v4l.collector.reset` spans (the reset's draws, the finished
envs' rows, `reset_from`, the scatter), over the traced env steps; 0.0
where no env reset."""
from harness import program_spans


def read(ctx):
  ps = program_spans.of(ctx)
  if ps is None or not ps.count("v4l.collector.step"):
    return None
  return 1e3 * ps.host_s("v4l.collector.reset") / ps.count(
      "v4l.collector.step")
