"""Host milliseconds of an env step under the profiler: the spans around
the env's `step_from` and `reset_from` as the collector calls them, over
the traced epochs' steps."""


def read(ctx):
  if ctx.trace is None or not ctx.trace.calls("env_step"):
    return None
  steps = ctx.traced_epochs * ctx.cell.horizon
  host = ctx.trace.host_s("env_step") + ctx.trace.host_s("env_reset")
  return 1e3 * host / steps
