"""Device milliseconds of the camera per env step: the operations
launched inside the spans around `envs/camera.py`'s `render_depth` and
`preprocess_depth`, over the traced epochs' steps."""


def read(ctx):
  if ctx.trace is None:
    return None
  dev = ctx.trace.device_s("camera")
  if dev <= 0:
    return None
  return 1e3 * dev / (ctx.traced_epochs * ctx.cell.horizon)
