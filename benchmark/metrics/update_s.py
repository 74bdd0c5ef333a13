"""Seconds of an epoch's update (the agent's `Update_Time`, host clock
after a synchronize), the mean over the window's epochs."""
import statistics


def read(ctx):
  t = [p["Update_Time"] for p in ctx.epochs if "Update_Time" in p]
  return statistics.fmean(t) if t else None
