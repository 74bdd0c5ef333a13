"""Seconds of an epoch's collection (the agent's `Explore_Time`, host
clock after a synchronize), the mean over the window's epochs."""
import statistics


def read(ctx):
  t = [p["Explore_Time"] for p in ctx.epochs if "Explore_Time" in p]
  return statistics.fmean(t) if t else None
