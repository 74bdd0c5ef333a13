"""Spans put on from outside the program: `record_function` ranges around
the entry points of its layers, installed for the traced epochs only.
Each span wraps an attribute (a module's function or an object's method)
and restores it on exit; a recorder may keep the call's inputs for the
yardstick's counts.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

# the spans of the traced epochs, from the entry point down
NAMES = ("collector", "learner", "env_step", "env_reset", "camera", "window",
         "layer", "layer_bwd")


class Patches:
  """setattr with undo."""

  def __init__(self):
    self._undo: List[tuple] = []

  def set(self, obj, attr: str, value):
    self._undo.append((obj, attr, getattr(obj, attr),
                       attr in getattr(obj, "__dict__", {}), value))
    setattr(obj, attr, value)

  def restore(self):
    for obj, attr, old, own, new in reversed(self._undo):
      if own or not hasattr(type(obj), attr):
        setattr(obj, attr, old)
      else:
        delattr(obj, attr)      # an instance override of a method
      if "launches" in getattr(new, "__dict__", {}):
        # the program counts launches on the function it looks up
        old.launches = new.launches
    self._undo.clear()


def spanned(name: str, fn: Callable, record: Callable = None):
  """fn inside a record_function(name) range; record(*args, **kw), where
  given, sees each call's inputs.  Attributes the program keeps on the
  function (launch counters) are carried over."""
  def wrapper(*args, **kw):
    if record is not None:
      record(*args, **kw)
    with torch.profiler.record_function(name):
      return fn(*args, **kw)
  wrapper.__dict__.update(getattr(fn, "__dict__", {}))
  return wrapper


@contextlib.contextmanager
def installed(agent):
  """The spans on `agent`'s program; yields the recorded calls
  {"window": [...], "layer": [(B, T, F, grad)]}."""
  from vision4leg_torch.envs import camera
  from vision4leg_torch.ops import attention, physics_kernel
  calls: Dict[str, list] = {"window": [], "layer": []}

  def rec_window(model, rs, command, dyn, boxes, spheres, fric_ground,
                 fric_box, n_substeps, interpolate=False, *a, **kw):
    calls["window"].append(dict(
        rs=rs, command=command, dyn=dyn, boxes=boxes, spheres=spheres,
        fric_ground=fric_ground, fric_box=fric_box, n_substeps=n_substeps,
        interpolate=interpolate))

  def rec_layer(x, w):
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *w))
    calls["layer"].append((x.shape[0], x.shape[1], w.w1.shape[1], grad))

  p = Patches()
  env = agent.env
  p.set(agent, "rollout", spanned("collector", agent.rollout))
  p.set(agent.learner, "update_per_epoch",
        spanned("learner", agent.learner.update_per_epoch))
  p.set(env, "step_from", spanned("env_step", env.step_from))
  p.set(env, "reset_from", spanned("env_reset", env.reset_from))
  p.set(camera, "render_depth", spanned("camera", camera.render_depth))
  p.set(camera, "preprocess_depth",
        spanned("camera", camera.preprocess_depth))
  p.set(physics_kernel, "robot_window",
        spanned("window", physics_kernel.robot_window, rec_window))
  p.set(attention, "fused_transformer_layer_ad",
        spanned("layer", attention.fused_transformer_layer_ad, rec_layer))
  p.set(attention, "fused_transformer_layer_bwd",
        spanned("layer_bwd", attention.fused_transformer_layer_bwd))
  try:
    yield calls
  finally:
    p.restore()
