"""Faults planted under the timed path, to show that the check catches
them (benchmark/tests, and the upper readings of the limits on the card):

  unchanged       the optimizer's step returns its state unchanged: no
                  parameter moves;
  half_batch      each minibatch step sees half of its batch, its means
                  taken over the rest;
  altered_value   the collection's value is altered where it is produced
                  (1% larger);
  stale_norm      the observation normalizer's update returns its state
                  unchanged;
  altered_reward  the env step's reward is altered where it is produced
                  (0.01 added);
  altered_template  the env's settled standing template is altered where
                  it is produced (its joint angles 1e-3 rad larger).
One chip, so there is no exchange between chips to leave out.  Each is
planted, for the block it wraps, on the classes and modules that the
cell's program module names (`fault_targets()` of programs/<name>.py).
"""
from __future__ import annotations

import contextlib

from harness.spans import Patches

NAMES = ("unchanged", "half_batch", "altered_value", "stale_norm",
         "altered_reward", "altered_template")


@contextlib.contextmanager
def planted(name, program):
  """The fault `name` (None: none) planted on `program`'s targets."""
  if name is None:
    yield
    return
  t = program.fault_targets()
  MaskedAdam, PPOLearner = t["optimizer"], t["learner"]
  normalizer, A1GymEnv = t["normalizer"], t["env"]
  LocoTransformerActorCritic = t["model"]
  p = Patches()
  if name == "unchanged":
    p.set(MaskedAdam, "update", lambda self, grads, state: state)
  elif name == "half_batch":
    step = PPOLearner._minibatch_update

    def half(self, ts, batch):
      n = batch[0].shape[0] // 2
      return step(self, ts, tuple(x[:n] for x in batch))
    p.set(PPOLearner, "_minibatch_update", half)
  elif name == "altered_value":
    pi_v = LocoTransformerActorCritic.pi_v

    def altered_value(self, x, fused=False):
      pi, v = pi_v(self, x, fused=fused)
      return pi, v * 1.01
    p.set(LocoTransformerActorCritic, "pi_v", altered_value)
  elif name == "altered_reward":
    step_from = A1GymEnv.step_from

    def altered_reward(self, states, actions, draws):
      states, obs, rew, done, info = step_from(self, states, actions, draws)
      return states, obs, rew + 0.01, done, info
    p.set(A1GymEnv, "step_from", altered_reward)
  elif name == "stale_norm":
    p.set(normalizer, "update", lambda state, batch, *a, **kw: state)
  elif name == "altered_template":
    settled = A1GymEnv.settled_template

    def altered_template(self):
      tpl = settled(self)
      return tpl.replace(phys=tpl.phys.replace(
          joint_q=tpl.phys.joint_q + 1e-3))
    p.set(A1GymEnv, "settled_template", altered_template)
  else:
    raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
  try:
    yield
  finally:
    p.restore()
