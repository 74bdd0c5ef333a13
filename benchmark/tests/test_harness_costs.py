"""The yardstick's counts: the frozen copies against the program's own
counts at today's shapes, the model FLOPs against a hand count, and the
device's busy time as a union on a synthetic timeline."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH

SHAPES = [(1024, 17, 64, 256), (4096, 17, 64, 256), (1, 17, 64, 256),
          (1024, 33, 64, 256)]


@pytest.mark.parametrize("shape", SHAPES)
def test_layer_costs_match_program(shape):
  from harness import costs
  from vision4leg_torch.ops import attention
  assert costs.layer_cost(*shape) == attention.layer_cost(*shape)
  assert costs.layer_grad_cost(*shape) == attention.layer_grad_cost(*shape)


def _window_case(n_env=8, seed=0):
  """A thin-goal env's window inputs after a reset, with boxes moved
  under the feet so that the counts see contacts."""
  from vision4leg_torch.envs.get_env import get_env
  with open(os.path.join(BENCH, "configs", "thin-goal.json")) as f:
    params = json.load(f)
  env, _ = get_env(params["env_name"], params["env"], device="cpu")
  env.cfg = type(env.cfg)(**{**env.cfg.__dict__, "settle_steps": 20})
  gen = torch.Generator().manual_seed(seed)
  states, _ = env.reset(n_env, gen)
  boxes = env._pruned_boxes(states.terrain.boxes,
                            states.robot.phys.pos[:, :2]).clone()
  boxes[:, 0, :2] = states.robot.phys.pos[:, :2]   # a box under the robot
  boxes[:, 0, 2], boxes[:, 0, 5], boxes[:, 0, 7] = 0.0, 0.05, 1.0
  act = env._init_cmd.expand(n_env, 12).clone()
  fric = states.dyn.lateral_friction
  return env, dict(rs=states.robot, command=act, dyn=states.dyn,
                   boxes=boxes, spheres=states.terrain.obstacle_spheres,
                   fric_ground=fric, fric_box=fric, n_substeps=16,
                   interpolate=False)


def test_window_cost_matches_program():
  """The frozen window and its cost give the program's counts, bytes and
  operations on the same inputs."""
  from harness import costs
  from reference.frozen import physics_envlast as frozen_pe
  from reference.frozen import window_cost as frozen_wc
  from vision4leg_torch.ops import physics_kernel, window_cost
  env, call = _window_case()
  counts_prog = {}
  physics_kernel.window_plain(
      env.model, call["rs"], call["command"], call["dyn"], call["boxes"],
      call["spheres"], call["fric_ground"], call["fric_box"], 16,
      counts=counts_prog)
  prog = window_cost.window_bytes_and_ops(
      env.model, call["boxes"], call["spheres"], 16, False, counts_prog)
  model = costs._model(0.0025, "cpu")
  state, dyn = costs._envlast(call)
  counts = {}
  frozen_pe.window(model, state, call["command"].movedim(0, -1), dyn,
                   call["boxes"].movedim(0, -1), None, call["fric_ground"],
                   call["fric_box"], 16, False, counts)
  assert sum(float(np.asarray(v).sum()) for v in counts.values()) > 0
  for k in counts_prog:
    np.testing.assert_array_equal(np.asarray(counts[k]),
                                  np.asarray(counts_prog[k]))
  assert frozen_wc.window_bytes_and_ops(
      model, call["boxes"], call["spheres"], 16, False, counts) == prog
  least = costs.window_least_s(call, 0.0025)
  assert least == max(prog[0] / 3.35e12, prog[1] / 67e12)


def test_model_flops_hand_count():
  """One sample of the thin-goal model, counted by hand: proprio MLP
  84-256-256-64, Nature CNN 4x64x64 -> 32x15x15 -> 64x6x6 -> 64x4x4, the
  1x1 token conv, two layers of (T 17, D 64, F 256) a stack, heads
  128-256-256-{6, 1}."""
  from harness import costs
  from reference import locotransformer as ref
  with open(os.path.join(BENCH, "configs", "thin-goal.json")) as f:
    params = json.load(f)
  mlp = 2 * (84 * 256 + 256 * 256 + 256 * 64)
  conv = 2 * (4 * 64 * 32 * 225 + 32 * 16 * 64 * 36 + 64 * 9 * 64 * 16
              + 64 * 64 * 16)
  layer = 2 * 17 * 64 * 64 * 4 + 2 * 2 * 17 * 17 * 64 + 2 * 2 * 17 * 64 * 256
  head = lambda out: 2 * (128 * 256 + 256 * 256 + 256 * out)
  tok, pf, vf = ref.forward_flops(params)
  assert (tok, pf, vf) == (mlp + conv, 2 * layer + head(6),
                           2 * layer + head(1))
  epoch = costs.epoch_flops((tok, pf, vf), 1024, 16, 48, 1024)
  assert epoch == (1024 * 16 * (tok + pf + vf) + 1024 * (tok + vf)
                   + 48 * 1024 * 3 * (2 * tok + pf + vf))


def test_union_and_gaps():
  from harness import trace
  st = np.array([0, 5, 20, 22, 40, 41], np.int64)
  en = np.array([10, 8, 25, 30, 41, 45], np.int64)
  assert trace.union_length(st, en) == 10 + 10 + 5
  assert trace.idle_gaps(st, en, 0, 50) == [(10, 20), (30, 40), (45, 50)]
  # overlap is counted once, not twice as a sum of self times would
  assert trace.union_length(np.array([0, 0]), np.array([10, 10])) == 10


def test_trace_attribution():
  """Device operations go to every span their launch started in, on
  whichever thread, and to the innermost one in the breakdown; busy time
  is cut to the window."""
  from harness.trace import Interval, Trace, WINDOW_SPAN
  spans = [Interval(WINDOW_SPAN, 0, 100, 1), Interval("camera", 10, 20, 1),
           Interval("layer_bwd", 11, 30, 2)]
  ops = [Interval("k0", 12, 40), Interval("k1", 15, 18),
         Interval("k2", 90, 120)]
  tr = Trace(spans, ops, np.array([10, 12, 50]))
  assert tr.device_s("camera") == pytest.approx(31e-9)
  assert tr.device_s("layer_bwd") == pytest.approx(3e-9)
  assert tr.busy_s() == pytest.approx((28 + 10) * 1e-9)
  assert tr.innermost(["camera", "layer_bwd"]) == ["camera", "layer_bwd",
                                                   "other"]
  b = tr.breakdown(["camera", "layer_bwd"])
  assert dict(b["device_ops"]) == pytest.approx(
      {"other:k2": 30e-9, "camera:k0": 28e-9, "layer_bwd:k1": 3e-9})
  # idle from 0 to 12 and from 40 to 90; at 0 and at 40 no span is open
  assert dict(b["idle_gaps"]) == pytest.approx({"other": 62e-9})
