"""The yardstick's counts: the peaks of the card, the least time of the
physics window and of the fused layer from the work their inputs need,
and the model FLOPs of a training epoch from one sample's forward (each
reference module counts its own model's: `forward_flops`).

The layer's counts are frozen copies of the program's
`ops/attention.py` `layer_cost` / `layer_grad_cost`; the window's come
from the frozen `reference/frozen/window_cost.py`, with the data-dependent
contact counts taken from the benchmark's own plain window on the same
inputs (`reference/frozen/physics_envlast.py`).
"""
from __future__ import annotations

import functools

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK = {"tf32_flops": 495e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}
# a float32-exact product on the tensor cores takes three TF32 products
F32_TC_FLOPS = PEAK["tf32_flops"] / 3


def layer_cost(B: int, T: int, D: int, F: int):
  """(bytes, operations) of one forward of the single-head post-norm
  layer: x read and out written once, every weight read once; the FLOPs
  of its matrix products (QKV, scores, context, out-projection, FFN)."""
  n_weights = 4 * D * D + 2 * D * F + 9 * D + F
  nbytes = 4 * (2 * B * T * D + n_weights)
  flops = B * (2 * T * D * D * 4 + 2 * 2 * T * T * D + 2 * 2 * T * D * F)
  return nbytes, flops


def layer_grad_cost(B: int, T: int, D: int, F: int):
  """(bytes, operations) of the layer's forward and backward together:
  x, the output gradient and the weights read once, dx and the weight
  gradients written once; each product once forward, twice backward."""
  _, flops = layer_cost(B, T, D, F)
  n_weights = 4 * D * D + 2 * D * F + 9 * D + F
  return 4 * (3 * B * T * D + 2 * n_weights), 3 * flops


def layer_least_s(B: int, T: int, D: int, F: int, grad: bool) -> float:
  nbytes, flops = (layer_grad_cost if grad else layer_cost)(B, T, D, F)
  return max(nbytes / PEAK["hbm_bytes"], flops / F32_TC_FLOPS)


@functools.lru_cache(maxsize=4)
def _model(dt: float, device: str):
  from reference.frozen import a1_model
  return a1_model.build(dt=dt, device=torch.device(device))


def _envlast(call):
  """The window call's inputs in the plain window's env-last layout."""
  rs, dyn = call["rs"], call["dyn"]
  t = lambda x: x.movedim(0, -1)
  p = rs.phys
  state = dict(pos=t(p.pos), quat=t(p.quat), q=t(p.joint_q), ang=t(p.ang),
               lin=t(p.lin), qd=t(p.joint_qd), hist=t(rs.obs_hist),
               obs_tau=t(rs.observed_torques),
               last_action=t(rs.last_robot_action), counter=rs.step_counter)
  d = dict(kp=t(dyn.kp), kd=t(dyn.kd), strength=t(dyn.strength_ratios),
           motor_friction=dyn.motor_friction,
           joint_friction=dyn.joint_friction,
           mass_scale=t(dyn.mass_scale), inertia_scale=t(dyn.inertia_scale))
  return state, d


@torch.no_grad()
def window_least_s(call, dt: float) -> float:
  """The least time of one physics-window call: the larger of its bytes
  over the memory rate and its operations over the float32 rate, the
  operations counted for the contacts this call's inputs make."""
  from reference.frozen import physics_envlast, window_cost
  model = _model(dt, str(call["command"].device))
  state, dyn = _envlast(call)
  boxes, spheres = call["boxes"], call["spheres"]
  counts: dict = {}
  physics_envlast.window(
      model, state, call["command"].movedim(0, -1), dyn,
      boxes.movedim(0, -1),
      spheres.movedim(0, -1) if spheres.shape[1] > 0 else None,
      call["fric_ground"], call["fric_box"], call["n_substeps"],
      call["interpolate"], counts)
  nbytes, ops = window_cost.window_bytes_and_ops(
      model, boxes, spheres, call["n_substeps"], call["interpolate"], counts)
  return max(nbytes / PEAK["hbm_bytes"], ops / PEAK["fp32_flops"])


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

def epoch_flops(forward, num_envs: int, horizon: int, n_minibatches: int,
                batch: int) -> int:
  """Model FLOPs of one PPO epoch, from one sample's forward FLOPs
  `forward` = (tokenizer, policy stack and head, value stack and head),
  as the configuration's reference counts them (`forward_flops`): the
  collection's pi_v on every sample, the bootstrap values on the last
  observations, and each minibatch's value and policy forward and
  backward (3x the forward; the tokenizer runs in both, as the critic
  and actor steps need)."""
  tok, pf, vf = forward
  collect = num_envs * horizon * (tok + pf + vf) + num_envs * (tok + vf)
  update = n_minibatches * batch * 3 * ((tok + vf) + (tok + pf))
  return int(collect + update)
