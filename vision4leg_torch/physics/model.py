"""Kinematic-tree model of a floating-base robot (torch mirror of
vision4leg_tpu.physics.model).

Topology (`parent`, `levels`, `cp_body`) is static Python data; the
inertial and joint arrays are tensors on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Model:
  """B bodies (body 0 the floating base), J = B - 1 revolute joints (body
  j+1 is the child of joint j), P collision spheres."""
  parent: tuple
  levels: tuple              # bodies grouped by tree depth
  joint_axis: torch.Tensor   # (J, 3) child frame
  joint_offset: torch.Tensor  # (J, 3) child origin in parent frame
  ancestor_mask: torch.Tensor  # (B, J) 1 if joint k is on root->body i
  mass: torch.Tensor         # (B,)
  com: torch.Tensor          # (B, 3)
  inertia: torch.Tensor      # (B, 3, 3) about the COM, body frame
  joint_lower: torch.Tensor  # (J,)
  joint_upper: torch.Tensor  # (J,)
  armature: torch.Tensor     # (J,)
  joint_damping: torch.Tensor  # (J,)
  joint_friction: torch.Tensor  # (J,)
  cp_body: tuple             # (P,) ints
  cp_offset: torch.Tensor    # (P, 3)
  cp_radius: torch.Tensor    # (P,)
  cp_is_foot: torch.Tensor   # (P,)
  gravity: torch.Tensor      # (3,)
  dt: float = 0.0025

  @property
  def nbody(self) -> int:
    return len(self.parent)

  @property
  def njoint(self) -> int:
    return self.joint_axis.shape[0]

  @property
  def nv(self) -> int:
    return 6 + self.njoint

  @property
  def ncp(self) -> int:
    return len(self.cp_body)

  @property
  def device(self) -> torch.device:
    return self.mass.device

  def replace(self, **kw) -> "Model":
    return dataclasses.replace(self, **kw)


def make_model(parent, joint_axis, joint_offset, mass, com, inertia,
               joint_lower, joint_upper, cp_body, cp_offset, cp_radius,
               cp_is_foot, gravity=(0.0, 0.0, -10.0), dt: float = 0.0025,
               armature: Any = 0.01, joint_damping: Any = 0.0,
               joint_friction: Any = 0.0, device="cpu") -> Model:
  """Build a Model from numpy inputs, computing the ancestry mask."""
  parent = np.asarray(parent, np.int32)
  nb = parent.shape[0]
  nj = nb - 1
  mask = np.zeros((nb, nj), np.float32)
  depth = np.zeros(nb, np.int32)
  for i in range(1, nb):
    b = i
    while b > 0:
      mask[i, b - 1] = 1.0
      b = parent[b]
    depth[i] = depth[parent[i]] + 1
  levels = tuple(
      tuple(int(i) for i in np.where(depth == d)[0])
      for d in range(1, depth.max() + 1))

  def t(x, shape=None):
    x = np.asarray(x, np.float32)
    if shape is not None:
      x = np.broadcast_to(x, shape)
    return torch.tensor(np.array(x, np.float32), device=device)

  return Model(
      parent=tuple(int(p) for p in parent), levels=levels,
      joint_axis=t(joint_axis), joint_offset=t(joint_offset),
      ancestor_mask=t(mask), mass=t(mass), com=t(com), inertia=t(inertia),
      joint_lower=t(joint_lower), joint_upper=t(joint_upper),
      armature=t(armature, (nj,)), joint_damping=t(joint_damping, (nj,)),
      joint_friction=t(joint_friction, (nj,)),
      cp_body=tuple(int(b) for b in np.asarray(cp_body)),
      cp_offset=t(cp_offset), cp_radius=t(cp_radius),
      cp_is_foot=t(cp_is_foot), gravity=t(gravity), dt=float(dt))
