"""Conversions from numpy arrays (e.g. the JAX package's state and flax
parameters pulled to the host) into this package's tensors.

Nothing here imports JAX: inputs are numpy arrays, or objects whose
attributes are numpy arrays and that mirror the JAX package's state
classes field by field (`RobotState.phys.pos`, `DynamicsParams.kp`, ...).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vision4leg_torch.envs import env as env_lib
from vision4leg_torch.envs import tasks
from vision4leg_torch.envs.terrain import TerrainState
from vision4leg_torch.physics import engine
from vision4leg_torch.robots import a1, action_filter


def tensor(x, device="cpu") -> torch.Tensor:
  """float32, or int32 for integer arrays."""
  arr = np.array(x)
  dtype = torch.int32 if arr.dtype.kind in "iu" else torch.float32
  return torch.tensor(arr, dtype=dtype, device=device)


def phys_state(ps, device="cpu") -> engine.PhysState:
  return engine.PhysState(**{
      f: tensor(getattr(ps, f), device)
      for f in ("pos", "quat", "joint_q", "ang", "lin", "joint_qd")})


def robot_state(rs, device="cpu") -> a1.RobotState:
  return a1.RobotState(
      phys=phys_state(rs.phys, device),
      obs_hist=tensor(rs.obs_hist, device),
      observed_torques=tensor(rs.observed_torques, device),
      last_robot_action=tensor(rs.last_robot_action, device),
      step_counter=tensor(rs.step_counter, device))


def dynamics(dyn, device="cpu") -> a1.DynamicsParams:
  return a1.DynamicsParams(**{
      f: tensor(getattr(dyn, f), device)
      for f in ("kp", "kd", "strength_ratios", "motor_friction",
                "joint_friction", "control_latency", "lateral_friction",
                "mass_scale", "inertia_scale")})


def filter_state(fs, device="cpu") -> action_filter.FilterState:
  """The Butterworth filter's histories (the JAX EnvState.filter_state)."""
  return action_filter.FilterState(xhist=tensor(fs.xhist, device),
                                   yhist=tensor(fs.yhist, device))


def terrain(ts, device="cpu") -> TerrainState:
  """A batch of the JAX package's TerrainState (leading env axis), its
  heightfield fields and obstacle spheres (E, Q, 5) included."""
  spheres = getattr(ts, "obstacle_spheres", None)
  return TerrainState(
      height=tensor(ts.height, device), hf_cell=tensor(ts.hf_cell, device),
      hf_origin=tensor(ts.hf_origin, device),
      hf_zoff=tensor(ts.hf_zoff, device),
      boxes=tensor(ts.boxes, device), box_dirs=tensor(ts.box_dirs, device),
      subgoals=tensor(ts.subgoals, device),
      goal_pos=tensor(ts.goal_pos, device),
      obstacle_spheres=(tensor(spheres, device) if spheres is not None
                        else torch.zeros(
                            np.shape(ts.boxes)[:-2] + (0, 5), device=device)))


def task_state(ts, device="cpu") -> tasks.TaskState:
  return tasks.TaskState(**{
      f: tensor(getattr(ts, f), device)
      for f in ("last_base_pos", "current_base_pos", "subgoal_trackers",
                "target_vel_dir")})


def env_state(es, device="cpu") -> env_lib.EnvState:
  """A batch of the JAX package's A1GymEnv EnvState (leading env axis):
  every field but its key, the RandoDir angle and count, the base
  quaternion of the rotate sensor and the displacement history (3 or 7
  channels) included."""
  t = lambda x: tensor(x, device)
  return env_lib.EnvState(
      robot=robot_state(es.robot, device), dyn=dynamics(es.dyn, device),
      terrain=terrain(es.terrain, device), task=task_state(es.task, device),
      **{f: t(getattr(es, f)) for f in (
          "motor_hist", "imu_hist", "disp_hist", "last_action_hist",
          "last_action", "last_base_pos", "last_base_quat", "dir_angle",
          "dir_count")},
      filter_state=filter_state(es.filter_state, device),
      **{f: t(getattr(es, f)) for f in (
          "frames", "frame_idx", "interp_delay", "step_counter")})


# ---------------------------------------------------------------------------
# flax actor-critic params -> torch state_dict
# ---------------------------------------------------------------------------

def _dense(sd, prefix, p):
  """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
  sd[prefix + ".weight"] = torch.tensor(np.asarray(p["kernel"]).T.copy())
  sd[prefix + ".bias"] = torch.tensor(np.asarray(p["bias"]).copy())


def _conv(sd, prefix, p):
  """flax Conv kernel HWIO -> torch Conv2d OIHW."""
  sd[prefix + ".weight"] = torch.tensor(
      np.ascontiguousarray(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
  sd[prefix + ".bias"] = torch.tensor(np.asarray(p["bias"]).copy())


def _mlp(sd, prefix, p):
  """Dense_0..Dense_{n-1} of a flax MLP -> ModuleList entries 0..n-1."""
  n = sum(1 for k in p if k.startswith("Dense_"))
  for i in range(n):
    _dense(sd, f"{prefix}.{i}", p[f"Dense_{i}"])


def _attention_layer(sd, prefix, p):
  """flax MultiHeadDotProductAttention: query/key/value kernels
  (D, heads, head_dim) and biases (heads, head_dim); out kernel (heads,
  head_dim, D).  Torch layer keeps heads x head_dim flattened, head-major
  (as flax reshapes), in Linear layout (out, in)."""
  att = p["MultiHeadDotProductAttention_0"]
  for name in ("query", "key", "value"):
    k = np.asarray(att[name]["kernel"])
    d = k.shape[0]
    _dense(sd, f"{prefix}.{name}", dict(kernel=k.reshape(d, -1),
                                        bias=np.asarray(
                                            att[name]["bias"]).reshape(-1)))
  k = np.asarray(att["out"]["kernel"])
  _dense(sd, f"{prefix}.out", dict(kernel=k.reshape(-1, k.shape[-1]),
                                   bias=att["out"]["bias"]))
  for i in (0, 1):
    ln = p[f"LayerNorm_{i}"]
    sd[f"{prefix}.norm{i + 1}.weight"] = torch.tensor(
        np.asarray(ln["scale"]).copy())
    sd[f"{prefix}.norm{i + 1}.bias"] = torch.tensor(
        np.asarray(ln["bias"]).copy())
  _dense(sd, f"{prefix}.ff1", p["Dense_0"])
  _dense(sd, f"{prefix}.ff2", p["Dense_1"])


def _nature_from_flax(sd, prefix, p):
  for i in range(3):
    _conv(sd, f"{prefix}.convs.{i}", p[f"Conv_{i}"])


def encoder_channels(enc: Mapping) -> int:
  """The image channels of a flax LocoTransformerEncoder or
  VisionTokenEncoder, told by its modules: two Nature CNNs are rgbd (16:
  NatureEncoder_0 and Conv_0 the rgb modality, created first, _1 the
  depth, JAX base.py:158-165 and 471-476); one is depth (4) or rgb (12)
  by its first convolution's input channels.  Raises on another layout."""
  natures = sorted(k for k in enc if k.startswith("NatureEncoder_"))
  convs = sorted(k for k in enc if k.startswith("Conv_"))
  first_in = np.shape(enc["NatureEncoder_0"]["Conv_0"]["kernel"])[2] \
      if natures else None
  if natures == ["NatureEncoder_0"] and convs == ["Conv_0"] \
     and first_in in (4, 12):
    return int(first_in)
  if natures == ["NatureEncoder_0", "NatureEncoder_1"] \
     and convs == ["Conv_0", "Conv_1"] and first_in == 12 \
     and np.shape(enc["NatureEncoder_1"]["Conv_0"]["kernel"])[2] == 4:
    return 16
  raise ValueError(f"flax encoder: unknown tokenizer layout "
                   f"{sorted(enc)} (first convolution's input channels "
                   f"{first_in})")


def encoder_from_flax(enc: Mapping) -> Dict[str, torch.Tensor]:
  """state_dict of models.base.LocoTransformerEncoder, or of
  VisionTokenEncoder when the flax encoder has no proprio MLP, from the
  flax encoder's params pulled to numpy; 4, 12 or 16 channels
  (`encoder_channels`), rgb into `rgb_nature`/`rgb_token_conv` and depth
  into `nature`/`token_conv`."""
  sd: Dict[str, torch.Tensor] = {}
  if "MLPBase_0" in enc:
    _mlp(sd, "state_mlp.layers", enc["MLPBase_0"])
    _dense(sd, "state_proj", enc["RLProjection_0"]["Dense_0"])
  channels = encoder_channels(enc)
  names = {4: ["nature"], 12: ["rgb_nature"],
           16: ["rgb_nature", "nature"]}[channels]
  for i, name in enumerate(names):
    _nature_from_flax(sd, name, enc[f"NatureEncoder_{i}"])
    _conv(sd, name.replace("nature", "token_conv"), enc[f"Conv_{i}"])
  return sd


def _impala_from_flax(sd, prefix, p):
  """flax ImpalaEncoder: Conv_i is stage i's conv, ImpalaResBlock_{2i},
  _{2i+1} its blocks (Conv_0, Conv_1 each)."""
  n = sum(1 for k in p if k.startswith("Conv_"))
  for i in range(n):
    _conv(sd, f"{prefix}.convs.{i}", p[f"Conv_{i}"])
  for j in range(2 * n):
    for c in (0, 1):
      _conv(sd, f"{prefix}.blocks.{j}.conv{c}",
            p[f"ImpalaResBlock_{j}"][f"Conv_{c}"])


def _nature_heads_from_flax(sd, p):
  for side in ("pf", "vf"):
    _mlp(sd, f"{side}_mlp.layers", p[f"{side}_mlp"])
  sd["head.logstd"] = torch.tensor(np.asarray(p["head"]["logstd"]).copy())


def params_from_flax(np_params: Mapping) -> Dict[str, torch.Tensor]:
  """state_dict of a models.actor_critic module from the flax module's
  params (`variables["params"]`, or the whole variables dict) pulled to
  numpy, the module told by the params' layout:
  LocoTransformerActorCritic, or VisionOnlyTransformerActorCritic when
  the encoder has no proprio MLP (layer counts read from the params; the
  torch LayerNorms use eps 1e-6 like flax's); NatureFuseActorCritic when
  the encoder has a Nature CNN and no transformer layers follow it;
  VisualNetActorCritic when a `backbone` takes the encoder's place;
  StateActorCritic when an MLP `base` does; ImpalaFuseResidualActorCritic
  when a `visual_base` does."""
  p = np_params.get("params", np_params)
  sd: Dict[str, torch.Tensor] = {}
  if "visual_base" in p:
    _impala_from_flax(sd, "visual_base", p["visual_base"])
    _dense(sd, "visual_proj.dense", p["visual_proj"]["Dense_0"])
    _mlp(sd, "state_mlp.layers", p["state_mlp"])
    for head in ("pf_fused", "pf_state", "vf_fused", "aux_head"):
      _mlp(sd, f"{head}.layers", p[head])
    sd["head.logstd"] = torch.tensor(np.asarray(p["head"]["logstd"]).copy())
    return sd
  if "base" in p:
    _mlp(sd, "base.layers", p["base"])
    _nature_heads_from_flax(sd, p)
    return sd
  if "backbone" in p:
    _nature_from_flax(sd, "backbone", p["backbone"])
    _nature_heads_from_flax(sd, p)
    return sd
  enc = p["encoder"]
  if "Conv_0" not in enc:   # no token conv: the Nature-CNN trunk
    _nature_from_flax(sd, "encoder.nature", enc["NatureEncoder_0"])
    _dense(sd, "encoder.projection.dense", enc["RLProjection_0"]["Dense_0"])
    _mlp(sd, "encoder.state_mlp.layers", enc["MLPBase_0"])
    _nature_heads_from_flax(sd, p)
    return sd
  sd = {f"encoder.{k}": v for k, v in encoder_from_flax(enc).items()}
  n_layers = sum(1 for k in p if k.startswith("pf_layers_"))
  for side in ("pf", "vf"):
    for li in range(n_layers):
      _attention_layer(sd, f"{side}_layers.{li}", p[f"{side}_layers_{li}"])
    _mlp(sd, f"{side}_mlp.layers", p[f"{side}_mlp"])
  sd["logstd"] = torch.tensor(np.asarray(p["head"]["logstd"]).copy())
  return sd


def nets_params_from_flax(np_params: Mapping) -> Dict[str, torch.Tensor]:
  """state_dict of a models.nets head from the flax head's params pulled
  to numpy, the head told by the params' layout: Net (`MLPBase_0` at the
  top), LocoTransformer or Transformer (`LocoTransformerEncoder_0`, its
  token LayerNorm_0 where token_norm is on, TransformerEncoderLayer_i),
  NatureFuseNet (`NatureFuseEncoder_0`); the head's Dense_j -> head.layers.j
  in each."""
  p = np_params.get("params", np_params)
  sd: Dict[str, torch.Tensor] = {}
  if "MLPBase_0" in p:
    _mlp(sd, "base.layers", p["MLPBase_0"])
  elif "LocoTransformerEncoder_0" in p:
    sd.update({f"encoder.{k}": v for k, v in encoder_from_flax(
        p["LocoTransformerEncoder_0"]).items()})
    if "LayerNorm_0" in p:
      sd["token_norm.weight"] = torch.tensor(
          np.asarray(p["LayerNorm_0"]["scale"]).copy())
      sd["token_norm.bias"] = torch.tensor(
          np.asarray(p["LayerNorm_0"]["bias"]).copy())
    n_layers = sum(1 for k in p if k.startswith("TransformerEncoderLayer_"))
    for li in range(n_layers):
      _attention_layer(sd, f"layers.{li}", p[f"TransformerEncoderLayer_{li}"])
  elif "NatureFuseEncoder_0" in p:
    enc = p["NatureFuseEncoder_0"]
    _nature_from_flax(sd, "encoder.nature", enc["NatureEncoder_0"])
    _dense(sd, "encoder.projection.dense", enc["RLProjection_0"]["Dense_0"])
    _mlp(sd, "encoder.state_mlp.layers", enc["MLPBase_0"])
  else:
    raise ValueError(f"flax nets head: unknown layout {sorted(p)}")
  _mlp(sd, "head.layers", p)
  return sd


def off_policy_params_from_flax(np_params: Mapping) -> Dict[str, torch.Tensor]:
  """state_dict of a models.off_policy_nets module (TanhGaussianPolicy,
  DetTanhPolicy, QNet, DiscreteQNet, BootstrappedQNet) from the flax
  module's params pulled to numpy: MLPBase_0 -> base, Dense_j ->
  layers.j."""
  p = np_params.get("params", np_params)
  sd: Dict[str, torch.Tensor] = {}
  _mlp(sd, "base.layers", p["MLPBase_0"])
  n = sum(1 for k in p if k.startswith("Dense_"))
  for j in range(n):
    _dense(sd, f"layers.{j}", p[f"Dense_{j}"])
  return sd
