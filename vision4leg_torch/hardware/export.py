"""Export a trained LocoTransformer policy for deployment (mirror of
vision4leg_tpu.hardware.export; reference a1_hardware/convert_tensor_rt/
convert_locotransformer_trt.py:44-96: torch -> ONNX fp16 -> trtexec
engine).

The JAX package transplants its flax parameters into a second torch
model written for the export.  The port has its own model already:
`PolicyMean` wraps `LocoTransformerActorCritic.pi`'s mean with the plain
(unfused) layer, `attention.layer_math`'s torch ops, which a tracer can
follow; the fused kernel is a foreign call no exporter reads.  The
weights come from the port's `model_pf_<snap>.pt` or from the JAX
package's `model_pf_<snap>.flax` (`utils/flax_msgpack.py` and
`convert.params_from_flax`, no JAX).

  from vision4leg_torch.hardware.export import export_policy, export_onnx
  net = export_policy(params, work_dir)         # params: the run's JSON
  export_onnx(net, obs_dim, "policy.onnx")      # needs the onnx package
"""
from __future__ import annotations

import torch
from torch import nn

from vision4leg_torch.envs.get_env import get_env
from vision4leg_torch.starter.ppo_locotransformer import build_module
from vision4leg_torch.starter.viewer_common import load_policy_bundle


class PolicyMean(nn.Module):
  """obs (B, D) -> the policy's mean action (B, A), the plain layer."""

  def __init__(self, module):
    super().__init__()
    self.module = module

  def forward(self, x):
    return self.module.pi(x, fused=False)[0]


def load_actor_critic(params: dict, work_dir: str, snap: str = "best",
                      device="cpu"):
  """The LocoTransformerActorCritic of a run's JSON `params` with the
  weights of its snapshot `snap` (`.pt`, else `.flax`), on `device`, in
  eval mode."""
  env, _ = get_env(params["env_name"], params["env"], device="cpu")
  sd, _ = load_policy_bundle(work_dir, snap)
  module = build_module(env, params)
  module.load_state_dict(sd, strict=True)
  return module.to(device).eval()


def export_policy(params: dict, work_dir: str, snap: str = "best"
                  ) -> PolicyMean:
  """The exportable mean-action policy of a run, on the CPU."""
  return PolicyMean(load_actor_critic(params, work_dir, snap)).eval()


def export_onnx(net: nn.Module, obs_dim: int, path: str):
  dummy = torch.zeros(1, obs_dim)
  torch.onnx.export(net, dummy, path, input_names=["obs"],
                    output_names=["action_mean"], opset_version=17)
  return path
