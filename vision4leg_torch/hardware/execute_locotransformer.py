"""Deploy a trained LocoTransformer to the real A1 (mirror of
vision4leg_tpu.hardware.execute_locotransformer; reference
a1_hardware/execute_locotransformer.py:17-111): the policy from the run's
params.json, training obs normalizer and snapshot, the history buffers
warmed up, then the Executor at 25 Hz.

  python -m vision4leg_torch.hardware.execute_locotransformer \
      --config <json> --log_dir ./log --id <id> --seed 0 [--seconds 30] \
      [--snap best] [--fake-robot] [--device cpu]

The run is read from <log_dir>/<id>/<env_name>/<seed>/model/: the port's
`model_pf_<snap>.pt` or the JAX package's `model_pf_<snap>.flax`, and
`_obs_normalizer_<snap>.npz`.  The policy runs on the card unless
`--device cpu` is given: each tick is `pi(obs[None], fused=True)`, the
fused layer kernel at B = 1 once per transformer layer on the card, its
plain version on the CPU.  `--fake-robot` is the loopback dry run: a
robot that always reports the standing pose and a constant far-depth
camera.  Without it the RealSense camera is required: where the JAX
entry point would quietly put the constant camera on the real robot
(`pyrealsense2` missing), this one raises.
"""
from __future__ import annotations

import argparse
import os.path as osp

import numpy as np
import torch

from vision4leg_torch import resolve_device
from vision4leg_torch.hardware import realsense
from vision4leg_torch.hardware.executor import Executor, RobotController
from vision4leg_torch.hardware.export import load_actor_critic
from vision4leg_torch.hardware.policy_wrapper import PolicyWrapper
from vision4leg_torch.hardware.robot_interface import (IMUState, LowState,
                                                       MotorStateArray)
from vision4leg_torch.robots import a1_params as P
from vision4leg_torch.utils.args import get_params


def parse_args(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--config", required=True)
  p.add_argument("--log_dir", default="./log")
  p.add_argument("--id", required=True)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--snap", default="best")
  p.add_argument("--seconds", type=float, default=30.0)
  p.add_argument("--control_freq", type=float, default=25.0)
  p.add_argument("--fake-robot", action="store_true",
                 help="loopback dry run without the UDP link / camera")
  p.add_argument("--device", default=None,
                 help="cpu to run the policy without a card (default: the "
                      "card)")
  return p.parse_args(argv)


def make_policy_fn(module, device: torch.device):
  """obs (D,) numpy -> mean action (A,) numpy: the observation moved to
  the policy's device, one forward of `pi` with the fused layer."""

  @torch.no_grad()
  def policy_fn(obs):
    x = torch.as_tensor(obs, dtype=torch.float32, device=device)[None]
    mean, _, _ = module.pi(x, fused=True)
    return mean[0].cpu().numpy()

  return policy_fn


class FakeRI:
  """The dry run's robot (the JAX entry point's loopback `_FakeRI`): it
  always reports the standing pose and drops every command."""

  def ReceiveObservation(self):
    return LowState(
        motorState=MotorStateArray(
            q=np.asarray(P.INIT_MOTOR_ANGLES, np.float32),
            dq=np.zeros(12, np.float32), tauEst=np.zeros(12, np.float32)),
        imu=IMUState(quaternion=np.array([1, 0, 0, 0], np.float32),
                     gyroscope=np.zeros(3, np.float32),
                     accelerometer=np.array([0, 0, 9.8], np.float32),
                     rpy=np.zeros(3, np.float32)),
        footForce=np.zeros(4, np.float32), tick=0.0)

  def SendCommand(self, cmd):
    pass


def make_camera(fake_robot: bool):
  """The constant camera in the dry run; else the RealSense, which raises
  without `pyrealsense2`."""
  if fake_robot:
    return realsense.FakeCamera()
  if not realsense.HAS_REALSENSE:
    raise ImportError(
        "pyrealsense2 is not installed: the real robot needs its depth "
        "camera (the policy would walk on a constant image); pass "
        "--fake-robot for a dry run")
  return realsense.A1RealSense()


def build_executor(args) -> Executor:
  """The Executor of the parsed flags: policy, wrapper, robot link,
  camera."""
  device = resolve_device(args.device)
  params = get_params(args.config)
  work_dir = osp.join(args.log_dir, args.id, params["env_name"],
                      str(args.seed))
  module = load_actor_critic(params, work_dir, args.snap, device)
  nz = np.load(osp.join(work_dir, "model",
                        f"_obs_normalizer_{args.snap}.npz"))
  build = params["env"]["env_build"]
  wrapper = PolicyWrapper(
      policy_fn=make_policy_fn(module, device),
      obs_normalizer_mean=nz["mean"], obs_normalizer_var=nz["var"],
      frame_extract=build.get("frame_extract", 1),
      get_image_interval=build.get("get_image_interval", 1),
      clip_num=tuple(build.get("clip_num", (0.05, 0.5, 0.5) * 4)))
  camera = make_camera(args.fake_robot)
  if args.fake_robot:
    ri = FakeRI()
  else:
    from vision4leg_torch.hardware.robot_interface import RobotInterface
    ri = RobotInterface()
  return Executor(wrapper, RobotController(ri), camera=camera,
                  control_freq=args.control_freq)


def main(argv=None) -> Executor:
  args = parse_args(argv)
  executor = build_executor(args)
  executor.execute(args.seconds)
  return executor


if __name__ == "__main__":
  main()
