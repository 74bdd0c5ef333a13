"""Guards of the torch port: it imports neither JAX nor the JAX package,
its entry points default to the card and refuse to fall back to the CPU,
and chip_smoke.py refuses to run without a card."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_AND_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys

class Block:
  def find_spec(self, name, path=None, target=None):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "vision4leg_tpu",
                              "msgpack", "starter"):
      raise ImportError(f"blocked import of {name}")
    return None

sys.meta_path.insert(0, Block())
import vision4leg_torch
names = [m.name for m in pkgutil.walk_packages(vision4leg_torch.__path__,
                                               "vision4leg_torch.")]
for n in names:
  importlib.import_module(n)
for n in ("vision4leg_torch.algo.agent",
          "vision4leg_torch.starter.ppo_locotransformer",
          "vision4leg_torch.starter.ppo_locotransformer_vision_only",
          "vision4leg_torch.starter.ppo_nature_cnn",
          "vision4leg_torch.starter.ppo_nature_cnn_vision_only",
          "vision4leg_torch.starter.ppo_state",
          "vision4leg_torch.ops.attention",
          "vision4leg_torch.envs.mpc_env",
          "vision4leg_torch.mpc.convex_mpc",
          "vision4leg_torch.mpc.controllers",
          "vision4leg_torch.mpc.leg_kinematics",
          "vision4leg_torch.robots.action_filter",
          "vision4leg_torch.envs.wrappers",
          "vision4leg_torch.starter.ppo_nature_cnn_sim2sim",
          "vision4leg_torch.starter.locomotion_controller_example",
          "vision4leg_torch.mpc.qp_torque_optimizer",
          "vision4leg_torch.mpc.robot_params",
          "vision4leg_torch.mpc.static_gait",
          "vision4leg_torch.mpc.native.mpc_osqp",
          "vision4leg_torch.robots.pose_utils",
          "vision4leg_torch.utils.flax_msgpack",
          "vision4leg_torch.envs.trajectory_generator",
          "vision4leg_torch.starter.viewer_common",
          "vision4leg_torch.starter.env_viewer",
          "vision4leg_torch.starter.locotransformer_viewer",
          "vision4leg_torch.starter.locotransformer_vision_only_viewer",
          "vision4leg_torch.starter.nature_cnn_viewer",
          "vision4leg_torch.starter.nature_cnn_vision_only_viewer",
          "vision4leg_torch.starter.state_policy_viewer",
          "vision4leg_torch.starter.total_randomize_statistics",
          "vision4leg_torch.starter.convert_jax_run",
          "vision4leg_torch.algo.a2c",
          "vision4leg_torch.algo.vmpo",
          "vision4leg_torch.algo.trpo",
          "vision4leg_torch.algo.ppo_aux",
          "vision4leg_torch.algo.off_policy.agent",
          "vision4leg_torch.algo.off_policy.learners",
          "vision4leg_torch.models.off_policy_nets",
          "vision4leg_torch.models.discrete_policies",
          "vision4leg_torch.models.distributions",
          "vision4leg_torch.data.replay",
          "vision4leg_torch.collector.host",
          "vision4leg_torch.collector.hierarchical",
          "vision4leg_torch.collector.atari",
          "vision4leg_torch.hardware.sensor_histories",
          "vision4leg_torch.hardware.state_logger",
          "vision4leg_torch.hardware.realsense",
          "vision4leg_torch.hardware.robot_interface",
          "vision4leg_torch.hardware.policy_wrapper",
          "vision4leg_torch.hardware.executor",
          "vision4leg_torch.hardware.export",
          "vision4leg_torch.hardware.execute_locotransformer",
          "vision4leg_torch.utils.profiling",
          "vision4leg_torch.utils.tensorboard_starter",
          "vision4leg_torch.models.nets",
          "vision4leg_torch.parallel.mesh",
          "vision4leg_torch.parallel.dryrun"):
  assert n in names, n
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "vision4leg_tpu"))
assert not leaked, leaked
print("imported", len(names), "modules")
"""


def test_port_and_smoke_script_import_without_jax():
  proc = subprocess.run([sys.executable, "-c", _BLOCK_AND_IMPORT], cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  n = int(proc.stdout.split()[1])
  assert n >= 20


_BLOCK_GYMNASIUM = r"""
import importlib, pkgutil, sys

class Block:
  def find_spec(self, name, path=None, target=None):
    if name.split(".")[0] in ("gymnasium", "gym", "ale_py", "jax", "jaxlib",
                              "flax", "vision4leg_tpu"):
      raise ImportError(f"blocked import of {name}")
    return None

sys.meta_path.insert(0, Block())
import vision4leg_torch
names = [m.name for m in pkgutil.walk_packages(vision4leg_torch.__path__,
                                               "vision4leg_torch.")]
atari = "vision4leg_torch.collector.atari"
assert atari in names
for n in names:
  if n != atari:
    importlib.import_module(n)
try:
  importlib.import_module(atari)
except ImportError as e:
  assert "gymnasium" in str(e), str(e)
else:
  raise AssertionError("collector.atari imported without gymnasium")
from vision4leg_torch.collector import host
try:
  host.make_vec_env("Pendulum-v1", 1)
except ImportError as e:
  assert "gymnasium" in str(e), str(e)
else:
  raise AssertionError("make_vec_env ran without gymnasium")
print("imported", len(names) - 1, "modules")
"""


def test_only_the_atari_wrappers_need_gymnasium():
  """With gymnasium (and gym, ale_py) blocked, every port module but
  collector/atari.py imports; that one, and host.make_vec_env, raise an
  ImportError that names gymnasium.  The card has no gymnasium."""
  proc = subprocess.run([sys.executable, "-c", _BLOCK_GYMNASIUM], cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert int(proc.stdout.split()[1]) >= 20


def test_default_device_entry_points_raise_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is valid")
  from vision4leg_torch import resolve_device
  from vision4leg_torch.envs.get_env import get_env
  with pytest.raises(RuntimeError, match="no CUDA device"):
    resolve_device()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    get_env("A1MoveGround", {"env_build": {}})
  with pytest.raises(RuntimeError, match="no CUDA device"):
    get_env("A1MoveGroundMPC", {"env_build": {"policy_freq": 20}})
  assert resolve_device("cpu").type == "cpu"
  from vision4leg_torch.starter import locomotion_controller_example as demo
  with pytest.raises(RuntimeError, match="no CUDA device"):
    demo.build_env("a1")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    demo.main(["--robot", "a1", "--max_time", "0.01"])
  # the viewers, the sweep and the converter (their flags name a run that
  # need not exist: the device is resolved first)
  from vision4leg_torch.starter import (convert_jax_run, env_viewer,
                                        locotransformer_viewer,
                                        total_randomize_statistics,
                                        viewer_common)
  config = os.path.join(ROOT, "config/rl/static/locotransformer/"
                        "thin-goal.json")
  run = ["--config", config, "--id", "none", "--log_dir", ROOT]
  with pytest.raises(RuntimeError, match="no CUDA device"):
    viewer_common.run_viewer(locotransformer_viewer._build_module, run)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    total_randomize_statistics.main(run)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    env_viewer.main(["--config", config, "--steps", "1"])
  with pytest.raises(RuntimeError, match="no CUDA device"):
    convert_jax_run.main([
        "--run", os.path.join(ROOT, "runs/mmdr_moving_10M/A1MoveGround/0"),
        "--out", os.path.join(ROOT, "_archive", "unused")])
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.algo.ppo import PPOConfig
  env, _ = get_env("A1MoveGround", {"env_build": {}}, device="cpu")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    PPOAgent(env=env, ac_module=None, cfg=PPOConfig(), num_envs=4, seed=0,
             logger=None, save_dir="unused")
  from vision4leg_torch.algo.off_policy.agent import OffPolicyAgent
  with pytest.raises(RuntimeError, match="no CUDA device"):
    OffPolicyAgent(env=env, learner=None, learner_state=None,
                   apply_pf=None, num_envs=4, replay_capacity=8, seed=0)
  from vision4leg_torch.collector.host import HostOnPolicyCollector
  with pytest.raises(RuntimeError, match="no CUDA device"):
    HostOnPolicyCollector(None, None, None)
  # the deploy entry point: its policy runs on the card, never quietly on
  # the CPU
  from vision4leg_torch.hardware import execute_locotransformer as deploy
  with pytest.raises(RuntimeError, match="no CUDA device"):
    deploy.main(run + ["--fake-robot", "--seconds", "0"])


def test_chip_smoke_fails_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present")
  proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout
