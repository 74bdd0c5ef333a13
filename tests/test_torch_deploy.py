"""The port's deploy policy (vision4leg_torch.hardware.
execute_locotransformer, export) on a policy the JAX package trained,
runs/thin_goal_10M/A1MoveGround/0 (model_pf_best.flax and its
normalizer), against the JAX entry point's jitted `module.apply` mean and
against the JAX export's torch mirror (`flax_to_torch_policy`) on the
same weights, on the CPU.  The observations are five ticks of the port's
PolicyWrapper on a seeded sensor stream.  Float32 on every side; means
within 1e-5 absolute and relative (the same products summed in other
orders: ~1e-7 apart).  The run is only read."""
import importlib.util
import os.path as osp
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from starter.ppo_locotransformer import build_module as jax_build_module
from vision4leg_tpu.envs.get_env import get_env as jax_get_env
from vision4leg_tpu.hardware.export import flax_to_torch_policy
from vision4leg_torch.hardware import execute_locotransformer as deploy
from vision4leg_torch.hardware import export, realsense
from vision4leg_torch.utils.args import get_params

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RUN = osp.join(ROOT, "runs", "thin_goal_10M", "A1MoveGround", "0")
TOL = dict(atol=1e-5, rtol=1e-5)


def _argv(*extra):
  return ["--config", osp.join(RUN, "params.json"), "--log_dir",
          osp.join(ROOT, "runs"), "--id", "thin_goal_10M", "--seed", "0",
          "--fake-robot", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def port():
  return deploy.build_executor(deploy.parse_args(_argv()))


@pytest.fixture(scope="module")
def observations(port):
  """Five wrapper observations of a seeded sensor stream."""
  rng = np.random.default_rng(0)
  wrapper = port.policy
  return np.stack([wrapper.process_obs(
      rng.normal(0, 0.1, 3), rng.normal(0, 0.5, 3),
      wrapper.last_action12 + rng.normal(0, 0.1, 12),
      rng.uniform(0.3, 6.0, (64, 64))) for _ in range(5)])


@pytest.fixture(scope="module")
def jax_policy():
  """The JAX entry point's policy (execute_locotransformer.py:43-62)."""
  params = get_params(osp.join(RUN, "params.json"))
  env, _ = jax_get_env(params["env_name"], params["env"])
  module = jax_build_module(env, params)
  init = module.init(jax.random.PRNGKey(0), jnp.zeros((1, env.obs_dim)))
  with open(osp.join(RUN, "model", "model_pf_best.flax"), "rb") as f:
    model_params = serialization.from_bytes(init, f.read())

  @jax.jit
  def policy(obs):
    (mean, _, _), _ = module.apply(model_params, obs[None])
    return mean[0]

  return module, model_params, policy


def test_deploy_policy_matches_jax(port, observations, jax_policy):
  _, _, policy = jax_policy
  for obs in observations:
    got = port.policy.policy_fn(obs)
    assert got.shape == (6,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(policy(jnp.asarray(obs))),
                               **TOL)


def test_export_matches_jax_export(observations, jax_policy):
  module, model_params, _ = jax_policy
  ref = flax_to_torch_policy(module, model_params)
  net = export.export_policy(get_params(osp.join(RUN, "params.json")), RUN)
  x = torch.from_numpy(observations)
  with torch.no_grad():
    np.testing.assert_allclose(net(x).numpy(), ref(x).numpy(), **TOL)
  # the exported module traces through the plain layer: no kernel call
  traced = torch.jit.trace(net, x[:1])
  with torch.no_grad():
    np.testing.assert_allclose(traced(x).numpy(), net(x).numpy(), **TOL)


def test_export_onnx_needs_the_onnx_package(tmp_path):
  net = export.export_policy(get_params(osp.join(RUN, "params.json")), RUN)
  path = str(tmp_path / "policy.onnx")
  if importlib.util.find_spec("onnx") is None:
    with pytest.raises(Exception, match="onnx"):
      export.export_onnx(net, 84 + 4 * 64 * 64, path)
  else:
    assert export.export_onnx(net, 84 + 4 * 64 * 64, path) == path
    assert osp.getsize(path) > 0


def test_real_robot_refuses_a_missing_camera(monkeypatch):
  monkeypatch.setattr(realsense, "HAS_REALSENSE", False)
  with pytest.raises(ImportError, match="--fake-robot"):
    deploy.make_camera(fake_robot=False)
  assert isinstance(deploy.make_camera(fake_robot=True),
                    realsense.FakeCamera)


def test_fake_robot_dry_run():
  """The entry point's stand -> warmup -> policy -> sit sequence on the
  loopback robot, 0.4 s of policy at 25 Hz on the CPU (a forward takes
  ~0.1-0.4 s here, so at least one tick and at most the 25 Hz pace's
  eleven)."""
  ex = deploy.build_executor(deploy.parse_args(_argv("--seconds", "0.4")))
  ticks = []
  fn = ex.policy.policy_fn
  ex.policy.policy_fn = lambda obs: ticks.append(obs) or fn(obs)
  t0 = time.time()
  ex.execute(0.4)
  assert time.time() - t0 < 30
  assert 1 <= len(ticks) <= 11
  assert np.all(np.isfinite(ex.policy.last_action12))
  assert not ex.rc._thread.is_alive()
