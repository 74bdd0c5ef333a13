"""Parity of the port's A2C, REINFORCE, V-MPO and TRPO learners
(vision4leg_torch.algo.a2c, vmpo, trpo) with the JAX package's, on the
CPU.

The trajectory, the behavior statistics and the flax parameters are made
once from seeds and handed to both sides; the JAX permutations of each
sweep (jax.random.permutation of the update key's splits) are injected
into the torch learner.  Both sides run in float64 (JAX under
`jax.enable_x64`): parameters, metrics and the V-MPO duals agree within
1e-8 (absolute and relative).  The float32 frameworks part at ReLU kinks
(tests/test_torch_ppo.py), so float32 is not compared.  The model is
StateActorCritic (32,) over T=8 steps of E=4 envs; A2C also runs a
one-layer narrow LocoTransformer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.algo import a2c as ja2c
from vision4leg_tpu.algo import trpo as jtrpo
from vision4leg_tpu.algo import vmpo as jvmpo
from vision4leg_tpu.collector.rollout import Transition as JTransition
from vision4leg_tpu.models import actor_critic as jac
from vision4leg_torch.algo import a2c, trpo, vmpo
from vision4leg_torch.algo.on_policy_base import (MaskedAdam,
                                                  OnPolicyConfig, normal_kl)
from vision4leg_torch.algo.ppo import PPOConfig
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.models import actor_critic as tac

TOL = dict(atol=1e-8, rtol=1e-8)
T, E, OBS, A = 8, 4, 20, 3
STATE = dict(action_dim=A, hidden_shapes=(32,), append_hidden_shapes=(32,))
LOCO_STATE = 12
LOCO = dict(action_dim=A, state_input_shape=LOCO_STATE,
            visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(16,),
            transformer_params=((1, 32),), append_hidden_shapes=(16,),
            token_dim=16)
COMMON = dict(plr=3e-4, vlr=4e-4, entropy_coeff=0.01, discount=0.99,
              tau=0.95, batch_size=8, epoch_frames=T * E, num_epochs=4)
LEARNERS = {
    "a2c": (ja2c.A2CConfig, ja2c.A2CLearner, a2c.A2CConfig, a2c.A2CLearner,
            dict(opt_epochs=2)),
    "reinforce": (ja2c.A2CConfig, ja2c.ReinforceLearner, a2c.A2CConfig,
                  a2c.ReinforceLearner, dict(opt_epochs=1)),
    "vmpo": (jvmpo.VMPOConfig, jvmpo.VMPOLearner, vmpo.VMPOConfig,
             vmpo.VMPOLearner, dict(opt_epochs=2)),
    "trpo": (jtrpo.TRPOConfig, jtrpo.TRPOLearner, trpo.TRPOConfig,
             trpo.TRPOLearner, dict(v_opt_times=2)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _trajectory(flax_net, params, obs_dim, seed=5):
  """Observations, actions sampled from the initial policy, behavior
  log-probs moved off it, values, rewards, one terminal, one time limit."""
  rng = np.random.default_rng(seed)
  obs = 0.3 * rng.normal(size=(T, E, obs_dim))
  mean, std, _ = flax_net.apply(params, jnp.asarray(obs.reshape(T * E, -1)),
                                method=flax_net.pi)
  mean = np.asarray(mean).reshape(T, E, -1)
  std = np.asarray(std).reshape(T, E, -1)
  acts = mean + std * rng.normal(size=mean.shape)
  logp = np.sum(-0.5 * ((acts - mean) / std) ** 2 - np.log(std)
                - 0.5 * np.log(2 * np.pi), -1, keepdims=True)
  logp = logp + rng.uniform(-0.3, 0.3, logp.shape)
  terminals = np.zeros((T, E, 1), bool)
  terminals[3, 2] = True
  time_limits = np.zeros((T, E, 1), bool)
  time_limits[5, 0] = terminals[5, 0] = True
  # behavior statistics moved off the policy so the V-MPO KL is not 0
  return dict(obs=obs, acts=acts, log_probs=logp,
              values=rng.normal(size=(T, E, 1)),
              rewards=rng.normal(size=(T, E, 1)), terminals=terminals,
              time_limits=time_limits,
              means=mean + 0.05 * rng.normal(size=mean.shape),
              stds=std * np.exp(0.05 * rng.normal(size=std.shape)))


def _jax_epoch(name, flax_net, obs_dim, seed=0):
  """One update epoch of the JAX learner in float64: its parameters,
  metrics, duals, and the permutations it drew."""
  jcfg_cls, jlearner_cls, _, _, extra = LEARNERS[name]
  with jax.enable_x64(True):
    params = flax_net.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    traj = _trajectory(flax_net, params, obs_dim)
    last_value = np.random.default_rng(6).normal(size=E)
    cfg = jcfg_cls(**COMMON, **extra)
    learner = jlearner_cls(
        cfg, lambda p, x: flax_net.apply(p, x, method=flax_net.pi),
        lambda p, x: flax_net.apply(p, x, method=flax_net.v), params)
    ts = learner.init_state(params)
    key = jax.random.PRNGKey(100)
    sweeps = extra.get("v_opt_times", extra.get("opt_epochs", 1))
    perms = np.stack([np.asarray(jax.random.permutation(k, T))
                      for k in jax.random.split(key, sweeps)])
    ts, metrics = jax.jit(learner.update_per_epoch)(
        ts, JTransition(**{k: jnp.asarray(v) for k, v in traj.items()}),
        jnp.asarray(last_value), key)
    out = dict(
        init=jax.tree.map(np.asarray, params), traj=traj,
        last_value=last_value, perms=perms,
        params=params_from_flax(jax.tree.map(np.asarray, ts.params)),
        metrics={k: float(v) for k, v in metrics.items()})
    if name == "vmpo":
      out["duals"] = [float(ts.extras["duals"][k]) for k in ("eta",
                                                             "alpha")]
  return out


def _torch_epoch(name, net, ref):
  _, _, cfg_cls, learner_cls, extra = LEARNERS[name]
  net = net.double()
  net.load_state_dict(params_from_flax(ref["init"]))
  learner = learner_cls(cfg_cls(**COMMON, **extra),
                        lambda m, x: m.pi(x), lambda m, x: m.v(x), net)
  ts = learner.init_state(net)
  traj = Transition(**{k: torch.tensor(v) for k, v in ref["traj"].items()})
  ts, metrics = learner.update_per_epoch(
      ts, traj, torch.tensor(ref["last_value"]), perms=ref["perms"])
  return learner, ts, net, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def state_runs():
  flax_net = jac.StateActorCritic(**STATE)
  out = {}
  for name in LEARNERS:
    ref = _jax_epoch(name, flax_net, OBS)
    out[name] = (ref, _torch_epoch(
        name, tac.StateActorCritic(state_input_shape=OBS, **STATE), ref))
  return out


def _assert_matches(ref, got_net, got_metrics):
  got = got_net.state_dict()
  init = params_from_flax(ref["init"])
  assert set(got) == set(ref["params"])
  for k, v in ref["params"].items():
    np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **TOL)
  assert set(got_metrics) == set(ref["metrics"])
  for k, v in ref["metrics"].items():
    np.testing.assert_allclose(got_metrics[k], v, err_msg=k, **TOL)
  return sum(not torch.equal(init[k].double(), v) for k, v in got.items())


@pytest.mark.parametrize("name", list(LEARNERS))
def test_update_epoch_matches_jax(state_runs, name):
  ref, (learner, ts, net, metrics) = state_runs[name]
  moved = _assert_matches(ref, net, metrics)
  # every learner moves the policy head; A2C/V-MPO/TRPO the value head too
  assert moved >= (2 if name == "reinforce" else 6), moved
  assert ts.epoch == 1


def test_vmpo_duals_match_jax(state_runs):
  ref, (_, ts, _, metrics) = state_runs["vmpo"]
  got = [float(d) for d in ts.extras["duals"]]
  np.testing.assert_allclose(got, ref["duals"], **TOL)
  assert got != [1.0, 0.1]
  assert ts.extras["dual_opt"].count == 2 * (T * E // COMMON["batch_size"])
  assert metrics["KL/mean"] > 0


def test_trpo_kl_and_accepted_step_match_jax(state_runs):
  """kl_after within the trust region as JAX's; the step the line search
  accepted: the policy head (which the value sweeps leave alone) moved by
  the accepted fraction of torch's full step on the JAX side too."""
  ref, (learner, _, net, metrics) = state_runs["trpo"]
  np.testing.assert_allclose(metrics["Training/kl_after"],
                             ref["metrics"]["Training/kl_after"], **TOL)
  assert 0 < metrics["Training/kl_after"] < 2 * 0.01
  search = learner.last_search
  assert search["step_frac"] > 0
  init = params_from_flax(ref["init"])
  full = dict(zip(learner.pf_names, torch.split(
      search["fullstep"], [p.numel() for p in learner.pf_params])))
  for name in ("pf_mlp.layers.1.weight", "head.logstd"):
    moved = ref["params"][name].double() - init[name].double()
    np.testing.assert_allclose(
        moved.numpy().ravel(),
        search["step_frac"] * full[name].numpy().ravel(), **TOL)


def test_a2c_on_a_narrow_locotransformer_matches_jax():
  obs_dim = LOCO_STATE + 4 * 64 * 64
  ref = _jax_epoch("a2c", jac.LocoTransformerActorCritic(**LOCO), obs_dim)
  _, _, net, metrics = _torch_epoch(
      "a2c", tac.LocoTransformerActorCritic(**LOCO), ref)
  assert _assert_matches(ref, net, metrics) == len(ref["params"])


def test_lr_decay_off_keeps_the_rate():
  """lr_decay=False gives the base rate at every count; PPO keeps its
  linear decay (the default)."""
  net = tac.StateActorCritic(state_input_shape=OBS, **STATE)
  off = MaskedAdam(dataclasses.replace(OnPolicyConfig(**COMMON),
                                       lr_decay=False), net, "pf", 1e-3)
  assert [off.lr(c) for c in (0, 7, 100, 10 ** 6)] == [1e-3] * 4
  on = MaskedAdam(PPOConfig(**COMMON, opt_epochs=1), net, "pf", 1e-3)
  assert PPOConfig().lr_decay and on.lr(0) == 1e-3
  assert on.lr(4) == pytest.approx(1e-3 * 0.75)
  assert not a2c.A2CConfig().lr_decay and not vmpo.VMPOConfig().lr_decay
  learner = a2c.ReinforceLearner(a2c.A2CConfig(lr_decay=True, gae=True),
                                 None, None, net)
  assert not learner.cfg.lr_decay and not learner.cfg.gae


def test_normal_kl_matches_jax():
  from vision4leg_tpu.algo.on_policy_base import normal_kl as jkl
  rng = np.random.default_rng(3)
  m0, m1 = rng.normal(size=(2, 5, 3))
  s0, s1 = np.exp(0.3 * rng.normal(size=(2, 5, 3)))
  with jax.enable_x64(True):
    ref = np.asarray(jkl(*map(jnp.asarray, (m0, s0, m1, s1))))
  got = normal_kl(*map(torch.tensor, (m0, s0, m1, s1)))
  np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-14)
  assert torch.all(normal_kl(*map(torch.tensor, (m0, s0, m0, s0))) == 0)


def test_trpo_refuses_a_fused_update():
  net = tac.StateActorCritic(state_input_shape=OBS, **STATE)
  with pytest.raises(NotImplementedError, match="second derivative"):
    trpo.TRPOLearner(trpo.TRPOConfig(), None, None, net, fused_update=True)
