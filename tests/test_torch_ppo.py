"""Parity of the port's GAE and PPO learner (vision4leg_torch.data.gae,
vision4leg_torch.algo.ppo) with the JAX package's, on the CPU.

The trajectory, the behavior log-probs and the flax parameters are made
once from seeds and handed to both sides; the JAX permutations of each
opt epoch (jax.random.permutation of the update key's splits) are
injected into the torch learner.  Tolerances:
  * GAE and discounted returns: 1e-6 absolute (and relative), float32
    recursions of length 40 in the same order on both sides;
  * updated parameters and update metrics: atol 1e-5, rtol 1e-4.  These
    comparisons run in float64 on both sides (JAX under
    `jax.enable_x64`).  In float32 the two frameworks' forward passes
    differ by ~1e-7, and in this trajectory one pre-activation of a
    value-layer ReLU lies 2.9e-7 from zero after the first minibatch: it
    falls on either side in the two frameworks, the gradient of that
    layer's FFN then differs by 1e-5 (1% of its size), and Adam carries
    that into parameter differences of 1e-4 by the fourth minibatch.
    That is the float32 rounding of a kink, not a difference of the
    update; in float64 the two agree to 1e-9.  The fused update against
    the unfused one (both torch, same inputs) stays in float32, the type
    the fused layer takes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.algo.ppo import PPOConfig as JPPOConfig
from vision4leg_tpu.algo.ppo import PPOLearner as JPPOLearner
from vision4leg_tpu.collector.rollout import Transition as JTransition
from vision4leg_tpu.data import gae as jgae
from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_torch.algo.on_policy_base import MaskedAdam, param_labels
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.data import gae
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic

UPD = dict(atol=1e-5, rtol=1e-4)
STATE = 40
OBS = STATE + 4 * 64 * 64
WIDTHS = dict(action_dim=6, state_input_shape=STATE,
              visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32,),
              transformer_params=((1, 64), (1, 64)),
              append_hidden_shapes=(32,), token_dim=32)
T, E = 4, 4
CFG = dict(plr=3e-4, vlr=4e-4, clip_para=0.2, entropy_coeff=0.01,
           discount=0.99, tau=0.95, batch_size=8, epoch_frames=T * E,
           opt_epochs=2, num_epochs=4, shuffle=True)
N_EPOCHS = 3


@pytest.mark.parametrize("tl_filter", [True, False])
def test_gae_and_returns_match_jax(tl_filter):
  """The case of tests/test_algo.py:44, with terminals and time limits."""
  rng = np.random.RandomState(0)
  T_, E_ = 40, 3
  arrs = [rng.randn(T_, E_).astype(np.float32),
          rng.randn(T_, E_).astype(np.float32),
          (rng.rand(T_, E_) < 0.1).astype(np.float32),
          (rng.rand(T_, E_) < 0.05).astype(np.float32),
          rng.randn(E_).astype(np.float32)]
  assert arrs[2].any() and arrs[3].any()
  ref = jgae.gae(*map(jnp.asarray, arrs), 0.99, 0.95, tl_filter)
  got = gae.gae(*map(torch.tensor, arrs), gamma=0.99, tau=0.95,
                time_limit_filter=tl_filter)
  ref_d = jgae.discounted_returns(*map(jnp.asarray, arrs), 0.99, tl_filter)
  got_d = gae.discounted_returns(*map(torch.tensor, arrs), gamma=0.99,
                                 time_limit_filter=tl_filter)
  for r, g in zip(list(ref) + list(ref_d), list(got) + list(got_d)):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                               rtol=1e-6)


def _trajectory(flax_net, params, dtype=np.float64):
  """Observations, actions sampled from the initial policy, behavior
  log-probs moved off it (so that the ratio clips), values, rewards, one
  terminal and one time limit."""
  rng = np.random.default_rng(5)
  obs = (0.3 * rng.normal(size=(T, E, OBS))).astype(dtype)
  mean, std, _ = flax_net.apply(params, jnp.asarray(obs.reshape(T * E, -1)),
                                method=flax_net.pi)
  mean, std = np.asarray(mean).reshape(T, E, -1), np.asarray(std).reshape(
      T, E, -1)
  acts = (mean + std * rng.normal(size=mean.shape)).astype(dtype)
  logp = np.sum(-0.5 * ((acts - mean) / std) ** 2 - np.log(std)
                - 0.5 * np.log(2 * np.pi), -1, keepdims=True)
  logp = (logp + rng.uniform(-0.3, 0.3, logp.shape)).astype(dtype)
  terminals = np.zeros((T, E, 1), bool)
  terminals[1, 2] = True
  time_limits = np.zeros((T, E, 1), bool)
  time_limits[2, 0] = True
  terminals[2, 0] = True
  return dict(obs=obs, acts=acts, log_probs=logp,
              values=rng.normal(size=(T, E, 1)).astype(dtype),
              rewards=rng.normal(size=(T, E, 1)).astype(dtype),
              terminals=terminals, time_limits=time_limits,
              means=mean.astype(dtype), stds=std.astype(dtype))


@pytest.fixture(scope="module")
def jax_run():
  """The JAX learner in float64 over N_EPOCHS update epochs; params and
  metrics after each, and the permutations each used."""
  with jax.enable_x64(True):
    flax_net = FlaxAC(**WIDTHS)
    params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    traj = _trajectory(flax_net, params)
    last_value = np.random.default_rng(6).normal(size=E)
    learner = JPPOLearner(
        JPPOConfig(**CFG),
        lambda p, x: flax_net.apply(p, x, method=flax_net.pi),
        lambda p, x: flax_net.apply(p, x, method=flax_net.v), params)
    ts = learner.init_state(params)
    go = jax.jit(learner.update_per_epoch)
    jtraj = JTransition(**{k: jnp.asarray(v) for k, v in traj.items()})
    out = []
    for ep in range(N_EPOCHS):
      key = jax.random.PRNGKey(100 + ep)
      perms = np.stack([np.asarray(jax.random.permutation(k, T))
                        for k in jax.random.split(key, CFG["opt_epochs"])])
      ts, metrics = go(ts, jtraj, jnp.asarray(last_value), key)
      out.append(dict(params=params_from_flax(jax.tree.map(
          lambda x: np.asarray(x, np.float64), ts.params)),
                      metrics={k: float(v) for k, v in metrics.items()},
                      perms=perms))
    params = jax.tree.map(np.asarray, params)
  return params, traj, last_value, out


def _torch_learner(params, fused, dtype=torch.float64):
  net = LocoTransformerActorCritic(**WIDTHS).to(dtype)
  net.load_state_dict(params_from_flax(params))
  learner = PPOLearner(PPOConfig(**CFG),
                       lambda m, x: m.pi(x, fused=fused),
                       lambda m, x: m.v(x, fused=fused), net)
  return net, learner, learner.init_state(net)


def _torch_epochs(jax_run, fused, dtype=torch.float64, n_epochs=N_EPOCHS):
  params, traj, last_value, out = jax_run
  net, learner, ts = _torch_learner(params, fused, dtype)
  t = lambda v: torch.tensor(v).to(dtype) if v.dtype != bool \
      else torch.tensor(v)
  ttraj = Transition(**{k: t(v) for k, v in traj.items()})
  got = []
  for ep in range(n_epochs):
    ts, metrics = learner.update_per_epoch(ts, ttraj, t(last_value),
                                           perms=out[ep]["perms"])
    got.append(dict(params={k: v.clone() for k, v in
                            net.state_dict().items()},
                    metrics={k: float(v) for k, v in metrics.items()}))
  return learner, ts, got


@pytest.fixture(scope="module")
def torch_run(jax_run):
  """The torch learner over the same N_EPOCHS, float64, unfused."""
  return _torch_epochs(jax_run, fused=False)


def test_param_labels_split_the_locotransformer():
  net = LocoTransformerActorCritic(**WIDTHS)
  assert param_labels(net) == {
      "encoder": "both", "pf_layers": "pf", "vf_layers": "vf",
      "pf_mlp": "pf", "vf_mlp": "vf", "logstd": "pf"}
  cfg = PPOConfig(**CFG)
  pf = MaskedAdam(cfg, net, "pf", 1.0)
  vf = MaskedAdam(cfg, net, "vf", 1.0)
  assert set(pf.names) & set(vf.names) == {
      n for n, _ in net.named_parameters() if n.startswith("encoder.")}
  assert set(pf.names) | set(vf.names) == {
      n for n, _ in net.named_parameters()}


def test_one_ppo_epoch_matches_jax(jax_run, torch_run):
  _, _, got = torch_run
  ref = jax_run[3][0]
  for name, ref_v in ref["params"].items():
    np.testing.assert_allclose(got[0]["params"][name].numpy(),
                               ref_v.numpy(), err_msg=name, **UPD)
  init = params_from_flax(jax_run[0])
  moved = sum(not torch.equal(init[n], v) for n, v in
              got[0]["params"].items())
  assert moved == len(init)          # every parameter was updated
  assert set(got[0]["metrics"]) == set(ref["metrics"])
  for k, v in ref["metrics"].items():
    np.testing.assert_allclose(got[0]["metrics"][k], v, err_msg=k, **UPD)
  # the surrogate clipped somewhere
  assert ref["metrics"]["ratio/max"] > 1.2 or ref["metrics"]["ratio/min"] \
      < 0.8


def test_linear_lr_decay_over_epochs_matches_jax(jax_run, torch_run):
  """Three update epochs (test_algo.py:153): the schedule's epoch index
  advances every opt_epochs * epoch_frames / batch_size updates, and the
  parameters still follow the JAX learner's."""
  learner, ts, got = torch_run
  assert ts.epoch == N_EPOCHS
  per_epoch = CFG["opt_epochs"] * (CFG["epoch_frames"] // CFG["batch_size"])
  assert ts.pf_opt.count == ts.vf_opt.count == N_EPOCHS * per_epoch
  tx = learner.pf_tx
  assert [tx.lr(c) for c in (0, per_epoch - 1, per_epoch, 2 * per_epoch)] \
      == pytest.approx([3e-4, 3e-4, 3e-4 * 0.75, 3e-4 * 0.5])
  for name, ref_v in jax_run[3][-1]["params"].items():
    np.testing.assert_allclose(got[-1]["params"][name].numpy(),
                               ref_v.numpy(), err_msg=name, **UPD)


def test_fused_update_matches_unfused(jax_run):
  """The update with every transformer layer through the fused layer
  (its plain version on the CPU, its autograd.Function backward) against
  the unfused module."""
  _, _, plain = _torch_epochs(jax_run, fused=False, dtype=torch.float32,
                              n_epochs=1)
  _, _, fused = _torch_epochs(jax_run, fused=True, dtype=torch.float32,
                              n_epochs=1)
  for name, v in plain[0]["params"].items():
    np.testing.assert_allclose(fused[0]["params"][name].numpy(), v.numpy(),
                               err_msg=name, **UPD)
  for k, v in plain[0]["metrics"].items():
    np.testing.assert_allclose(fused[0]["metrics"][k], v, err_msg=k, **UPD)


def test_update_draws_permutations_from_its_generator(jax_run):
  """Without injected permutations the rows are shuffled by the given
  generator: the same seed gives the same update, another seed another."""
  params, traj, last_value, _ = jax_run
  ttraj = Transition(**{k: torch.tensor(v) for k, v in traj.items()})
  runs = []
  for seed in (1, 1, 2):
    net, learner, ts = _torch_learner(params, fused=False)
    learner.update_per_epoch(ts, ttraj, torch.tensor(last_value),
                             gen=torch.Generator().manual_seed(seed))
    runs.append(net.pf_mlp.layers[0].weight.detach().clone())
  assert torch.equal(runs[0], runs[1])
  assert not torch.equal(runs[0], runs[2])
  cfg = dataclasses.replace(PPOConfig(**CFG), shuffle=False)
  assert cfg.shuffle is False
