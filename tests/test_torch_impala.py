"""The port's Impala encoder, its residual block and the ppo_aux backbone
(ImpalaFuseResidualActorCritic) against the flax modules, weights carried
over by vision4leg_torch.convert, and one PPO-aux epoch
(vision4leg_torch.algo.ppo_aux) against the JAX learner, on the CPU.

Tolerances: the forwards in float32 within 1e-5 (absolute and relative):
convolutions and products of the same terms summed in other orders; the
PPO-aux epoch in float64 (JAX under `jax.enable_x64`) within 1e-8, with
the JAX permutations injected.  The encoder alone runs at the configs'
64 x 64 images, the model and the epoch at 32 x 32 (the same code, a
quarter of the CPU time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.algo import ppo_aux as jppo_aux
from vision4leg_tpu.collector.rollout import Transition as JTransition
from vision4leg_tpu.models import actor_critic as jac
from vision4leg_tpu.models import base as jbase
from vision4leg_torch import convert
from vision4leg_torch.algo import ppo_aux
from vision4leg_torch.algo.on_policy_base import param_labels
from vision4leg_torch.collector.rollout import Transition
from vision4leg_torch.models import actor_critic as tac
from vision4leg_torch.models import base as tbase

FWD = dict(atol=1e-5, rtol=1e-5)
UPD = dict(atol=1e-8, rtol=1e-8)
STATE = 24
OBS = STATE + 4 * 32 * 32
WIDTHS = dict(action_dim=3, state_input_shape=STATE,
              visual_input_shape=(4, 32, 32), encoder_hidden_shapes=(16,),
              visual_dim=16, append_hidden_shapes=(16,))
T, E = 4, 4
CFG = dict(plr=3e-4, vlr=4e-4, clip_para=0.2, entropy_coeff=0.01,
           discount=0.99, tau=0.95, batch_size=8, epoch_frames=T * E,
           opt_epochs=2, num_epochs=4, aux_coeff=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def test_res_block_matches_flax():
  rng = np.random.default_rng(0)
  x = rng.normal(size=(2, 16, 9, 9)).astype(np.float32)
  blk = jbase.ImpalaResBlock(16)
  nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
  p = _np(blk.init(jax.random.PRNGKey(1), nhwc))["params"]
  ref = np.asarray(blk.apply({"params": p}, nhwc)).transpose(0, 3, 1, 2)
  sd = {}
  for c in (0, 1):
    convert._conv(sd, f"conv{c}", p[f"Conv_{c}"])
  tb = tbase.ImpalaResBlock(16)
  tb.load_state_dict(sd, strict=True)
  with torch.no_grad():
    got = tb(torch.tensor(x)).numpy()
  np.testing.assert_allclose(got, ref, **FWD)


def test_encoder_matches_flax():
  rng = np.random.default_rng(1)
  x = rng.uniform(0, 1, size=(3, 4, 64, 64)).astype(np.float32)
  enc = jbase.ImpalaEncoder(flatten=True)
  p = _np(enc.init(jax.random.PRNGKey(2), jnp.asarray(x)))["params"]
  ref = np.asarray(enc.apply({"params": p}, jnp.asarray(x)))
  sd = {}
  convert._impala_from_flax(sd, "e", p)
  te = tbase.ImpalaEncoder(4)
  te.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
  with torch.no_grad():
    got = te(torch.tensor(x)).numpy()
  assert got.shape == ref.shape == (3, tbase.impala_out_dim((4, 64, 64)))
  np.testing.assert_allclose(got, ref, **FWD)


@pytest.fixture(scope="module")
def nets():
  flax_net = jac.ImpalaFuseResidualActorCritic(**WIDTHS)
  rng = np.random.default_rng(2)
  obs = np.concatenate([rng.normal(size=(4, STATE)),
                        rng.uniform(0, 1, size=(4, OBS - STATE))],
                       -1).astype(np.float32)
  params = flax_net.init(jax.random.PRNGKey(3), jnp.asarray(obs[:1]))
  net = tac.ImpalaFuseResidualActorCritic(**WIDTHS)
  net.load_state_dict(convert.params_from_flax(_np(params)), strict=True)
  return flax_net, params, net, obs


def test_model_pi_v_and_aux_loss_match_flax(nets):
  flax_net, params, net, obs = nets
  x = jnp.asarray(obs)
  (ref_pi, ref_aux) = flax_net.apply(params, x, method=flax_net.pi_with_aux)
  ref_v = flax_net.apply(params, x, method=flax_net.v)
  with torch.no_grad():
    got_pi, got_aux = net.pi_with_aux(torch.tensor(obs))
    got_v = net.v(torch.tensor(obs))
    got_pi_only = net.pi(torch.tensor(obs))
  for r, g, h in zip(ref_pi, got_pi, got_pi_only):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD)
    assert torch.equal(g, h)
  np.testing.assert_allclose(float(got_aux), float(ref_aux), **FWD)
  np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), **FWD)
  assert float(got_aux) > 0


def test_param_labels_split_the_impala_model(nets):
  from vision4leg_tpu.algo.on_policy_base import param_labels as jlabels
  _, params, net, _ = nets
  assert param_labels(net) == jlabels(params)
  assert param_labels(net)["visual_base"] == "both"
  assert param_labels(net)["aux_head"] == "pf"


def test_seeded_init_draws_every_weight():
  a = tac.ImpalaFuseResidualActorCritic(
      **WIDTHS, generator=torch.Generator().manual_seed(0))
  b = tac.ImpalaFuseResidualActorCritic(
      **WIDTHS, generator=torch.Generator().manual_seed(0))
  for (n, p), q in zip(a.named_parameters(), b.parameters()):
    assert torch.equal(p, q), n
  conv = a.visual_base.convs[0]
  assert float(conv.bias.detach().abs().max()) == 0
  assert float(conv.weight.detach().abs().max()) > 0


def _trajectory(flax_net, params):
  rng = np.random.default_rng(5)
  obs = np.concatenate([0.3 * rng.normal(size=(T, E, STATE)),
                        rng.uniform(0, 1, size=(T, E, OBS - STATE))], -1)
  mean, std, _ = flax_net.apply(params, jnp.asarray(obs.reshape(T * E, -1)),
                                method=flax_net.pi)
  mean = np.asarray(mean).reshape(T, E, -1)
  std = np.asarray(std).reshape(T, E, -1)
  acts = mean + std * rng.normal(size=mean.shape)
  logp = np.sum(-0.5 * ((acts - mean) / std) ** 2 - np.log(std)
                - 0.5 * np.log(2 * np.pi), -1, keepdims=True)
  logp = logp + rng.uniform(-0.3, 0.3, logp.shape)
  terminals = np.zeros((T, E, 1), bool)
  terminals[1, 2] = True
  return dict(obs=obs, acts=acts, log_probs=logp,
              values=rng.normal(size=(T, E, 1)),
              rewards=rng.normal(size=(T, E, 1)), terminals=terminals,
              time_limits=np.zeros((T, E, 1), bool), means=mean, stds=std)


def test_ppo_aux_epoch_matches_jax():
  flax_net = jac.ImpalaFuseResidualActorCritic(**WIDTHS)
  with jax.enable_x64(True):
    params = flax_net.init(jax.random.PRNGKey(4), jnp.zeros((1, OBS)))
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    traj = _trajectory(flax_net, params)
    last_value = np.random.default_rng(6).normal(size=E)
    learner = jppo_aux.PPOAuxLearner(
        jppo_aux.PPOAuxConfig(**CFG),
        lambda p, x: flax_net.apply(p, x, method=flax_net.pi),
        lambda p, x: flax_net.apply(p, x, method=flax_net.v), params,
        apply_pi_aux=lambda p, x: flax_net.apply(
            p, x, method=flax_net.pi_with_aux))
    key = jax.random.PRNGKey(100)
    perms = np.stack([np.asarray(jax.random.permutation(k, T))
                      for k in jax.random.split(key, CFG["opt_epochs"])])
    ts, metrics = jax.jit(learner.update_per_epoch)(
        learner.init_state(params),
        JTransition(**{k: jnp.asarray(v) for k, v in traj.items()}),
        jnp.asarray(last_value), key)
    ref = convert.params_from_flax(_np(ts.params))
    ref_m = {k: float(v) for k, v in metrics.items()}
    init = convert.params_from_flax(_np(params))

  net = tac.ImpalaFuseResidualActorCritic(**WIDTHS).double()
  net.load_state_dict(init)
  tl = ppo_aux.PPOAuxLearner(
      ppo_aux.PPOAuxConfig(**CFG), lambda m, x: m.pi(x),
      lambda m, x: m.v(x), net, apply_pi_aux=lambda m, x: m.pi_with_aux(x))
  _, got_m = tl.update_per_epoch(
      tl.init_state(net),
      Transition(**{k: torch.tensor(v) for k, v in traj.items()}),
      torch.tensor(last_value), perms=perms)
  got = net.state_dict()
  for k, v in ref.items():
    np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **UPD)
  assert set(got_m) == set(ref_m)
  for k, v in ref_m.items():
    np.testing.assert_allclose(float(got_m[k]), v, err_msg=k, **UPD)
  assert ref_m["Training/aux_loss"] > 0
  assert sum(not torch.equal(init[k].double(), v) for k, v in got.items()) \
      == len(init)
