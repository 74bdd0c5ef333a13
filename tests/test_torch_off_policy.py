"""The port's off-policy family against the JAX package's, on the CPU:
the networks (vision4leg_torch.models.off_policy_nets) against flax, the
tanh-normal log-prob, the discrete policies, the replay ring, every
learner's update (vision4leg_torch.algo.off_policy.learners) and the
agent loop on the port's env.

The JAX draws (the learners' Gaussian noise, the policies' random
actions, uniforms, Gumbel noise and heads, the replay's sample indices)
are reproduced with jax.random from the same keys and shapes and handed
to the port.  Tolerances: the forwards in float32 within 1e-5 (absolute
and relative); the updates in float64 on both sides (JAX under
`jax.enable_x64`) within 1e-8 on every network, target and metric; the
discrete choices and the replay exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.algo.off_policy import learners as jl
from vision4leg_tpu.data import replay as jreplay
from vision4leg_tpu.models import discrete_policies as jdp
from vision4leg_tpu.models import distributions as jdist
from vision4leg_tpu.models import off_policy_nets as jnets
from vision4leg_torch.algo.off_policy import learners as tl
from vision4leg_torch.algo.off_policy.agent import OffPolicyAgent
from vision4leg_torch.convert import off_policy_params_from_flax
from vision4leg_torch.data import replay as treplay
from vision4leg_torch.envs.env import A1GymEnv, EnvConfig
from vision4leg_torch.models import discrete_policies as tdp
from vision4leg_torch.models import distributions as tdist
from vision4leg_torch.models import off_policy_nets as tnets

FWD = dict(atol=1e-5, rtol=1e-5)
UPD = dict(atol=1e-8, rtol=1e-8)
D, A, B, NA = 10, 3, 16, 4
H = (16,)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _np(tree):
  return jax.tree.map(np.asarray, tree)


def _load(tnet, flax_params, dtype=torch.float32):
  tnet = tnet.to(dtype)
  tnet.load_state_dict(off_policy_params_from_flax(_np(flax_params)),
                       strict=True)
  return tnet


NETS = {
    "tanh_gaussian": (lambda: jnets.TanhGaussianPolicy(A, (8, 8), (5,)),
                      lambda: tnets.TanhGaussianPolicy(D, A, (8, 8), (5,)),
                      False),
    "det_tanh": (lambda: jnets.DetTanhPolicy(A, (8, 8)),
                 lambda: tnets.DetTanhPolicy(D, A, (8, 8)), False),
    "qnet": (lambda: jnets.QNet((8, 8)), lambda: tnets.QNet(D, A, (8, 8)),
             True),
    "discrete": (lambda: jnets.DiscreteQNet(NA, (8,)),
                 lambda: tnets.DiscreteQNet(D, NA, (8,)), False),
    "quantile": (lambda: jnets.DiscreteQNet(NA, (8,), num_quantiles=5),
                 lambda: tnets.DiscreteQNet(D, NA, (8,), num_quantiles=5),
                 False),
    "bootstrapped": (lambda: jnets.BootstrappedQNet(NA, 3, (8,)),
                     lambda: tnets.BootstrappedQNet(D, NA, 3, (8,)), False),
}


@pytest.mark.parametrize("name", list(NETS))
def test_net_matches_flax(name):
  jmake, tmake, with_act = NETS[name]
  rng = np.random.default_rng(0)
  # large inputs, so that the policy's logstd reaches its clamp
  args = [(4 * rng.normal(size=(6, D))).astype(np.float32)]
  if with_act:
    args.append(rng.uniform(-1, 1, size=(6, A)).astype(np.float32))
  fnet = jmake()
  p = fnet.init(jax.random.PRNGKey(1), *map(jnp.asarray, args))
  p = jax.tree.map(lambda x: x * 30 if x.ndim == 2 else x, p) \
      if name == "tanh_gaussian" else p
  ref = jax.tree.leaves(fnet.apply(p, *map(jnp.asarray, args)))
  with torch.no_grad():
    got = _load(tmake(), p)(*map(torch.tensor, args))
  got = got if isinstance(got, tuple) else (got,)
  assert len(ref) == len(got)
  for r, g in zip(ref, got):
    assert g.shape == r.shape
    np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD)
  if name == "tanh_gaussian":
    logstd = got[2]
    assert float(logstd.max()) == 2.0 and float(logstd.min()) == -5.0


def test_seeded_init_matches_the_reference_ranges():
  net = tnets.QNet(D, A, (8,), generator=torch.Generator().manual_seed(0))
  out = net.layers[-1]
  assert float(out.weight.detach().abs().max()) <= 3e-3
  assert float(out.bias.detach().abs().max()) <= 3e-3
  assert torch.all(net.base.layers[0].bias == 0.1)


def test_tanh_normal_log_prob_matches_jax():
  rng = np.random.default_rng(2)
  mean, noise = rng.normal(size=(2, 7, A))
  std = np.exp(0.4 * rng.normal(size=(7, A)))
  with jax.enable_x64(True):
    key = jax.random.PRNGKey(3)
    a_ref, z_ref, lp_ref = map(np.asarray, jdist.sample_with_log_prob(
        key, jnp.asarray(mean), jnp.asarray(std)))
    n_ref = np.asarray(jax.random.normal(key, mean.shape))
    lp_el = np.asarray(jdist.log_prob(*map(jnp.asarray,
                                           (mean, std, a_ref, z_ref))))
  a, z, lp = tdist.sample_with_log_prob(torch.tensor(mean),
                                        torch.tensor(std),
                                        noise=torch.tensor(n_ref))
  for r, g in ((a_ref, a), (z_ref, z), (lp_ref, lp)):
    np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-12)
  np.testing.assert_allclose(
      tdist.log_prob(*map(torch.tensor, (mean, std, a_ref, z_ref))).numpy(),
      lp_el, rtol=1e-12, atol=1e-12)
  assert lp.shape == (7, 1)
  _, z2, _ = tdist.sample_with_log_prob(
      torch.tensor(mean), torch.tensor(std),
      gen=torch.Generator().manual_seed(0))
  assert not torch.equal(z2, z)


def test_discrete_policies_match_jax():
  rng = np.random.default_rng(4)
  q = rng.normal(size=(64, NA)).astype(np.float32)
  heads = rng.normal(size=(64, 5, NA)).astype(np.float32)
  key = jax.random.PRNGKey(5)
  k1, k2 = jax.random.split(key)
  eps = 0.5
  ref = np.asarray(jdp.epsilon_greedy(key, jnp.asarray(q), eps))
  draws = (torch.tensor(np.asarray(jax.random.randint(k1, (64,), 0, NA))),
           torch.tensor(np.asarray(jax.random.uniform(k2, (64,)))))
  got = tdp.epsilon_greedy(torch.tensor(q), eps, draws=draws)
  np.testing.assert_array_equal(got.numpy(), ref)
  assert (ref != q.argmax(-1)).any() and (ref == q.argmax(-1)).any()

  ref = np.asarray(jdp.boltzmann(key, jnp.asarray(q), 0.7))
  g = np.asarray(jax.random.gumbel(key, q.shape))
  got = tdp.boltzmann(torch.tensor(q), 0.7, gumbel=torch.tensor(g))
  np.testing.assert_array_equal(got.numpy(), ref)

  ref = np.asarray(jdp.bootstrapped_head(key, jnp.asarray(heads)))
  head = int(jax.random.randint(key, (), 0, 5))
  got = tdp.bootstrapped_head(torch.tensor(heads), head_idx=head)
  np.testing.assert_array_equal(got.numpy(), ref)
  np.testing.assert_array_equal(
      tdp.eval_greedy(torch.tensor(q)).numpy(),
      np.asarray(jdp.eval_greedy(jnp.asarray(q))))

  gen = torch.Generator().manual_seed(0)
  for fn in (lambda: tdp.epsilon_greedy(torch.tensor(q), 1.0, gen=gen),
             lambda: tdp.boltzmann(torch.tensor(q), 1.0, gen=gen),
             lambda: tdp.bootstrapped_head(torch.tensor(heads), gen=gen)):
    a = fn()
    assert a.shape == (64,) and int(a.min()) >= 0 and int(a.max()) < NA


def test_replay_wraps_and_saturates_as_jax():
  rb = treplay.init_replay(32, {"obs": torch.zeros(4),
                                "acts": torch.zeros(2)})
  jrb = jreplay.init_replay(32, {"obs": jnp.zeros(4), "acts": jnp.zeros(2)})
  for i in range(5):
    batch = {"obs": np.full((10, 4), i, np.float32),
             "acts": np.full((10, 2), i, np.float32)}
    rb = treplay.add_batch(rb, {k: torch.tensor(v)
                                for k, v in batch.items()})
    jrb = jreplay.add_batch(jrb, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    assert rb.size == int(jrb.size) == min(10 * (i + 1), 32)
    assert rb.pos == int(jrb.pos)
  for k in ("obs", "acts"):
    np.testing.assert_array_equal(rb.data[k].numpy(), np.asarray(jrb.data[k]))
  assert rb.pos == 18 and rb.data["obs"][8, 0] == 4 and \
      rb.data["obs"][0, 0] == 3
  key = jax.random.PRNGKey(7)
  ref = jreplay.sample(jrb, key, 16)
  idx = torch.tensor(np.asarray(jax.random.randint(key, (16,), 0, 32)))
  got = treplay.sample(rb, 16, idx=idx)
  for k in ("obs", "acts"):
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
  drawn = treplay.sample(rb, 16, gen=torch.Generator().manual_seed(0))
  assert drawn["obs"].shape == (16, 4)
  empty = treplay.init_replay(8, {"x": torch.zeros(1)})
  assert treplay.sample(empty, 4, gen=torch.Generator())["x"].shape == (4, 1)


# ---------------------------------------------------------------------------
# the learners' updates, float64, with the JAX draws injected
# ---------------------------------------------------------------------------

def _batches(n, discrete=False, seed=8):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    acts = (rng.integers(0, NA, size=(B,)) if discrete
            else rng.uniform(-0.9, 0.9, size=(B, A)))
    out.append({"obs": rng.normal(size=(B, D)), "acts": acts,
                "next_obs": rng.normal(size=(B, D)),
                "rewards": rng.normal(size=(B, 1)),
                "terminals": (rng.uniform(size=(B, 1)) < 0.2).astype(
                    np.float64)})
    if discrete:
      out[-1]["masks"] = (rng.uniform(size=(B, 3)) < 0.7).astype(np.float64)
  return out


def _draws(name, key):
  if name in ("twin_sac_q",):
    k1, k2 = jax.random.split(key)
    return {"noise": jax.random.normal(k1, (B, A)),
            "next_noise": jax.random.normal(k2, (B, A))}
  if name in ("td3", "sac", "twin_sac"):
    return {"noise": jax.random.normal(key, (B, A))}
  return None


def _case(name, cfg):
  """(JAX learner, its initial state, torch learner, its state, the flax
  params tree of each network) at float64."""
  pf_j = jnets.TanhGaussianPolicy(A, H)
  det_j = jnets.DetTanhPolicy(A, H)
  q_j, v_j = jnets.QNet(H), jnets.QNet(H)
  k = jax.random.PRNGKey(0)
  obs0, act0 = jnp.zeros((1, D)), jnp.zeros((1, A))
  f64 = lambda p: jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), p)
  init = lambda net, i, *a: f64(net.init(jax.random.fold_in(k, i), *a))
  tq = lambda p: _load(tnets.QNet(D, A, H), p, torch.float64)
  apply_q = lambda m, o, a: m(o, a)
  if name in ("twin_sac_q", "sac", "twin_sac"):
    pf_p = init(pf_j, 0, obs0)
    tpf = _load(tnets.TanhGaussianPolicy(D, A, H), pf_p, torch.float64)
  if name == "twin_sac_q":
    q1, q2 = init(q_j, 1, obs0, act0), init(q_j, 2, obs0, act0)
    jlr = jl.TwinSACQLearner(cfg, pf_j.apply, q_j.apply, A)
    tlr = tl.TwinSACQLearner(cfg, lambda m, o: m(o), apply_q, A)
    return (jlr, jlr.init_state(pf_p, q1, q2), tlr,
            tlr.init_state(tpf, tq(q1), tq(q2)))
  if name in ("td3", "ddpg"):
    pf_p = init(det_j, 0, obs0)
    tpf = _load(tnets.DetTanhPolicy(D, A, H), pf_p, torch.float64)
    q1 = init(q_j, 1, obs0, act0)
    if name == "td3":
      q2 = init(q_j, 2, obs0, act0)
      jlr = jl.TD3Learner(cfg, det_j.apply, q_j.apply)
      tlr = tl.TD3Learner(cfg, lambda m, o: m(o), apply_q)
      return (jlr, jlr.init_state(pf_p, q1, q2), tlr,
              tlr.init_state(tpf, tq(q1), tq(q2)))
    jlr = jl.DDPGLearner(cfg, det_j.apply, q_j.apply)
    tlr = tl.DDPGLearner(cfg, lambda m, o: m(o), apply_q)
    return jlr, jlr.init_state(pf_p, q1), tlr, tlr.init_state(tpf, tq(q1))
  if name in ("sac", "twin_sac"):
    twin = name == "twin_sac"
    vnet = jnets.DiscreteQNet(1, H)   # a V(s) head: one output
    q1, vf = init(q_j, 1, obs0, act0), init(vnet, 3, obs0)
    q2 = init(q_j, 2, obs0, act0) if twin else None
    jlr = jl.SACLearner(cfg, pf_j.apply, q_j.apply, vnet.apply, A,
                        twin=twin)
    tlr = tl.SACLearner(cfg, lambda m, o: m(o), apply_q, lambda m, o: m(o),
                        A, twin=twin)
    tv = _load(tnets.DiscreteQNet(D, 1, H), vf, torch.float64)
    return (jlr, jlr.init_state(pf_p, q1, vf, q2), tlr,
            tlr.init_state(tpf, tq(q1), tv, tq(q2) if twin else None))
  mode = name.split("_")[1]
  if mode == "qrdqn":
    jnet = jnets.DiscreteQNet(NA, H, num_quantiles=cfg.num_quantiles)
    tnet = tnets.DiscreteQNet(D, NA, H, num_quantiles=cfg.num_quantiles)
  elif mode == "bootstrapped":
    jnet, tnet = (jnets.BootstrappedQNet(NA, 3, H),
                  tnets.BootstrappedQNet(D, NA, 3, H))
  else:
    jnet, tnet = jnets.DiscreteQNet(NA, H), tnets.DiscreteQNet(D, NA, H)
  qp = init(jnet, 4, obs0)
  jlr = jl.DQNLearner(cfg, jnet.apply, mode=mode)
  tlr = tl.DQNLearner(cfg, lambda m, o: m(o), mode=mode)
  return jlr, jlr.init_state(qp), tlr, tlr.init_state(
      _load(tnet, qp, torch.float64))


LEARNER_CASES = {
    "twin_sac_q": {},
    "twin_sac_q_fixed_alpha_hard": dict(automatic_entropy_tuning=False,
                                        use_soft_update=False,
                                        target_hard_update_period=2),
    "td3": dict(tau=0.05),
    "td3_hard": dict(use_soft_update=False, target_hard_update_period=3),
    "ddpg": dict(tau=0.05),
    "dqn_dqn": dict(use_soft_update=False, target_hard_update_period=2),
    "dqn_qrdqn": dict(num_quantiles=5, tau=0.1),
    "dqn_bootstrapped": dict(tau=0.1),
    "sac": dict(tau=0.05),
    "twin_sac": dict(automatic_entropy_tuning=False, tau=0.05),
}
N_UPDATES = 3


@pytest.mark.parametrize("case", list(LEARNER_CASES))
def test_learner_updates_match_jax(case):
  name = case.replace("_fixed_alpha_hard", "").replace("_hard", "")
  cfg = tl.OffPolicyConfig(**LEARNER_CASES[case])
  jcfg = jl.OffPolicyConfig(**dataclasses.asdict(cfg))
  discrete = name.startswith("dqn")
  batches = _batches(N_UPDATES, discrete)
  with jax.enable_x64(True):
    jlr, js, tlr, ts = _case(name, jcfg)
    tlr.cfg = cfg
    for i, batch in enumerate(batches):
      key = jax.random.PRNGKey(20 + i)
      jb = {k: jnp.asarray(v) for k, v in batch.items()}
      js, jm = jlr.update(js, jb, key)
      draws = _draws(name, key)
      draws = None if draws is None else {
          k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
      ts, tm = tlr.update(ts, {k: torch.tensor(v) for k, v in batch.items()},
                          draws=draws)
      assert set(tm) == set(jm)
      for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), err_msg=k, **UPD)
    js = jax.tree.map(np.asarray, (js.params, js.target_params,
                                   js.update_count, js.extras))
  assert ts.update_count == int(js[2]) == N_UPDATES
  for side, trees in (("params", ts.params), ("targets", ts.target_params)):
    ref_trees = js[0] if side == "params" else js[1]
    assert set(trees) == set(ref_trees)
    for net_name, module in trees.items():
      ref = off_policy_params_from_flax(ref_trees[net_name])
      for k, v in module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(),
                                   err_msg=f"{side} {net_name} {k}", **UPD)
  if name in ("twin_sac_q", "sac") and cfg.automatic_entropy_tuning:
    np.testing.assert_allclose(float(ts.extras["log_alpha"]),
                               float(js[3]["log_alpha"]), **UPD)
    assert float(ts.extras["log_alpha"]) != 0


def test_td3_policy_delay_and_gated_targets():
  """The first update steps the policy and moves the targets, the second
  (count 2, delay 2) leaves both."""
  cfg = tl.OffPolicyConfig(tau=0.5)
  with jax.enable_x64(True):
    _, _, tlr, ts = _case("td3", jl.OffPolicyConfig(tau=0.5))
  tlr.cfg = cfg
  snap = lambda m: [p.detach().clone() for p in m.parameters()]
  batch = {k: torch.tensor(v) for k, v in _batches(1)[0].items()}
  gen = torch.Generator().manual_seed(0)
  pf0, tpf0 = snap(ts.params["pf"]), snap(ts.target_params["pf"])
  ts, _ = tlr.update(ts, batch, gen)
  pf1, tpf1 = snap(ts.params["pf"]), snap(ts.target_params["pf"])
  assert not torch.equal(pf0[0], pf1[0]) and not torch.equal(tpf0[0],
                                                             tpf1[0])
  ts, _ = tlr.update(ts, batch, gen)
  assert all(torch.equal(a, b) for a, b in zip(pf1, snap(ts.params["pf"])))
  assert all(torch.equal(a, b) for a, b in
             zip(tpf1, snap(ts.target_params["pf"])))
  assert ts.opt_states["pf"].count == 1 and ts.opt_states["qf1"].count == 2


def test_off_policy_agent_loop():
  """tests/test_algo.py::test_off_policy_agent_loop on the port's env at 4
  envs: pretrain fills the replay with 32 transitions of random
  exploration, then each env step makes one update from a uniform
  sample; two epochs of 8 steps take update_count to 8, then 16."""
  env = A1GymEnv(EnvConfig(
      motor_control_mode="POSITION", clip_num=(0.05, 0.5, 0.5) * 4,
      time_step_s=0.0025, num_action_repeat=4, add_last_action_input=True,
      no_displacement=True, diagonal_act=True, alive_reward=-0.05,
      terrain_type="plane", settle_steps=20), device="cpu")
  obs_dim, act_dim = env.obs_dim, env.cfg.action_dim
  gen = torch.Generator().manual_seed(0)
  pf = tnets.TanhGaussianPolicy(obs_dim, act_dim, (32,), generator=gen)
  q1 = tnets.QNet(obs_dim, act_dim, (32,), generator=gen)
  q2 = tnets.QNet(obs_dim, act_dim, (32,), generator=gen)
  learner = tl.TwinSACQLearner(tl.OffPolicyConfig(batch_size=16),
                               lambda m, o: m(o), lambda m, o, a: m(o, a),
                               act_dim)
  agent = OffPolicyAgent(env=env, learner=learner,
                         learner_state=learner.init_state(pf, q1, q2),
                         apply_pf=lambda m, o: m(o), num_envs=4,
                         replay_capacity=512, seed=0, pretrain_frames=32,
                         max_episode_frames=16, device="cpu")
  agent.pretrain()
  assert agent.replay.size == 32
  assert agent.collector_state.total_frames == 32
  acts = agent.replay.data["acts"][:32]
  assert float(acts.abs().max()) <= 1.0 and float(acts.std()) > 0.3
  w0 = pf.layers[-1].weight.detach().clone()
  avg_rew, infos = agent.train_epoch(epoch_frames=32)
  assert np.isfinite(avg_rew)
  for key, v in infos.items():
    assert np.isfinite(v), key
  assert agent.learner_state.update_count == 8
  agent.train_epoch(epoch_frames=32)
  assert agent.learner_state.update_count == 16
  assert agent.replay.size == 96
  assert not torch.equal(w0, pf.layers[-1].weight)
  # episodes of 16 steps: the time-limit resets leave terminals unmarked
  # unless the robot fell
  assert set(np.unique(agent.replay.data["terminals"][:96].numpy())) <= {0, 1}
