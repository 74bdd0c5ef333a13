"""The port's hierarchical, host and Atari collectors
(vision4leg_torch.collector.hierarchical, host, atari) against the JAX
package's, on the CPU.

  * hierarchical: the two-level act path against JAX's on the same
    observations, weights (converted by params_from_flax) and high-level
    noise (jax.random.normal of the same key), float32 within 1e-5
    (absolute and relative); then tests/test_hierarchical.py's rollout and
    PPO epoch on the port's env at 4 envs (plane, settle cut to 20
    substeps);
  * host: HostOnPolicyCollector on gymnasium's Pendulum-v1 with 4
    synchronous envs against the JAX collector, the same seeds, weights
    and action noise (the JAX collector's key splits, injected), 20 steps
    with the time limit at 10: every field of the trajectory and the
    bootstrap within 1e-4 (float32 policies in two frameworks, and the
    pendulum integrating their actions);
  * Atari: the DeepMind wrappers on the synthetic ALE-like env of
    tests/test_atari.py against the JAX package's, observations, rewards
    and ends equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

from test_atari import FakeAtariEnv  # noqa: E402
from vision4leg_tpu.collector import atari as jatari  # noqa: E402
from vision4leg_tpu.collector import hierarchical as jhier  # noqa: E402
from vision4leg_tpu.collector import host as jhost  # noqa: E402
from vision4leg_tpu.models import actor_critic as jac  # noqa: E402
from vision4leg_torch.algo.ppo import PPOConfig, PPOLearner  # noqa: E402
from vision4leg_torch.collector import atari as tatari  # noqa: E402
from vision4leg_torch.collector import hierarchical  # noqa: E402
from vision4leg_torch.collector import host  # noqa: E402
from vision4leg_torch.collector import rollout as rollout_lib  # noqa: E402
from vision4leg_torch.convert import params_from_flax  # noqa: E402
from vision4leg_torch.envs.env import A1GymEnv, EnvConfig  # noqa: E402
from vision4leg_torch.models.actor_critic import \
    StateActorCritic  # noqa: E402

ACT = dict(atol=1e-5, rtol=1e-5)
HOST = dict(atol=1e-4, rtol=1e-4)
NUM_ENVS, HORIZON = 4, 8
WIDTHS = dict(hidden_shapes=(32, 32), append_hidden_shapes=(32, 32))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _pair(action_dim, obs_dim, seed):
  """A flax StateActorCritic and the port's with its weights."""
  fnet = jac.StateActorCritic(action_dim=action_dim, **WIDTHS)
  params = fnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
  net = StateActorCritic(action_dim, obs_dim, **WIDTHS)
  net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
  return fnet, params, net


def _env():
  return A1GymEnv(EnvConfig(
      motor_control_mode="POSITION", clip_num=(0.05, 0.5, 0.5) * 4,
      time_step_s=0.0025, num_action_repeat=4, add_last_action_input=True,
      no_displacement=True, diagonal_act=True, terrain_type="plane",
      settle_steps=20), device="cpu")


def test_hierarchical_act_matches_jax():
  env = _env()
  proprio, obs_dim = env.cfg.proprio_dim, env.obs_dim
  flow, low_p, tlow = _pair(6, proprio + 2, 0)
  fhigh, high_p, thigh = _pair(1, obs_dim, 1)
  lo, hi = np.asarray(env.action_low), np.asarray(env.action_high)
  act = jhier.make_hierarchical_act_fn(
      lambda p, x: fhigh.apply(p, x, method=fhigh.pi),
      lambda p, x: flow.apply(p, x, method=flow.pi), low_p, proprio,
      jnp.asarray(lo), jnp.asarray(hi))
  obs = np.random.default_rng(0).normal(size=(6, obs_dim)).astype(
      np.float32)
  key = jax.random.PRNGKey(3)
  ref = [np.asarray(x) for x in act(high_p, jnp.asarray(obs), key)]
  noise = torch.tensor(np.asarray(jax.random.normal(key, (6, 1))))
  tact = hierarchical.make_hierarchical_act_fn(
      thigh.pi, tlow.pi, proprio, torch.tensor(lo), torch.tensor(hi))
  with torch.no_grad():
    got = tact(torch.tensor(obs), None, noise=noise)
  for name, r, g in zip(("act", "logp", "env_act", "mean", "std"), ref, got):
    assert g.shape == r.shape, name
    np.testing.assert_allclose(g.numpy(), r, err_msg=name, **ACT)
  assert got[0].shape == (6, 1) and got[2].shape == (6, 6)
  assert np.all(got[2].numpy() >= lo - 1e-6) and np.all(
      got[2].numpy() <= hi + 1e-6)


def test_hierarchical_ppo_epoch():
  """tests/test_hierarchical.py on the port: the buffer holds the 1-dim
  high-level actions, and one PPO epoch moves the high level."""
  env = _env()
  proprio = env.cfg.proprio_dim
  gen = torch.Generator().manual_seed(0)
  low = StateActorCritic(6, proprio + 2, **WIDTHS, generator=gen)
  high = StateActorCritic(1, env.obs_dim, **WIDTHS, generator=gen)
  rollout = hierarchical.make_hierarchical_rollout_fn(
      env, high.pi, high.v, low.pi, horizon=HORIZON, max_episode_frames=6,
      discount=0.99, proprio_dim=proprio, obs_norm=True)
  low0 = {k: v.clone() for k, v in low.state_dict().items()}
  cs = rollout_lib.init_collector(env, NUM_ENVS,
                                  torch.Generator().manual_seed(2))
  cs, traj, last_value = rollout(cs)
  assert traj.acts.shape == (HORIZON, NUM_ENVS, 1)
  assert traj.means.shape == traj.stds.shape == (HORIZON, NUM_ENVS, 1)
  assert torch.isfinite(traj.log_probs).all()
  assert torch.isfinite(traj.rewards).all()
  assert traj.terminals[5].all()    # max_episode_frames 6
  cfg = PPOConfig(plr=1e-3, vlr=1e-3, opt_epochs=1, batch_size=16,
                  epoch_frames=HORIZON * NUM_ENVS, max_episode_frames=6,
                  num_epochs=2)
  learner = PPOLearner(cfg, lambda m, x: m.pi(x), lambda m, x: m.v(x), high)
  before = {k: v.clone() for k, v in high.state_dict().items()}
  _, metrics = learner.update_per_epoch(learner.init_state(high), traj,
                                        last_value,
                                        gen=torch.Generator().manual_seed(3))
  assert np.isfinite(float(metrics["Training/policy_loss"]))
  assert np.isfinite(float(metrics["Training/vf_loss"]))
  assert any(not torch.equal(v, before[k])
             for k, v in high.state_dict().items())
  assert all(torch.equal(v, low0[k]) for k, v in low.state_dict().items())


def test_host_collector_pendulum_matches_jax():
  fnet, params, net = _pair(1, 3, 0)
  H_, max_ep = 20, 10
  jenv = jhost.make_vec_env("Pendulum-v1", NUM_ENVS, asynchronous=False)
  jcoll = jhost.HostOnPolicyCollector(
      jenv, lambda p, x: fnet.apply(p, x, method=fnet.pi),
      lambda p, x: fnet.apply(p, x, method=fnet.v),
      max_episode_frames=max_ep)
  key, noise = jcoll.key, []
  for _ in range(H_):
    key, k = jax.random.split(key)
    noise.append(np.asarray(jax.random.normal(k, (NUM_ENVS, 1))))
  ref, ref_last = jcoll.collect(params, horizon=H_)
  tenv = host.make_vec_env("Pendulum-v1", NUM_ENVS, asynchronous=False)
  tcoll = host.HostOnPolicyCollector(tenv, net.pi, net.v,
                                     max_episode_frames=max_ep,
                                     device="cpu",
                                     noise_fn=lambda i: noise[i])
  got, last = tcoll.collect(horizon=H_)
  assert got.obs.shape == (H_, NUM_ENVS, 3)
  for name in got._fields:
    r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
    assert g.shape == r.shape, name
    np.testing.assert_allclose(g, r, err_msg=name, **HOST)
  np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **HOST)
  assert got.terminals[max_ep - 1].all() and not got.terminals[0].any()
  assert tcoll.train_rews == pytest.approx(jcoll.train_rews, rel=1e-4)
  # without injected noise the collector draws from its generator
  own = host.HostOnPolicyCollector(
      host.make_vec_env("Pendulum-v1", NUM_ENVS, asynchronous=False),
      net.pi, net.v, device="cpu")
  t2, _ = own.collect(horizon=2)
  assert torch.isfinite(t2.acts).all()


ATARI_STACKS = {
    "max_and_skip": lambda m, e: m.MaxAndSkipEnv(e, skip=4),
    "episodic_life": lambda m, e: m.EpisodicLifeEnv(e),
    "noop_reset": lambda m, e: m.NoopResetEnv(e, noop_max=7),
    "warp_frame_stack": lambda m, e: m.FrameStack(m.WarpFrame(e), k=4),
    "scaled_clipped": lambda m, e: m.ClipRewardEnv(m.ScaledFloatFrame(
        m.WarpFrame(e))),
    "deepmind": lambda m, e: m.wrap_deepmind(e, frame_stack=True, scale=True,
                                             clip_rewards=True),
}


@pytest.mark.parametrize("stack", list(ATARI_STACKS))
def test_atari_wrappers_match_jax(stack):
  make = ATARI_STACKS[stack]
  envs = [make(m, FakeAtariEnv()) for m in (jatari, tatari)]
  for e in envs:
    # the fake's reset takes no seed: seed the no-op draws alike
    e.unwrapped.np_random, _ = gymnasium.utils.seeding.np_random(0)
  outs = [e.reset(seed=0)[0] for e in envs]
  np.testing.assert_array_equal(outs[1], outs[0])
  assert outs[1].dtype == outs[0].dtype
  actions = np.random.default_rng(0).integers(0, 4, size=40)
  for a in actions:
    steps = [e.step(int(a)) for e in envs]
    np.testing.assert_array_equal(steps[1][0], steps[0][0])
    assert steps[1][1:4] == steps[0][1:4]
    if steps[0][2] or steps[0][3]:
      outs = [e.reset()[0] for e in envs]
      np.testing.assert_array_equal(outs[1], outs[0])
  assert type(envs[1]).__module__ == "vision4leg_torch.collector.atari"
