"""bf16 collection (make_rollout_fn's inference_dtype, PPOAgent's
inference_dtype) against the JAX rollout's inference_dtype=jnp.bfloat16
path (vision4leg_tpu/collector/rollout.py:105-139), on the CPU.

Both collectors take one step on the same observations (drawn with
numpy) with the same LocoTransformer weights (flax params converted by
convert.params_from_flax); a stub env hands back fixed observations, so
the behaviour stats of the step are the forward's alone.  The JAX
package holds its bf16 forward within 0.08 of the float32 one, relative
to max(|x|, 0.05) (tests/test_bf16_inference.py); the port's bf16 mean,
std and value are held to the JAX bf16 ones and to the port's float32
ones within that band.  The stored stats are float32.  The agent under
bf16 builds its collection forward with the fused layer off, logs it, and
the fused layer still refuses a bf16 input.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision4leg_tpu.collector import rollout as jroll
from vision4leg_tpu.data import normalizer as jnorm
from vision4leg_tpu.models.actor_critic import \
    LocoTransformerActorCritic as FlaxAC
from vision4leg_torch.collector import rollout as troll
from vision4leg_torch.convert import params_from_flax
from vision4leg_torch.data import normalizer as tnorm
from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
from vision4leg_torch.models.base import TransformerEncoderLayer

E = 4
STATE = 84
A = 6
WIDTHS = dict(action_dim=A, state_input_shape=STATE,
              visual_input_shape=(4, 64, 64), encoder_hidden_shapes=(32, 32),
              transformer_params=((1, 64), (1, 64)),
              append_hidden_shapes=(32, 32), token_dim=32)
BAND = 0.08


def _obs(seed=0):
  rng = np.random.default_rng(seed)
  proprio = rng.normal(size=(E, STATE))
  depth = rng.uniform(-1.5, 1.5, size=(E, 4 * 64 * 64))
  return np.concatenate([proprio, depth], 1).astype(np.float32)


class _JaxStub:
  """Hands back the same observations every step; never done."""

  def __init__(self, obs):
    self.obs = jnp.asarray(obs)

  def reset(self, key):
    return jnp.zeros(()), self.obs[0]

  def step_batch(self, states, actions):
    return states, self.obs, jnp.zeros(E), jnp.zeros(E, bool), {}


class _TorchStub:
  def __init__(self, obs):
    self.obs = torch.tensor(obs)

  def draw_for_step(self, n_env, states, gen):
    return None

  def step_from(self, states, actions, draws):
    return states, self.obs, torch.zeros(E), torch.zeros(E, dtype=bool), {}


def _jax_step(params, net, obs, dtype):
  env = _JaxStub(obs)
  lo, hi = -jnp.ones(A), jnp.ones(A)
  rollout = jax.jit(jroll.make_rollout_fn(
      env, None, lambda p, x: net.apply(p, x, method=net.v), horizon=1,
      max_episode_frames=999, discount=0.99, proprio_dim=STATE,
      obs_norm=False, action_low=lo, action_high=hi,
      apply_pi_v=lambda p, x: net.apply(p, x, method=net.pi_v),
      inference_dtype=dtype))
  cs = jroll.CollectorState(
      env_states=jnp.zeros(E), raw_obs=env.obs,
      ep_steps=jnp.zeros(E, jnp.int32), ep_return=jnp.zeros(E),
      normalizer=jnorm.init_normalizer(STATE),
      finished_returns_sum=jnp.zeros(()), finished_count=jnp.zeros(()),
      finished_len_sum=jnp.zeros(()), key=jax.random.PRNGKey(0))
  _, traj, last_v = rollout(params, cs)
  return jax.tree.map(np.asarray, (traj, last_v))


def _torch_step(module, obs, dtype):
  env = _TorchStub(obs)
  twin = module
  if dtype is not None:
    twin = LocoTransformerActorCritic(**WIDTHS).to(dtype)
  rollout = troll.make_rollout_fn(
      env, lambda x: twin.pi_v(x), lambda x: twin.v(x), horizon=1,
      max_episode_frames=999, discount=0.99, proprio_dim=STATE,
      obs_norm=False, action_low=-torch.ones(A), action_high=torch.ones(A),
      inference_dtype=dtype, weights=(module, twin))
  zero = torch.zeros(())
  cs = troll.CollectorState(
      env_states=torch.zeros(E), raw_obs=env.obs,
      ep_steps=torch.zeros(E, dtype=torch.int32), ep_return=torch.zeros(E),
      normalizer=tnorm.init_normalizer(STATE, "cpu"),
      finished_returns_sum=zero.clone(), finished_count=zero.clone(),
      finished_len_sum=zero.clone(), gen=torch.Generator().manual_seed(0))
  _, traj, last_v = rollout(cs)
  return traj, last_v, twin


@pytest.fixture(scope="module")
def steps():
  net = FlaxAC(**WIDTHS)
  obs = _obs()
  params = net.init(jax.random.PRNGKey(3), jnp.asarray(obs[:1]))
  module = LocoTransformerActorCritic(**WIDTHS)
  module.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
  j16 = _jax_step(params, net, obs, jnp.bfloat16)
  t16 = _torch_step(module, obs, torch.bfloat16)
  t32 = _torch_step(module, obs, None)
  return j16, t16, t32, module


def _within_band(got, want):
  scale = np.maximum(np.abs(want), 0.05)
  err = float(np.max(np.abs(got - want) / scale))
  assert err < BAND, err
  return err


@pytest.mark.parametrize("stat", ["means", "stds", "values"])
def test_bf16_forward_matches_the_jax_bf16_rollout(steps, stat):
  (jtraj, jlast), (ttraj, tlast, _), _, _ = steps
  _within_band(getattr(ttraj, stat)[0].numpy(), getattr(jtraj, stat)[0])
  if stat == "values":     # the bootstrap's value forward, bf16 too
    _within_band(tlast.numpy(), jlast)


def test_bf16_forward_tracks_float32(steps):
  _, (t16, _, _), (t32, _, _), _ = steps
  for stat in ("means", "stds", "values"):
    _within_band(getattr(t16, stat)[0].numpy(), getattr(t32, stat)[0].numpy())
  # bf16 did round: the two forwards are not the same bits
  assert not torch.equal(t16.means, t32.means)


def test_bf16_stats_are_float32_and_the_weights_recast(steps):
  _, (traj, last_v, twin), _, module = steps
  for x in (traj.obs, traj.acts, traj.log_probs, traj.values, traj.means,
            traj.stds, last_v):
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
  # the twin holds the module's weights cast down
  for (name, p), q in zip(module.named_parameters(), twin.parameters()):
    assert q.dtype == torch.bfloat16, name
    assert torch.equal(q, p.detach().to(torch.bfloat16)), name


def test_agent_routes_bf16_collection_to_the_unfused_layer(tmp_path):
  """PPOAgent(inference_dtype=bf16, fused_attention=True): the collection
  forward takes the unfused layer (a logged routing by dtype), a rollout
  runs, and the update's module stays float32; the fused layer itself
  refuses a bf16 input loudly."""
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.algo.ppo import PPOConfig
  from vision4leg_torch.envs.env import A1GymEnv, EnvConfig
  env = A1GymEnv(EnvConfig(
      terrain_type="plane", time_step_s=0.0025, num_action_repeat=4,
      diagonal_act=True, clip_num=(0.05, 0.5, 0.5) * 4, settle_steps=10,
      get_image=True, depth_image=True), device="cpu")
  lines = []

  class Log:
    def log(self, msg):
      lines.append(msg)

  with warnings.catch_warnings():
    warnings.simplefilter("ignore")          # the short-horizon warning
    agent = PPOAgent(
        env=env, ac_module=LocoTransformerActorCritic(
            **dict(WIDTHS, state_input_shape=env.cfg.proprio_dim)),
        cfg=PPOConfig(epoch_frames=2 * 2), num_envs=2, seed=0,
        logger=Log(), save_dir=str(tmp_path), fused_attention=True,
        fused_update=True, inference_dtype=torch.bfloat16, device="cpu")
  assert len(lines) == 1 and "models/base.py:233-238" in lines[0]
  _, traj, last_v = agent.rollout(agent.collector_state)
  assert traj.means.dtype == torch.float32 and torch.isfinite(last_v).all()
  assert next(agent.module.parameters()).dtype == torch.float32
  x = torch.zeros(2, 5, 16, dtype=torch.bfloat16)
  with pytest.raises(NotImplementedError, match="float32"):
    TransformerEncoderLayer(16, 1, 32).to(torch.bfloat16)(x, fused=True)
