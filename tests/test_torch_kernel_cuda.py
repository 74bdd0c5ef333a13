"""The CUDA physics-window kernel against its plain PyTorch version, on
the card (skipped without one: run `python -m pytest tests/ -m cuda` on
the card).  The comparison is `physics_kernel.compare_with_plain`.  The
kernel runs one warp per env, four envs a block: 101 and 6 envs end in a
ragged block, 8 is eval's batch."""
import numpy as np
import pytest
import torch

from vision4leg_torch.ops import physics_kernel as pk
from vision4leg_torch.physics import engine
from vision4leg_torch.robots import a1, a1_model


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_sph", [0, 2])
def test_kernel_matches_plain(cuda, n_sph):
  E = 101                      # three full warps and a ragged one
  rng = np.random.default_rng(0)
  model = a1_model.build(dt=0.0025, device=cuda)
  t = lambda x: torch.tensor(np.asarray(x, np.float32), device=cuda)
  q0 = np.array([0, 0.9, -1.8] * 4, np.float32)
  phys = engine.PhysState(
      pos=t(np.c_[rng.uniform(-0.1, 0.1, (E, 2)), np.full(E, 0.27)]),
      quat=t(np.tile([1.0, 0, 0, 0], (E, 1))),
      joint_q=t(q0 + rng.uniform(-0.1, 0.1, (E, 12))),
      ang=t(rng.normal(0, 0.2, (E, 3))), lin=t(rng.normal(0, 0.2, (E, 3))),
      joint_qd=t(rng.normal(0, 0.5, (E, 12))))
  rs = a1.init_robot_state(phys)
  dyn = a1.DynamicsParams(
      kp=t(np.full((E, 12), 60.0)), kd=t(np.full((E, 12), 0.6)),
      strength_ratios=t(rng.uniform(0.8, 1.2, (E, 12))),
      motor_friction=t(rng.uniform(0, 0.05, E)),
      joint_friction=t(rng.uniform(0, 0.05, E)),
      control_latency=t(np.zeros(E)), lateral_friction=t(np.ones(E)),
      mass_scale=t(rng.uniform(0.8, 1.2, (E, 13))),
      inertia_scale=t(rng.uniform(0.5, 1.5, (E, 13))))
  boxes = np.zeros((E, 8, 8), np.float32)
  boxes[:, 0] = [0.15, 0.0, 0.05, 0.1, 0.1, 0.05, 0.3, 1.0]
  spheres = np.zeros((E, n_sph, 5), np.float32)
  if n_sph:
    spheres[:, 0] = [-0.18, 0.13, 0.0, 0.12, 1.0]
  cmd = t(q0 + rng.uniform(-0.3, 0.3, (E, 12)))
  args = (model, rs, cmd, dyn, t(boxes), t(spheres), t(np.ones(E)),
          t(np.ones(E)), 16)
  before = pk.robot_window.launches
  pk.robot_window(*args)
  torch.cuda.synchronize()
  assert pk.robot_window.launches == before + 1
  ok, report = pk.compare_with_plain(args)
  assert ok, report


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
  model = a1_model.build(device=cuda)
  E = 32
  rs = a1.init_robot_state(engine.zero_state(model, (E,)))
  dyn = a1.default_dynamics(model, (E,))
  ok = (model, rs, torch.zeros(E, 12, device=cuda), dyn,
        torch.zeros(E, 8, 8, device=cuda), torch.zeros(E, 0, 5, device=cuda),
        torch.ones(E, device=cuda), torch.ones(E, device=cuda), 16)
  bad = list(ok)
  bad[2] = torch.zeros(E, 12, device=cuda, dtype=torch.float64)
  with pytest.raises(TypeError, match="float32 like pos"):
    pk.robot_window(*bad)
  bad = list(ok)
  bad[6] = torch.ones(E)
  with pytest.raises(ValueError, match="cpu"):
    pk.robot_window(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub", [5, 16])
def test_hybrid_kernel_matches_plain(cuda, n_sub):
  """Hybrid mode (the MPC env's window: torque = (1-mask) PD + mask
  tau_ff) on a batch whose stance mask mixes stance and swing legs in
  every env."""
  E = 101
  rng = np.random.default_rng(1)
  model = a1_model.build(dt=0.001, device=cuda)
  t = lambda x: torch.tensor(np.asarray(x, np.float32), device=cuda)
  q0 = np.array([0, 0.9, -1.8] * 4, np.float32)
  phys = engine.PhysState(
      pos=t(np.c_[rng.uniform(-0.1, 0.1, (E, 2)), np.full(E, 0.27)]),
      quat=t(np.tile([1.0, 0, 0, 0], (E, 1))),
      joint_q=t(q0 + rng.uniform(-0.1, 0.1, (E, 12))),
      ang=t(rng.normal(0, 0.2, (E, 3))), lin=t(rng.normal(0, 0.2, (E, 3))),
      joint_qd=t(rng.normal(0, 0.5, (E, 12))))
  dyn = a1.default_dynamics(model, (E,))
  boxes = np.zeros((E, 8, 8), np.float32)
  boxes[:, 0] = [0.15, 0.0, 0.05, 0.1, 0.1, 0.05, 0.3, 1.0]
  legs = rng.uniform(size=(E, 4)) < 0.5
  legs[:, 0], legs[:, 1] = True, False
  mask = t(np.repeat(legs, 3, axis=1))
  tau_ff = t(rng.uniform(-8.0, 8.0, (E, 12)))
  cmd = t(q0 + rng.uniform(-0.3, 0.3, (E, 12)))
  args = (model, a1.init_robot_state(phys), cmd, dyn, t(boxes),
          torch.zeros(E, 0, 5, device=cuda), t(np.ones(E)), t(np.ones(E)),
          n_sub, False, tau_ff, mask)
  before = pk.robot_window.launches
  new, _ = pk.robot_window(*args)
  torch.cuda.synchronize()
  assert pk.robot_window.launches == before + 1
  assert torch.equal(new.observed_torques[mask > 0.5], tau_ff[mask > 0.5])
  ok, report = pk.compare_with_plain(args)
  assert ok, report


def _batch(cuda, E, seed, hybrid):
  """E standing envs near a box and a sphere, commands within 0.3 rad of
  the standing pose; in hybrid mode 5 substeps of the MPC env's model
  with feedforward torques under masks that mix stance and swing legs."""
  rng = np.random.default_rng(seed)
  model = a1_model.build(dt=0.001 if hybrid else 0.0025, device=cuda)
  t = lambda x: torch.tensor(np.asarray(x, np.float32), device=cuda)
  q0 = np.array([0, 0.9, -1.8] * 4, np.float32)
  phys = engine.PhysState(
      pos=t(np.c_[rng.uniform(-0.1, 0.1, (E, 2)), np.full(E, 0.27)]),
      quat=t(np.tile([1.0, 0, 0, 0], (E, 1))),
      joint_q=t(q0 + rng.uniform(-0.1, 0.1, (E, 12))),
      ang=t(rng.normal(0, 0.2, (E, 3))), lin=t(rng.normal(0, 0.2, (E, 3))),
      joint_qd=t(rng.normal(0, 0.5, (E, 12))))
  boxes = np.zeros((E, 8, 8), np.float32)
  boxes[:, 0] = [0.15, 0.0, 0.05, 0.1, 0.1, 0.05, 0.3, 1.0]
  spheres = np.zeros((E, 2, 5), np.float32)
  spheres[:, 0] = [-0.18, 0.13, 0.0, 0.12, 1.0]
  cmd = t(q0 + rng.uniform(-0.3, 0.3, (E, 12)))
  args = (model, a1.init_robot_state(phys), cmd,
          a1.default_dynamics(model, (E,)), t(boxes), t(spheres),
          t(np.ones(E)), t(np.ones(E)))
  if not hybrid:
    return args + (16, True)
  legs = rng.uniform(size=(E, 4)) < 0.5
  legs[:, 0], legs[:, 1] = True, False
  return args + (5, False, t(rng.uniform(-8.0, 8.0, (E, 12))),
                 t(np.repeat(legs, 3, axis=1)))


@pytest.mark.cuda
@pytest.mark.parametrize("E", [8, 6, 1])
@pytest.mark.parametrize("hybrid", [False, True])
def test_kernel_matches_plain_on_small_batches(cuda, E, hybrid):
  """Eval's batch (8 envs), a ragged block (6) and one env, in both
  modes."""
  args = _batch(cuda, E, seed=E, hybrid=hybrid)
  ok, report = pk.compare_with_plain(args)
  assert ok, report


def _bits(x):
  return x.contiguous().view(torch.int64 if x.dtype == torch.float64
                             else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid", [False, True])
def test_kernel_calls_give_the_same_bits(cuda, hybrid):
  """Two calls on the same inputs give the same bits, float32 and
  float64."""
  args = _batch(cuda, 101, seed=3, hybrid=hybrid)
  for a in (args, tuple(pk._double(x) for x in args)):
    one, two = (pk._per_env(*pk.robot_window(*a)) for _ in range(2))
    for k in one:
      assert torch.equal(_bits(one[k]), _bits(two[k])), k
