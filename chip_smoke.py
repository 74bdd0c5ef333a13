"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with the seconds since start:
  1. card name and power limit (nvidia-smi), torch / CUDA versions;
  2. build of the main path's CUDA kernel (physics_window) from this
     checkout's source with nvcc, with ptxas's register and spill counts;
  3. the kernel against its plain PyTorch version, on the card, at the
     shapes the main path gives it (1024 envs), on rollout states and on
     a batch standing on boxes and spheres (`contact_case`), by
     `physics_kernel.compare_with_plain`; then both timed with CUDA
     events, and the bound of `ops/window_cost.py` for the rollout data;
  4. the main path: thin-goal LocoTransformer collection (get_env from
     config/rl/static/locotransformer/thin-goal.json, the actor-critic at
     the config's full width with seeded random weights, init_collector,
     one 16-step rollout at 1024 envs), with every kernel's launch count
     set to 0 just before the rollout and read just after;
  5. one JSON line with every kernel's numbers, then the last line
     {"ok": true, "device": {...}}.

Float32 matmuls and convolutions run with TF32 off (both flags set
below), since outputs are compared.  Any failed phase raises: the script
then exits non-zero and prints no result line.  Without a CUDA card it
exits non-zero before doing anything.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()


def log(msg: str):
  print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


NUM_ENVS = 1024   # bench.py:167
CONFIG = "config/rl/static/locotransformer/thin-goal.json"


def actor_critic(env, params, generator=None):
  """The LocoTransformer actor-critic at the config's full width."""
  from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
  return LocoTransformerActorCritic(
      action_dim=env.cfg.action_dim, state_input_shape=env.cfg.proprio_dim,
      visual_input_shape=(4, 64, 64),
      encoder_hidden_shapes=tuple(params["encoder"]["hidden_shapes"]),
      transformer_params=tuple(
          tuple(p) for p in params["net"]["transformer_params"]),
      append_hidden_shapes=tuple(params["net"]["append_hidden_shapes"]),
      generator=generator)


def build_main_path(dev):
  """(env, meta, policy, params) of thin-goal collection on `dev`, read
  from the unchanged JSON config; policy weights random from seed 0."""
  import torch
  from vision4leg_torch.envs.get_env import get_env
  root = os.path.dirname(os.path.abspath(__file__))
  with open(os.path.join(root, CONFIG)) as f:
    params = json.load(f)
  env, meta = get_env(params["env_name"], params["env"], device=dev)
  net = actor_critic(env, params, torch.Generator().manual_seed(0))
  return env, meta, net.to(dev).eval(), params


def make_rollout(env, meta, net, params):
  """The collector's 16-step rollout (epoch_frames / NUM_ENVS steps)."""
  from vision4leg_torch.collector import rollout as rollout_lib
  gs = params["general_setting"]
  return rollout_lib.make_rollout_fn(
      env, net.pi_v, net.v,
      horizon=params["collector"]["epoch_frames"] // NUM_ENVS,
      max_episode_frames=params["collector"]["max_episode_frames"],
      discount=gs["discount"], proprio_dim=env.cfg.proprio_dim,
      obs_norm=meta["obs_norm"], action_low=env.action_low,
      action_high=env.action_high, env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"])


def contact_case(env, xy, cmd, dyn, n_sub):
  """Window inputs in which every env stands on obstacles of its own: the
  standing template's pose varied per env (joint angles, height, tilt,
  velocities; in every eighth env one joint past its limit), one box
  under a random toe, offset and turned so that toes land on its faces,
  edges and corners or sink inside it, one sphere against another toe,
  one more box and sphere valid in some envs and invalid in others."""
  import torch
  from vision4leg_torch.physics import engine
  from vision4leg_torch.physics.maths import quat_mul
  from vision4leg_torch.robots import a1
  dev, E = xy.device, xy.shape[0]
  g = torch.Generator().manual_seed(7)
  u = lambda lo, hi, *shape: (lo + (hi - lo) * torch.rand(
      *shape, generator=g)).to(dev)
  pick = lambda n: torch.randint(n, (E,), generator=g).to(dev)
  rows = torch.arange(E, device=dev)
  model = env.model
  tmpl = env.settled_template()

  q = tmpl.phys.joint_q + u(-0.15, 0.15, E, 12)
  lim = rows[::8]
  j = pick(12)[lim]
  past = u(0.0, 0.05, lim.numel())
  q[lim, j] = torch.where(lim % 16 == 0, model.joint_upper[j] + past,
                          model.joint_lower[j] - past)
  axis = torch.nn.functional.normalize(u(-1.0, 1.0, E, 3), dim=-1)
  half = u(0.0, 0.075, E, 1)
  tilt = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
  phys = engine.PhysState(
      pos=torch.cat([xy, tmpl.phys.pos[2] - u(0.0, 0.04, E, 1)], 1),
      quat=quat_mul(tilt, tmpl.phys.quat.expand(E, 4)), joint_q=q,
      ang=u(-0.5, 0.5, E, 3), lin=u(-0.5, 0.5, E, 3),
      joint_qd=u(-1.5, 1.5, E, 12))
  toes, _, _ = engine.contact_points_world(
      model, phys, engine.fwd_kinematics(model, phys))
  toes = toes[:, :4]
  r_toe = model.cp_radius[0]

  boxes = torch.zeros(E, 8, 8, device=dev)
  k0 = pick(4)
  toe = toes[rows, k0]
  hs = u(0.04, 0.12, E, 3)
  yaw = u(-3.1416, 3.1416, E)
  loc = u(-1.2, 1.2, E, 2) * hs[:, :2]        # toe over face/edge/corner
  c, s_ = torch.cos(yaw), torch.sin(yaw)
  off = torch.stack([c * loc[:, 0] - s_ * loc[:, 1],
                     s_ * loc[:, 0] + c * loc[:, 1]], -1)
  top = toe[:, 2] - r_toe + u(-0.01, 0.04, E)  # deep ones: toe inside
  boxes[:, 0, :2] = toe[:, :2] - off
  boxes[:, 0, 2] = top - hs[:, 2]
  boxes[:, 0, 3:6] = hs
  boxes[:, 0, 6] = yaw
  boxes[:, 0, 7] = 1.0
  boxes[:, 1, :2] = xy + u(-0.6, 0.6, E, 2)
  boxes[:, 1, 2:6] = u(0.05, 0.2, E, 4)
  boxes[:, 1, 6] = u(-3.1416, 3.1416, E)
  boxes[:, 1, 7] = (rows % 2).float()

  spheres = torch.zeros(E, 2, 5, device=dev)
  k1 = (k0 + 1 + pick(3)) % 4
  r_s = u(0.05, 0.15, E)
  d = torch.nn.functional.normalize(
      torch.cat([u(-1.0, 1.0, E, 2), u(0.3, 1.0, E, 1)], 1), dim=-1)
  spheres[:, 0, :3] = toes[rows, k1] - d * (r_s + r_toe
                                             - u(-0.01, 0.03, E))[:, None]
  spheres[:, 0, 3] = r_s
  spheres[:, 0, 4] = 1.0
  spheres[:, 1, :2] = xy + u(-0.6, 0.6, E, 2)
  spheres[:, 1, 3] = u(0.05, 0.2, E)
  spheres[:, 1, 4] = (rows % 3 == 0).float()
  return (model, a1.init_robot_state(phys), cmd, dyn, boxes, spheres,
          u(0.5, 1.25, E), u(0.5, 1.25, E), n_sub)


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
    return 2
  import numpy as np

  from vision4leg_torch.collector import rollout as rollout_lib
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.ops import window_cost

  # outputs below are compared against references: no TF32 anywhere
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda")

  # --- 1. the card -------------------------------------------------------
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  print(card, flush=True)
  log(f"torch {torch.__version__} cuda {torch.version.cuda} "
      f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
  log("TF32 off for matmul and cuDNN (outputs are compared)")

  # --- 2. build the kernel ------------------------------------------------
  pk.build_library()
  info = pk.BUILD_INFO
  log(f"built physics_window in {info['seconds']:.2f}s "
      f"(cached={info['cached']}): ptxas {json.dumps(info['ptxas'])}")

  # --- env and policy of the main path ------------------------------------
  env, meta, net, params = build_main_path(dev)
  num_envs = NUM_ENVS
  horizon = params["collector"]["epoch_frames"] // num_envs
  gen = torch.Generator(device=dev).manual_seed(0)
  t = time.perf_counter()
  env.settled_template()
  torch.cuda.synchronize()
  log(f"settled the standing template in {time.perf_counter() - t:.2f}s")

  # policy on the card vs a CPU copy on a small input
  probe = torch.randn(8, env.obs_dim, generator=torch.Generator()
                      .manual_seed(1))
  with torch.no_grad():
    (m_c, _, _), v_c = net.pi_v(probe.to(dev))
    cpu_net = actor_critic(env, params)
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    (m_r, _, _), v_r = cpu_net.pi_v(probe)
  err_pi = max(float((m_c.cpu() - m_r).abs().max()),
               float((v_c.cpu() - v_r).abs().max()))
  log(f"pi_v on the card vs CPU at 8 obs: max abs err {err_pi:.3e}")
  if not err_pi < 1e-4:
    raise AssertionError(f"pi_v card/CPU mismatch {err_pi}")

  # --- 3. kernel vs plain version at the main path's shapes -------------
  low, high = env.action_low, env.action_high
  states, _ = env.reset(num_envs, gen)
  for _ in range(3):
    a = low + (high - low) * torch.rand(num_envs, 6, generator=gen,
                                        device=dev)
    states, _, _, _, _ = env.step_batch(states, a, gen)
  torch.cuda.synchronize()
  log("reset + 3 steps at 1024 envs for the kernel's input states")

  def window_inputs(st, act12):
    boxes = env._pruned_boxes(st.terrain.boxes, st.robot.phys.pos[:, :2])
    fb = st.dyn.lateral_friction
    return (env.model, st.robot, act12, st.dyn, boxes,
            st.terrain.obstacle_spheres, fb * env.cfg.fric_coeff[0], fb,
            env.cfg.num_action_repeat)

  act12 = env._expand_action(
      low + (high - low) * torch.rand(num_envs, 6, generator=gen, device=dev))
  cases = {"rollout": window_inputs(states, act12)}
  (_, rs, cmd, dyn, _, _, _, _, n_sub) = cases["rollout"]
  cases["contact"] = contact_case(env, rs.phys.pos[:, :2], cmd, dyn, n_sub)

  max_err = 0.0
  for name, args in cases.items():
    counts = {}
    pk.window_plain(*args, counts=counts)
    ok, rep = pk.compare_with_plain(args)
    torch.cuda.synchronize()
    n = {k: int(v.sum()) for k, v in counts.items()}
    q, mdl = args[1].phys.joint_q, args[0]
    past = int(((q < mdl.joint_lower) | (q > mdl.joint_upper)).any(-1).sum())
    log(f"physics_window vs plain [{name}, {num_envs} envs, {past} with a "
        f"joint past its limit; point contacts over the substeps: "
        f"{n.get('ground_contacts', 0)} ground, {n.get('box_contacts', 0)} "
        f"box ({n.get('box_inside', 0)} inside), "
        f"{n.get('sphere_contacts', 0)} sphere]")
    for k, v in rep["fields"].items():
      log(f"  {k:16s} f32 vs plain f32 max {v['max_abs_err']:.3e} | "
          f"f64 kernel vs plain f64 max {v['f64_max_err']:.3e} | vs plain "
          f"f64: f32 kernel max {v['f32_kernel_vs_f64']:.3e}, f32 plain max "
          f"{v['f32_plain_vs_f64']:.3e}, f32 spread max "
          f"{v['f32_spread']:.3e}; envs excused {v['excused']}, failed "
          f"{v['failed']}")
    if not ok:
      raise AssertionError(f"physics_window disagrees with plain on {name}")
    max_err = max(max_err, rep["max_abs_err"])

  def time_ms(fn, n=25, warm=3):
    for _ in range(warm):
      fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
      s, e = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
      s.record()
      fn()
      e.record()
      e.synchronize()
      times.append(s.elapsed_time(e))
    return float(np.median(times))

  args = cases["rollout"]
  launches_before = pk.robot_window.launches
  k_ms = time_ms(lambda: pk.robot_window(*args))
  p_ms = time_ms(lambda: pk.window_plain(*args), n=20)
  k_ms2 = time_ms(lambda: pk.robot_window(*args))
  pk.robot_window.launches = launches_before
  counts = {}
  pk.window_plain(*args, counts=counts)
  nbytes, ops = window_cost.window_bytes_and_ops(
      args[0], args[4], args[5], args[8], False, counts)
  t_bytes = nbytes / 3.35e12 * 1e3
  t_ops = ops / 67e12 * 1e3
  bound_ms = max(t_bytes, t_ops)
  log(f"physics_window at 1024 envs on {card}: kernel {k_ms:.4f} ms / "
      f"{k_ms2:.4f} ms (median of 25, two turns), plain {p_ms:.3f} ms "
      f"(median of 20); bound {bound_ms * 1e3:.3f} us ({nbytes} bytes -> "
      f"{t_bytes * 1e3:.3f} us, {ops} f32 ops -> {t_ops * 1e3:.3f} us)")

  # --- 4. the main path ----------------------------------------------------
  rollout = make_rollout(env, meta, net, params)
  t = time.perf_counter()
  cs = rollout_lib.init_collector(env, num_envs, gen)
  torch.cuda.synchronize()
  log(f"init_collector at {num_envs} envs: {time.perf_counter() - t:.2f}s")
  pk.robot_window.launches = 0
  t = time.perf_counter()
  cs, traj, last_v = rollout(cs)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t
  launches = pk.robot_window.launches
  log(f"rollout: {horizon} steps x {num_envs} envs in {dt:.3f}s = "
      f"{horizon * num_envs / dt:.1f} env-steps/s on {card} "
      f"(first rollout of the process); physics_window launches "
      f"{launches}")
  if launches != horizon:
    raise AssertionError(f"physics_window launched {launches} times in a "
                         f"{horizon}-step rollout")
  for name in ("obs", "acts", "log_probs", "values", "rewards"):
    x = getattr(traj, name)
    if not torch.isfinite(x).all():
      raise AssertionError(f"non-finite {name}")
  if traj.obs.shape != (horizon, num_envs, env.obs_dim):
    raise AssertionError(f"obs shape {tuple(traj.obs.shape)}")
  if not torch.isfinite(last_v).all():
    raise AssertionError("non-finite bootstrap value")
  depth = traj.obs[..., env.cfg.proprio_dim:].reshape(
      horizon, num_envs, 4, 64, 64)
  varied = (depth.amax(dim=(-1, -2)) - depth.amin(dim=(-1, -2))) > 0.1
  share = float(varied.float().mean())
  if not share > 0.99:
    raise AssertionError(f"only {share:.4f} of the depth frames vary")
  log(f"outputs finite; {share:.4f} of depth frames non-constant; "
      f"terminals {int(traj.terminals.sum())}; mean reward "
      f"{float(traj.rewards.mean()):.4f}")

  kernels = [dict(
      name="physics_window", route="cuda",
      source="vision4leg_torch/ops/csrc/physics_window.cu",
      replaces="vision4leg_tpu/ops/physics_kernel.py:113",
      launches=launches, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
      bound_ms=bound_ms, bound_by="operations" if t_ops >= t_bytes
      else "bytes", library_ms=None)]
  print(json.dumps({"kernels": kernels, "card": card,
                    "env_steps_per_s": horizon * num_envs / dt}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
