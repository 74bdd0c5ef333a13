"""Convex-MPC locomotion demo: a trot gait tracking a piecewise speed
profile, one robot on the card (torch mirror of
starter/locomotion_controller_example.py).

The reference's mpc_controller/locomotion_controller_example.py: the same
trot gait (stance 0.3 s, duty 0.6, phases [0.9, 0, 0, 0.9]) and the same
demo speed profile (stand, turn left, forward, turn right, sidestep,
stand), the controller ticking every 5 substeps of 1 ms physics.  Each
tick is `A1MPCGymEnv.controller_step`: one exact KKT inverse of the warm
QP, the controller stack, then one launch of the physics-window kernel
in its hybrid mode (stance legs take the MPC torques, swing legs PD).
The reset's settle is one plain launch of the same kernel.

Unlike the JAX demo, which calls the env's `_controller_tick` alone and
carries the warm QP's KKT inverse across the whole run, every tick here
refreshes it exactly: the carried inverse diverges (the warm path's
comment, vision4leg_tpu/mpc/convex_mpc.py:505-516) and the JAX demo's
robot falls within 5 s (ROADMAP section 3).

`--robot` selects the MPC parameter set (a1 | laikago | spirit40,
mpc/robot_params.py).  Only the A1 has an articulated model, so a non-A1
set replaces the MPC's mass and inertia on the A1 body and keeps the
A1's frozen QP scaling, as the JAX demo does.

Usage:
  python -m vision4leg_torch.starter.locomotion_controller_example \
      --robot a1 --max_time 20
  ... --device cpu     (the plain path on the CPU)
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from vision4leg_torch.envs.mpc_env import A1MPCGymEnv, MpcEnvConfig
from vision4leg_torch.mpc import robot_params
from vision4leg_torch.physics import maths

SEGMENT_S = 5.0


def demo_config() -> MpcEnvConfig:
  """1 kHz physics, a controller tick every 5 substeps (200 Hz), the
  rates of the JAX package's MPC walking test."""
  return MpcEnvConfig(
      motor_control_mode="POSITION", clip_num=(0.3, 0.4),
      time_step_s=0.001, num_action_repeat=5, policy_freq=4,
      terrain_type="plane", target_vel=0.3, check_contact=False,
      settle_steps=300, alive_reward=0.1)


def build_env(robot: str = "a1", device=None) -> A1MPCGymEnv:
  """The demo's env on `device`, the MPC's mass and inertia those of
  `robot`'s parameter set (the A1's frozen QP scaling kept)."""
  env = A1MPCGymEnv(demo_config(), device=device)
  if robot != "a1":
    rp = robot_params.ROBOTS[robot]
    env.mpc_cfg = env.mpc_cfg._replace(
        mass=rp.body_mass, inertia=tuple(rp.body_inertia))
  return env


def speed_profile(t, multiplier: float):
  """The piecewise-constant demo profile (locomotion_controller_example.py
  :79-99) at clocks t (E,): hold, yaw left, forward, yaw right, sidestep,
  hold, yaw, SEGMENT_S each.  Returns (lin (E, 3), ang (E,))."""
  vx, vy, wz = 0.6 * multiplier, 0.2 * multiplier, 0.8 * multiplier
  points = torch.tensor([
      [0.0, 0.0, 0.0, 0.0],
      [0.0, 0.0, 0.0, wz],
      [vx, 0.0, 0.0, 0.0],
      [0.0, 0.0, 0.0, -wz],
      [0.0, -vy, 0.0, 0.0],
      [0.0, 0.0, 0.0, 0.0],
      [0.0, 0.0, 0.0, wz],
  ], dtype=t.dtype, device=t.device)
  idx = torch.clamp((t / SEGMENT_S).to(torch.int32), 0, points.shape[0] - 1)
  sp = points[idx.long()]
  return sp[:, :3], sp[:, 3]


def run(robot: str = "a1", max_time: float = 20.0, device=None, env=None,
        state=None, ticks=None):
  """The demo of env 0: the reset (unless `state` is given), then the
  ticks of max_time seconds (or `ticks`).  Returns a dict of numpy arrays
  per tick, after it: "t" the clock, "pos", "rpy", "vel_body" the base's
  position, rpy and body-frame velocity, "lin" and "ang" the command;
  and "state", the last env state."""
  env = build_env(robot, device) if env is None else env
  cfg = env.cfg
  mult = robot_params.ROBOTS[robot].velocity_multiplier
  if state is None:
    state, _ = env.reset(1, torch.Generator(device=env.device).manual_seed(0))
  if ticks is None:
    ticks = int(max_time / (cfg.num_action_repeat * cfg.time_step_s))
  rec = {k: [] for k in ("t", "pos", "rpy", "vel_body", "lin", "ang")}
  for _ in range(ticks):
    lin, ang = speed_profile(state.current_time, mult)
    state = env.controller_step(state, lin, ang)
    phys = state.robot.phys
    for k, v in (("t", state.current_time), ("pos", phys.pos),
                 ("rpy", maths.quat_to_rpy(phys.quat)),
                 ("vel_body", maths.quat_rotate_inv(phys.quat, phys.lin)),
                 ("lin", lin), ("ang", ang)):
      rec[k].append(v[0])
  out = {k: torch.stack(v).cpu().numpy() for k, v in rec.items()}
  out["state"] = state
  return out


def upright(traj) -> bool:
  """The demo's criterion: |roll|, |pitch| < 0.5 rad and base z > 0.12 m
  on every tick."""
  return bool(np.all(np.abs(traj["rpy"][:, :2]) < 0.5)
              and np.all(traj["pos"][:, 2] > 0.12))


def segment_report(traj):
  """One dict per SEGMENT_S segment of the clock: its bounds, the
  command at its end, the mean |v_xy - cmd_xy| (m/s) and the mean base
  z (m)."""
  ts = traj["t"]
  seg = (ts // SEGMENT_S).astype(int)
  out = []
  for s in range(int(seg.max()) + 1):
    m = seg == s
    if not m.any():
      continue
    cmd_v = traj["lin"][m][-1]
    err = np.mean(np.linalg.norm(traj["vel_body"][m][:, :2] - cmd_v[:2],
                                 axis=1))
    out.append(dict(t0=SEGMENT_S * s, t1=SEGMENT_S * (s + 1),
                    cmd_vx=float(cmd_v[0]), cmd_vy=float(cmd_v[1]),
                    cmd_wz=float(traj["ang"][m][-1]), v_err=float(err),
                    z=float(traj["pos"][m][:, 2].mean())))
  return out


def segment_lines(traj):
  """The JAX demo's per-segment lines."""
  return [f"  t=[{r['t0']:4.1f},{r['t1']:4.1f})s cmd v=({r['cmd_vx']:+.2f},"
          f"{r['cmd_vy']:+.2f}) wz={r['cmd_wz']:+.2f}  "
          f"mean|v err|={r['v_err']:.3f} m/s  z={r['z']:.3f} m"
          for r in segment_report(traj)]


def main(argv=None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--robot", default="a1",
                  choices=sorted(robot_params.ROBOTS))
  ap.add_argument("--max_time", type=float, default=20.0)
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu for the plain path")
  args = ap.parse_args(argv)
  if args.robot != "a1":
    print(f"note: articulated body is the A1; '{args.robot}' supplies the "
          "MPC mass/inertia only (its URDF lives in pybullet_data, not "
          "shipped)")
  t0 = time.time()
  traj = run(args.robot, args.max_time, device=args.device)
  wall = time.time() - t0
  ok = upright(traj)
  sim = float(traj["t"][-1])
  print(f"robot={args.robot}  sim {sim:.1f}s in {wall:.1f}s wall "
        f"({sim / wall:.1f}x realtime)  upright={ok}")
  print("\n".join(segment_lines(traj)))
  if not ok:
    print("FAIL: robot fell")
    return 1
  return 0


if __name__ == "__main__":
  sys.exit(main())
