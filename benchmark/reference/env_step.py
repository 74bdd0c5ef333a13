"""Plain reference of A1MoveGround's step and reset on flat ground with
boxes (the reference's LocomotionGymEnv under the ActionRestrain and
DiagonalAction wrappers, as the configs build it), for the options the
benchmark's configurations turn on: the depth camera with blind spots,
subgoals, the MMDR frame ring (`frame_extract`, random delays drawn at
reset) and moving obstacles.

It is built from the frozen plain versions in `reference/frozen/` (the
env-last physics window, the A1 model, the delayed sensors, the task's
reward and termination, the ray-cast camera, the moving boxes) and
follows the program step by step: each step starts from the program's
own env state and takes the program's action and draws, and each reset
takes the program's draws (its samplers, held against the JAX package's
distributions by the repository's tests) and the reference's own settled
standing template (`settle`: the reference's standing reset, 400 substeps
of the per-env engine at the init command on flat ground).  State
objects are read by field name, so the program's dataclasses serve as
they are.
"""
from __future__ import annotations

import numpy as np
import torch

from reference.frozen import a1, a1_model, camera as cam, engine, maths
from reference.frozen import physics_envlast as pe
from reference.frozen import tasks
from reference.frozen import terrain as terr
from reference.frozen.a1_params import INIT_MOTOR_ANGLES, INIT_POSITION

NEAR_BOXES = 8
SETTLE_SUBSTEPS = 400     # the reference's standing reset (a1.py:232-247)
TEMPLATE_FIELDS = ("pos", "quat", "joint_q", "ang", "lin", "joint_qd")
SUPPORTED = {
    "z_constrain", "motor_control_mode", "other_direction_penalty",
    "z_penalty", "clip_num", "time_step_s", "num_action_repeat",
    "add_last_action_input", "no_displacement", "diagonal_act", "get_image",
    "depth_image", "depth_norm", "rgbd", "grayscale", "alive_reward",
    "fall_reward", "fric_coeff", "target_vel", "random_init_range",
    "domain_randomization", "enable_action_interpolation",
    "enable_action_filter", "terrain_type", "frame_extract",
    "get_image_interval", "subgoal_reward", "reset_frame_idx", "moving"}


class EnvRef:

  def __init__(self, env_build: dict, device):
    unknown = set(env_build) - SUPPORTED
    off = [k for k in ("enable_action_interpolation", "enable_action_filter",
                       "rgbd") if env_build.get(k)]
    if unknown or off or not env_build.get("no_displacement") \
       or env_build.get("terrain_type") not in terr.FLAT_TERRAINS:
      raise NotImplementedError(
          f"env reference: options outside its scope: "
          f"{sorted(unknown) + off}")
    self.eb = eb = env_build
    self.device = torch.device(device)
    self.model = a1_model.build(dt=eb["time_step_s"], device=self.device)
    clip = np.asarray(eb["clip_num"], np.float32)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
    self.lb, self.ub = f(INIT_MOTOR_ANGLES - clip), f(INIT_MOTOR_ANGLES + clip)
    self.init_cmd = f(INIT_MOTOR_ANGLES)
    self.init_pos = f(terr.INIT_POSITION[eb["terrain_type"]])
    self.fe = eb.get("frame_extract", 1)
    self.task_cfg = tasks.TaskConfig(
        z_constrain=eb.get("z_constrain", False),
        other_direction_penalty=eb.get("other_direction_penalty", 0.0),
        z_penalty=eb.get("z_penalty", 0.0), time_step_s=eb["time_step_s"],
        num_action_repeat=eb["num_action_repeat"], height_fall_coeff=0.2,
        alive_reward=eb.get("alive_reward", 0.1),
        fall_reward=eb.get("fall_reward", 0.0),
        target_vel=eb.get("target_vel", 1.0),
        subgoal_reward=eb.get("subgoal_reward"))
    self._template = None

  # ------------------------------------------------------------------
  def _flat_ground(self, friction: float):
    """The contact function of the plane z=0: penalty force along +z
    with viscous slip friction (the window's constants), and the
    penetration (..., P, 2) of ground and of no obstacle."""
    def contact_fn(pos, vel, radius):
      phi = radius - pos[..., 2]
      up = torch.zeros_like(pos)
      up[..., 2] = 1.0
      v_n = torch.sum(vel * up, dim=-1)
      f_n = torch.clamp(pe.STIFFNESS * phi - pe.DAMPING * v_n, min=0.0) * (
          phi > 0.0)
      v_t = vel - v_n[..., None] * up
      v_tn = torch.sqrt(torch.sum(v_t * v_t, dim=-1) + pe.V_SLIP ** 2)
      f_t = -(friction * f_n / v_tn)[..., None] * v_t
      return f_n[..., None] * up + f_t, torch.stack(
          [phi, torch.full_like(phi, -1.0)], dim=-1)
    return contact_fn

  @torch.no_grad()
  def settle(self) -> a1.RobotState:
    """The standing template every reset places: one robot with the
    default dynamics, dropped from INIT_POSITION at the init command and
    stepped SETTLE_SUBSTEPS substeps of the per-env engine on flat
    ground (lateral friction times fric_coeff[0]); computed once."""
    if self._template is None:
      dyn = a1.default_dynamics(self.model)
      fric = float(dyn.lateral_friction) * self.eb["fric_coeff"][0]
      model = a1.apply_dynamics(self.model, dyn)
      phys = engine.zero_state(self.model).replace(
          pos=torch.tensor(INIT_POSITION, dtype=torch.float32,
                           device=self.device),
          joint_q=self.init_cmd.clone())
      rs = a1.init_robot_state(phys)
      contact_fn = self._flat_ground(fric)
      for _ in range(SETTLE_SUBSTEPS):
        rs, _ = a1.substep(model, rs, self.init_cmd, dyn, contact_fn)
      self._template = a1.init_robot_state(rs.phys)
    return self._template

  # ------------------------------------------------------------------
  def _expand(self, action):
    if self.eb.get("diagonal_act"):
      r, l = action[:, :3], action[:, 3:6]
      action = torch.cat([r, l, l, r], dim=-1)
    return torch.minimum(torch.maximum(action, self.lb), self.ub)

  def _pruned(self, boxes, xy):
    if boxes.shape[1] <= NEAR_BOXES:
      return boxes
    dx = torch.clamp(torch.abs(xy[:, None, 0] - boxes[..., 0])
                     - boxes[..., 3], min=0.0)
    dy = torch.clamp(torch.abs(xy[:, None, 1] - boxes[..., 1])
                     - boxes[..., 4], min=0.0)
    d = dx * dx + dy * dy + torch.where(boxes[..., 7] > 0.5, 0.0, 1e9)
    idx = torch.sort(d, dim=-1, stable=True).indices[:, :NEAR_BOXES]
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 8))

  def _window(self, robot, act12, dyn, boxes, spheres, fric_g, fric_b):
    t = lambda x: x.movedim(0, -1)
    p = robot.phys
    st = dict(pos=t(p.pos), quat=t(p.quat), q=t(p.joint_q), ang=t(p.ang),
              lin=t(p.lin), qd=t(p.joint_qd), hist=t(robot.obs_hist),
              obs_tau=t(robot.observed_torques),
              last_action=t(robot.last_robot_action),
              counter=robot.step_counter)
    d = dict(kp=t(dyn.kp), kd=t(dyn.kd), strength=t(dyn.strength_ratios),
             motor_friction=dyn.motor_friction,
             joint_friction=dyn.joint_friction,
             mass_scale=t(dyn.mass_scale), inertia_scale=t(dyn.inertia_scale))
    n_sub = self.eb["num_action_repeat"]
    new, pen = pe.window(self.model, st, t(act12), d, t(boxes),
                         t(spheres) if spheres.shape[1] > 0 else None,
                         fric_g, fric_b, n_sub)
    b = lambda x: x.movedim(-1, 0).contiguous()
    rs = a1.RobotState(
        phys=engine.PhysState(pos=b(new["pos"]), quat=b(new["quat"]),
                              joint_q=b(new["q"]), ang=b(new["ang"]),
                              lin=b(new["lin"]), joint_qd=b(new["qd"])),
        obs_hist=b(new["hist"]), observed_torques=b(new["obs_tau"]),
        last_robot_action=act12, step_counter=new["counter"])
    return rs, pen.movedim(-1, 0)

  def _sensors(self, robot, dyn):
    dt = self.model.dt
    motor = a1.delayed_motor_angles(robot, dyn, dt)
    rpy, drpy = a1.delayed_rpy_and_rate(robot, dyn, dt)
    imu = torch.stack([rpy[:, 0], rpy[:, 1], drpy[:, 0], drpy[:, 1]], -1)
    return motor, imu

  def _render(self, pos, quat, terrain, blind):
    depth = cam.render_depth(
        pos, maths.quat_to_mat(quat), terrain,
        show_subgoals=self.eb.get("subgoal_reward") is not None,
        max_boxes=terr.RENDER_BOX_CAPS.get(self.eb["terrain_type"],
                                           cam.MAX_RENDER_BOXES),
        flat=True, far_t=10.5 if self.eb.get("depth_image") else 20.0)
    if self.eb.get("depth_image"):
      depth = cam.preprocess_depth(depth, blind.num, blind.idx)
    return depth

  def _obs(self, imu_hist, act_hist, motor_hist, frames, frame_idx):
    E = imu_hist.shape[0]
    parts = [imu_hist.reshape(E, -1)]
    if self.eb.get("add_last_action_input"):
      parts.append(act_hist.reshape(E, -1))
    parts.append(motor_hist.reshape(E, -1))
    if self.eb.get("get_image"):
      rows = torch.arange(E, device=frames.device)
      img = frames[rows[:, None], frame_idx.long()].reshape(E, -1)
      if self.eb.get("depth_norm") and self.eb.get("depth_image"):
        img = (img - 1.25) / 0.425
      parts.append(img)
    return torch.cat(parts, dim=-1).float()

  # ------------------------------------------------------------------
  @torch.no_grad()
  def step(self, s, action, draws):
    """(obs, reward, done) of one step from the program's state `s`."""
    eb = self.eb
    act12 = self._expand(action)
    terrain = s.terrain
    if eb.get("moving"):
      terrain = terr.moving_blocks_step(terrain, s.step_counter,
                                        draws.move_dirs)
    xy = s.robot.phys.pos[:, :2]
    fric_b = s.dyn.lateral_friction
    rs, pen = self._window(s.robot, act12, s.dyn,
                           self._pruned(terrain.boxes, xy),
                           terrain.obstacle_spheres,
                           fric_b * eb["fric_coeff"][0], fric_b)
    ground, box = pen[..., 0], pen[..., 1]
    nonfoot = (torch.any((ground > 0) & (self.model.cp_is_foot < 0.5), -1)
               | torch.any(box > 0, -1))
    task = tasks.update(s.task, rs.phys.pos)
    motor, imu = self._sensors(rs, s.dyn)
    push = lambda new, hist: torch.cat([new[:, None], hist[:, :-1]], dim=1)
    done = tasks.done(self.task_cfg, task, rs.phys.pos, rs.phys.quat, nonfoot)
    rew, _ = tasks.reward(self.task_cfg, task, maths.wxyz_to_xyzw(rs.phys.quat),
                          rs.observed_torques, done, terrain.subgoals,
                          terrain.goal_pos)
    frames = s.frames
    if eb.get("get_image"):
      counter = s.step_counter + 1
      capture = (counter % eb.get("get_image_interval", 1)) == 0
      depth = self._render(rs.phys.pos, rs.phys.quat, terrain, draws.blind)
      new = torch.cat([depth[:, None], frames[:, :-1]], dim=1)
      frames = torch.where(capture[:, None, None, None], new, frames)
    obs = self._obs(push(imu, s.imu_hist), push(act12, s.last_action_hist),
                    push(motor, s.motor_hist), frames, s.frame_idx)
    return obs, rew, done

  @torch.no_grad()
  def reset(self, all_draws):
    """The observations of a reset from its draws, placed from the
    reference's own settled template."""
    template = self.settle()
    draws, frame_draws = all_draws
    E = draws.init_jitter.shape[0]
    dev = self.device
    pos = torch.cat([self.init_pos[:2] + draws.init_jitter,
                     template.phys.pos[2].expand(E)[:, None]], dim=-1)
    tp = template.phys
    rep = lambda x: x.expand((E,) + x.shape).clone()
    rs = a1.init_robot_state(engine.PhysState(
        pos=pos, quat=rep(tp.quat), joint_q=rep(tp.joint_q),
        ang=rep(tp.ang), lin=rep(tp.lin), joint_qd=rep(tp.joint_qd)))
    motor, imu = self._sensors(rs, draws.dyn)
    cmd = rep(self.init_cmd)
    three = lambda x: x[:, None].expand((E, 3) + x.shape[1:])
    idx = (torch.arange(4, dtype=torch.int32, device=dev) * self.fe).expand(
        E, 4)
    if frame_draws.offset is not None:
      idx = idx + frame_draws.offset.to(torch.int32)
    frames = None
    if self.eb.get("get_image"):
      depth = self._render(pos, rs.phys.quat, draws.terrain, draws.blind)
      frames = depth[:, None].expand(E, 4 * self.fe, 64, 64)
    return self._obs(three(imu), three(cmd), three(motor), frames, idx)


def template_gap(program_template, reference_template) -> float:
  """The widest gap between the program's settled template and the
  reference's over position, orientation, joint angles and the
  velocities."""
  gap = 0.0
  for f in TEMPLATE_FIELDS:
    a = getattr(program_template.phys, f).double().cpu()
    b = getattr(reference_template.phys, f).double().cpu()
    gap = max(gap, float((a - b).abs().max()))
  return gap


def mismatch(obs_p, rew_p, done_p, obs_r, rew_r, done_r, proprio: int):
  """(E,) bool: the program's step or reset disagrees with the
  reference's beyond rounding: the done flag differs, the reward or a
  proprio reading by more than 1e-3 of (1 + its size), or more than 1% of
  the depth pixels by more than 1e-3."""
  bad = torch.zeros(obs_p.shape[0], dtype=torch.bool)
  if done_p is not None:
    bad |= done_p.cpu() != done_r.cpu()
    r = rew_r.double().cpu()
    bad |= (rew_p.double().cpu() - r).abs() > 1e-3 * (1 + r.abs())
  hp, hr = obs_p[:, :proprio].double().cpu(), obs_r[:, :proprio].double().cpu()
  bad |= ((hp - hr).abs() / (1 + hr.abs())).amax(dim=-1) > 1e-3
  ip, ir = obs_p[:, proprio:].cpu(), obs_r[:, proprio:].cpu()
  if ip.shape[1]:
    off = ((ip - ir).abs() > 1e-3).float().mean(dim=-1)
    bad |= off > 0.01
  return bad
