"""A1MoveGround as batched torch reset/step (mirror of
vision4leg_tpu.envs.env).

The reference's `LocomotionGymEnv` (locomotion_gym_env_with_rich_
information.py) with the wrappers `build_a1_ground_env` stacks
(ActionRestrain clip, DiagonalAction, env_builder.py:40-107).  Every
EnvState field carries a leading env axis; `reset` builds a batch of envs
and `step_batch` steps them all: on the flat terrains
(`terrain.FLAT_TERRAINS`) through one physics-window launch
(`ops.physics_kernel.robot_window`, flat ground and boxes), on the others
through the per-env engine batched over the envs (`a1.robot_step`) with
each env's heightfield in the contact model and the camera, as the JAX
env's vmapped `step` does (env.py:482-500, 594-595).  A non-flat env
never reaches the window: `_robot_window` raises there.

Observation layout (sorted sensor names, env_utils.py:27-50):
  [RandoDir (cos, sin)(2)?] [GoalPos(6)?] [HSW(BaseDisplacement)(9 or 21)?]
  [HSW(IMU)(12)] [HSW(LastAction)(36)?] [HSW(MotorAngle)(36)]
  [raw_img(4*64*64)?]
With `rotate_sensor` each displacement reading is 7 wide: the base
displacement and the xyzw quaternion delta since the step's start
(BaseDisplacementAndRotateSensor, robot_sensors.py:283-337).  With
`random_dir` (RandoDirWrapper, env_builder.py:110-156) each env keeps a
target direction in [-pi/2, pi/2], drawn at reset, prefixed to the
observation as (cos, sin) and steering the task's velocity reward; with
`dir_update_interval` it is redrawn every that many observations (the
reset's counts as the first).

The MMDR options (the reference's frame_extract configs): the depth ring
holds 4 * frame_extract frames; the observation takes four of them per
env at `frame_idx` (E, 4), drawn at reset with a fixed or random delay
(`reset_frame_idx`, `fixed_delay_observation`), redrawn at its head every
step with `reset_frame_idx_each_step`, and with `interpolation` each of
the four is the mean of frames idx .. idx + interp_delay.  With `moving`
the first 50 boxes move every step (`terrain.moving_blocks_step`) and
the window, the camera and the stored terrain all see the moved boxes.

On `random_sphere_with_subgoal` the window and its contact read take the
NEAR_BOXES obstacle spheres nearest to each base (`_pruned_spheres`), the
camera all of them.

Randomness: every draw goes through `draw_reset`, `draw_frame_delays`
and `draw_step` (which takes the blind spots from `draw_blind_spots`)
from an explicit torch.Generator; a test substitutes them to replay the
JAX package's draws.  Each draws only what the config turns on.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vision4leg_torch import resolve_device
from vision4leg_torch.envs import camera as cam
from vision4leg_torch.envs import dynamics_rando, tasks
from vision4leg_torch.envs import terrain as terr
from vision4leg_torch.envs import wrappers
from vision4leg_torch.ops import physics_kernel
from vision4leg_torch.physics import contact, engine, maths
from vision4leg_torch.robots import a1, a1_model, action_filter
from vision4leg_torch.robots import a1_params as P
from vision4leg_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class EnvConfig:
  """Static env configuration: the `env_build` section of the reference
  JSON (env_builder.py:159-203), same fields as the JAX package's."""
  motor_control_mode: str = "POSITION"
  z_constrain: bool = False
  other_direction_penalty: float = 0.0
  z_penalty: float = 0.0
  clip_num: Optional[tuple] = None
  diagonal_act: bool = False
  num_action_repeat: int = 10
  time_step_s: float = 0.001
  add_last_action_input: bool = False
  enable_action_interpolation: bool = False
  enable_action_filter: bool = False
  domain_randomization: bool = False
  get_image: bool = False
  depth_image: bool = False
  depth_norm: bool = False
  grayscale: bool = True
  rgbd: bool = False
  fric_coeff: tuple = (0.8, 0.1, 0.1)
  terrain_type: str = "plane"
  alive_reward: float = 0.1
  fall_reward: float = 0.0
  target_vel: float = 1.0
  random_init_range: float = 0.0
  check_contact: bool = False
  frame_extract: int = 1
  goal: bool = False
  subgoal: bool = False
  goal_coeff: float = 10.0
  subgoal_reward: Optional[float] = None
  no_displacement: bool = False
  get_image_interval: int = 1
  reset_frame_idx: bool = False
  reset_frame_idx_each_step: bool = False
  random_shape: bool = False
  moving: bool = False
  curriculum: bool = False
  interpolation: bool = False
  fixed_delay_observation: bool = False
  empty_image: bool = False
  random_dir: bool = False
  dir_update_interval: Optional[int] = None
  rotate_sensor: bool = False
  record_video: bool = False
  settle_steps: int = 400
  substeps: int = 1

  def __post_init__(self):
    if self.terrain_type in ("mount", "random_hill"):
      object.__setattr__(self, "check_contact", True)

  @property
  def action_dim(self) -> int:
    return 6 if self.diagonal_act else 12

  @property
  def num_stored_frames(self) -> int:
    return 4 * self.frame_extract

  @property
  def disp_channels(self) -> int:
    return 7 if self.rotate_sensor else 3

  @property
  def proprio_dim(self) -> int:
    d = 12 + 36
    if self.random_dir:
      d += 2
    if self.goal:
      d += 6
    if not self.no_displacement:
      d += 3 * self.disp_channels
    if self.add_last_action_input:
      d += 36
    return d

  @property
  def image_dim(self) -> int:
    return 4 * 64 * 64 if self.get_image else 0

  @property
  def obs_dim(self) -> int:
    return self.proprio_dim + self.image_dim


class BlindSpots(NamedTuple):
  num: torch.Tensor   # (E,) int, spots in [3, 30)
  idx: torch.Tensor   # (E, 30, 2) int, (row, col)


class FrameDraws(NamedTuple):
  """The MMDR delays of a reset; None where the config draws none."""
  offset: Optional[torch.Tensor]        # (E, 4) int in [0, frame_extract)
  interp_delay: Optional[torch.Tensor]  # (E,) int in [0, frame_extract)


class StepDraws(NamedTuple):
  """All randomness of a step; None where the config draws none."""
  blind: Optional[BlindSpots]
  move_dirs: Optional[torch.Tensor]     # (E, K) int in [0, 20)
  frame_head: Optional[torch.Tensor]    # (E,) int in [1, frame_extract)
  dir_angle: Optional[torch.Tensor] = None  # (E,) redraw in [-pi/2, pi/2]


class ResetDraws(NamedTuple):
  """All randomness of a reset."""
  terrain: terr.TerrainState
  dyn: a1.DynamicsParams
  init_jitter: torch.Tensor   # (E, 2) xy offset of the start position
  blind: BlindSpots
  dir_angle: Optional[torch.Tensor] = None  # (E,) with random_dir


@dataclasses.dataclass
class EnvState:
  robot: a1.RobotState
  dyn: a1.DynamicsParams
  terrain: terr.TerrainState
  task: tasks.TaskState
  motor_hist: torch.Tensor        # (E, 3, 12) newest first
  imu_hist: torch.Tensor          # (E, 3, 4)
  disp_hist: torch.Tensor         # (E, 3, disp_channels)
  last_action_hist: torch.Tensor  # (E, 3, 12)
  last_action: torch.Tensor       # (E, 12)
  last_base_pos: torch.Tensor     # (E, 3)
  last_base_quat: torch.Tensor    # (E, 4) xyzw, for rotate_sensor's delta
  dir_angle: torch.Tensor         # (E,) RandoDir target angle (0 without)
  dir_count: torch.Tensor         # (E,) int32 RandoDir observation count
  filter_state: action_filter.FilterState  # (E, 2, 12) each history
  frames: torch.Tensor            # (E, num_stored, 64, 64) or (E, 1, 1, 1)
  frame_idx: torch.Tensor         # (E, 4) int32 ring slots observed
  interp_delay: torch.Tensor      # (E,) int32
  step_counter: torch.Tensor      # (E,) int32

  def replace(self, **kw) -> "EnvState":
    return dataclasses.replace(self, **kw)


def select(mask, new, old):
  """Per-env choice between two pytrees of dataclasses / tensors."""
  if isinstance(new, torch.Tensor):
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)
  return type(new)(**{f.name: select(mask, getattr(new, f.name),
                                     getattr(old, f.name))
                      for f in dataclasses.fields(new)})


class A1GymEnv:
  """Batched A1MoveGround on one device."""

  NEAR_BOXES = 8   # boxes kept per env for contacts (nearest by surface)

  def __init__(self, cfg: EnvConfig, device=None):
    self._setup(cfg, device)
    if cfg.clip_num is not None:
      clip = np.asarray(cfg.clip_num, np.float32)
      lb, ub = P.INIT_MOTOR_ANGLES - clip, P.INIT_MOTOR_ANGLES + clip
    else:
      lb, ub = P.JOINT_LOWER, P.JOINT_UPPER
    self._act_lb12 = torch.tensor(lb, dtype=torch.float32, device=self.device)
    self._act_ub12 = torch.tensor(ub, dtype=torch.float32, device=self.device)
    if cfg.enable_action_filter:
      # sampling at the control rate (minitaur.py:1445-1448)
      self._filter_coeffs = action_filter.make_coeffs(
          1.0 / (cfg.time_step_s * cfg.num_action_repeat))
    self._template = None

  def _setup(self, cfg: EnvConfig, device):
    """Refuse what the port does not run; the device, the robot model,
    the start position and the standing command (shared with the MPC
    env)."""
    if cfg.motor_control_mode != "POSITION":
      raise NotImplementedError("only POSITION control for the RL env")
    if cfg.rgbd:
      raise NotImplementedError(
          "rgbd=True: the JAX env accepts and ignores it; the port rejects "
          "it (ROADMAP queue 3)")
    if cfg.random_shape:
      warnings.warn(
          "random_shape=True is ignored: the JAX env accepts it and never "
          "passes it to gen_blocks_sparse, so the thin-random-shape configs "
          "run on plain pillars there, and the port mirrors that (ROADMAP "
          "section 3)", stacklevel=3)
    if cfg.terrain_type not in terr.TERRAIN_GENERATORS:
      raise NotImplementedError(
          f"terrain {cfg.terrain_type!r} is not ported yet (ROADMAP queue "
          "1 item 4)")
    self.cfg = cfg
    self._flat = cfg.terrain_type in terr.FLAT_TERRAINS
    self.device = resolve_device(device)
    self.model = a1_model.build(dt=cfg.time_step_s / cfg.substeps,
                                device=self.device)
    self._init_pos = torch.tensor(terr.INIT_POSITION[cfg.terrain_type],
                                  dtype=torch.float32, device=self.device)
    self._init_cmd = torch.tensor(P.INIT_MOTOR_ANGLES, dtype=torch.float32,
                                  device=self.device)

  @property
  def action_low(self):
    return self._act_lb12[: self.cfg.action_dim]

  @property
  def action_high(self):
    return self._act_ub12[: self.cfg.action_dim]

  @property
  def obs_dim(self) -> int:
    return self.cfg.obs_dim

  @property
  def kernel_capable(self) -> bool:
    """Whether the physics window models this env's ground: flat z=0 with
    boxes and spheres (JAX `kernel_capable`, env.py:574-578)."""
    return self._flat

  @property
  def _random_delay(self) -> bool:
    """A reset draws each env's frame delays (JAX env.py:318-326)."""
    cfg = self.cfg
    return (cfg.reset_frame_idx and cfg.frame_extract > 1
            and not cfg.fixed_delay_observation)

  @property
  def _redraws_dir(self) -> bool:
    """A step may redraw the RandoDir target (JAX env.py:538-548)."""
    return self.cfg.random_dir and self.cfg.dir_update_interval is not None

  @property
  def _each_step_head(self) -> bool:
    """A step redraws the head of the frame indices (JAX env.py:554)."""
    cfg = self.cfg
    return (cfg.get_image and cfg.reset_frame_idx_each_step
            and cfg.frame_extract > 1)

  # ------------------------------------------------------------------
  def settled_template(self) -> a1.RobotState:
    """Settle one robot to contact equilibrium on flat ground once (the
    reference's standing reset, a1.py:232-247) with the per-env engine;
    cached and placed by every reset."""
    if self._template is not None:
      return self._template
    dyn = a1.default_dynamics(self.model)
    h_fn, n_fn = terr.flat_height_fn()
    cfn = contact.make_terrain_contact_fn(
        h_fn, n_fn, friction=dyn.lateral_friction * self.cfg.fric_coeff[0])
    model_d = a1.apply_dynamics(self.model, dyn)
    phys = engine.zero_state(self.model).replace(
        pos=torch.tensor([0.0, 0.0, 0.32], device=self.device),
        joint_q=self._init_cmd.clone())
    rs = a1.init_robot_state(phys)
    for _ in range(self.cfg.settle_steps * self.cfg.substeps):
      rs, _ = a1.substep(model_d, rs, self._init_cmd, dyn, cfn)
    self._template = a1.init_robot_state(rs.phys)
    return self._template

  # ------------------------------------------------------------------
  def draw_reset(self, n_env: int, gen: torch.Generator) -> ResetDraws:
    cfg = self.cfg
    terrain = terr.TERRAIN_GENERATORS[cfg.terrain_type](
        gen, n_env, self.device, moving=cfg.moving)
    dyn = dynamics_rando.maybe_sample(self.model, gen, n_env,
                                      cfg.domain_randomization,
                                      cfg.fixed_delay_observation)
    r = cfg.random_init_range
    jitter = (torch.rand(n_env, 2, generator=gen, device=self.device) * 2 * r
              - r) if r > 0 else torch.zeros(n_env, 2, device=self.device)
    blind = self.draw_blind_spots(n_env, gen)
    angle = (wrappers.draw_dir_angle(gen, n_env, self.device)
             if cfg.random_dir else None)
    return ResetDraws(terrain, dyn, jitter, blind, angle)

  def draw_blind_spots(self, n_env: int, gen: torch.Generator) -> BlindSpots:
    n = cam.NUM_BLIND_SPOTS
    return BlindSpots(
        num=torch.randint(3, n, (n_env,), generator=gen, device=self.device),
        idx=torch.randint(0, cam.IMG_SIZE, (n_env, n, 2), generator=gen,
                          device=self.device))

  def draw_frame_delays(self, n_env: int, gen: torch.Generator
                        ) -> FrameDraws:
    cfg = self.cfg
    fe = cfg.frame_extract
    offset = (torch.randint(0, fe, (n_env, 4), generator=gen,
                            device=self.device)
              if self._random_delay else None)
    interp = (torch.randint(0, fe, (n_env,), generator=gen,
                            device=self.device)
              if cfg.interpolation else None)
    return FrameDraws(offset, interp)

  def draw_step(self, n_env: int, n_boxes: int, gen: torch.Generator
                ) -> StepDraws:
    cfg = self.cfg
    move = (torch.randint(0, terr.NUM_DIRECTIONS, (n_env, n_boxes),
                          generator=gen, device=self.device)
            if cfg.moving else None)
    head = (torch.randint(1, cfg.frame_extract, (n_env,), generator=gen,
                          device=self.device)
            if self._each_step_head else None)
    blind = self.draw_blind_spots(n_env, gen) if cfg.get_image else None
    angle = (wrappers.draw_dir_angle(gen, n_env, self.device)
             if self._redraws_dir else None)
    return StepDraws(blind, move, head, angle)

  def _frame_idx(self, n_env: int, draws: FrameDraws):
    """(frame_idx (E, 4), interp_delay (E,)) of a reset (JAX env.py
    :315-328): slots k * fe, moved by fe - 1 with a fixed delay or by the
    drawn offsets with a random one."""
    cfg = self.cfg
    fe = cfg.frame_extract
    base = torch.arange(4, dtype=torch.int32, device=self.device) * fe
    if cfg.reset_frame_idx and fe > 1 and cfg.fixed_delay_observation:
      base = base + (fe - 1)
    idx = base.expand(n_env, 4)
    if draws.offset is not None:
      idx = idx + draws.offset.to(torch.int32)
    interp = (draws.interp_delay.to(torch.int32)
              if draws.interp_delay is not None
              else torch.zeros(n_env, dtype=torch.int32, device=self.device))
    return idx.contiguous(), interp

  def reset(self, n_env: int, gen: torch.Generator
            ) -> Tuple[EnvState, torch.Tensor]:
    """A batch of n_env fresh envs and their observations (E, obs_dim)."""
    return self.reset_from(n_env, self.draw_for_reset(n_env, gen))

  def draw_for_reset(self, n_env: int, gen: torch.Generator):
    """Every draw of a reset of n_env envs, in the order `reset` takes
    them: a tree of tensors whose leading axis is the env's."""
    return self.draw_reset(n_env, gen), self.draw_frame_delays(n_env, gen)

  def reset_from(self, n_env: int, all_draws
                 ) -> Tuple[EnvState, torch.Tensor]:
    """The reset of n_env envs from their `draw_for_reset`."""
    with profiling.span("v4l.env.reset"):
      return self._reset_from(n_env, all_draws)

  def _reset_from(self, n_env: int, all_draws):
    cfg = self.cfg
    draws, frame_draws = all_draws
    frame_idx, interp_delay = self._frame_idx(n_env, frame_draws)
    template = self.settled_template()
    E = n_env
    pos_xy = self._init_pos[:2] + draws.init_jitter
    z = template.phys.pos[2].expand(E)
    if not self._flat:
      # the template's height above each env's own ground (JAX env.py
      # :306-309)
      h_fn, _ = terr.heightfield_fns(draws.terrain)
      z = z + h_fn(pos_xy[:, None])[:, 0]
    pos = torch.cat([pos_xy, z[:, None]], dim=-1)
    tp = template.phys
    rep = lambda x: x.expand((E,) + x.shape).clone()
    phys = engine.PhysState(pos=pos, quat=rep(tp.quat),
                            joint_q=rep(tp.joint_q), ang=rep(tp.ang),
                            lin=rep(tp.lin), joint_qd=rep(tp.joint_qd))
    rs = a1.init_robot_state(phys)
    cmd = rep(self._init_cmd)
    frames = (torch.zeros(E, cfg.num_stored_frames, 64, 64,
                          device=self.device)
              if cfg.get_image else torch.zeros(E, 1, 1, 1,
                                                device=self.device))
    task = tasks.init_task_state(pos, terr.NUM_SUBGOALS)
    if cfg.random_dir:
      # RandoDirWrapper.reset (env_builder.py:145-156): the task's velocity
      # reward points along the drawn direction
      angle = draws.dir_angle
      task = task.replace(target_vel_dir=wrappers.dir_vector(angle))
    else:
      angle = torch.zeros(E, device=self.device)
    dc = cfg.disp_channels
    state = EnvState(
        robot=rs, dyn=draws.dyn, terrain=draws.terrain, task=task,
        motor_hist=torch.zeros(E, 3, 12, device=self.device),
        imu_hist=torch.zeros(E, 3, 4, device=self.device),
        disp_hist=torch.zeros(E, 3, dc, device=self.device),
        last_action_hist=torch.zeros(E, 3, 12, device=self.device),
        last_action=cmd, last_base_pos=pos.clone(),
        last_base_quat=maths.wxyz_to_xyzw(rs.phys.quat),
        dir_angle=angle,
        # the reset's observation is RandoDir's first (env_builder.py
        # :127-133)
        dir_count=torch.ones(E, dtype=torch.int32, device=self.device),
        filter_state=action_filter.init_state(cmd), frames=frames,
        frame_idx=frame_idx, interp_delay=interp_delay,
        step_counter=torch.zeros(E, dtype=torch.int32, device=self.device))
    m, imu, disp = self._sensor_readings(state)
    state = state.replace(
        motor_hist=m[:, None].expand(E, 3, 12).clone(),
        imu_hist=imu[:, None].expand(E, 3, 4).clone(),
        disp_hist=disp[:, None].expand(E, 3, dc).clone(),
        last_action_hist=cmd[:, None].expand(E, 3, 12).clone())
    if cfg.get_image:
      depth = self._render(state, draws.blind)
      state = state.replace(frames=depth[:, None].expand(
          E, cfg.num_stored_frames, 64, 64).clone())
    return state, self._observation(state)

  # ------------------------------------------------------------------
  def _sensor_readings(self, state: EnvState):
    dt = self.model.dt
    rs, dyn = state.robot, state.dyn
    motor = a1.delayed_motor_angles(rs, dyn, dt)
    rpy, drpy = a1.delayed_rpy_and_rate(rs, dyn, dt)
    imu = torch.stack([rpy[:, 0], rpy[:, 1], drpy[:, 0], drpy[:, 1]], dim=-1)
    disp = rs.phys.pos - state.last_base_pos
    if self.cfg.rotate_sensor:
      # BaseDisplacementAndRotateSensor: the xyzw quaternion delta too
      dquat = maths.wxyz_to_xyzw(rs.phys.quat) - state.last_base_quat
      disp = torch.cat([disp, dquat], dim=-1)
    return motor, imu, disp

  def _render(self, state: EnvState, blind: BlindSpots):
    cfg = self.cfg
    E = state.step_counter.shape[0]
    if cfg.empty_image:
      return torch.zeros(E, 64, 64, device=self.device)
    rot = maths.quat_to_mat(state.robot.phys.quat)
    with profiling.span("v4l.env.camera"):
      depth = cam.render_depth(
          state.robot.phys.pos, rot, state.terrain,
          show_subgoals=cfg.subgoal_reward is not None,
          max_boxes=terr.RENDER_BOX_CAPS.get(cfg.terrain_type,
                                             cam.MAX_RENDER_BOXES),
          flat=self._flat, far_t=10.5 if cfg.depth_image else 20.0)
      if cfg.depth_image:
        depth = cam.preprocess_depth(depth, blind.num, blind.idx)
    return depth

  def _image_obs(self, state: EnvState):
    return self._gather_frames(state.frames, state.frame_idx,
                               state.interp_delay)

  def _gather_frames(self, frames, frame_idx, interp_delay):
    """The four observed frames of each env, flattened (E, 4 * 64 * 64):
    frames[e, frame_idx[e]], or with interpolation the mean of frames
    idx .. idx + interp_delay[e] (clipped to the ring; JAX env.py
    :417-436), then the depth normalization."""
    cfg = self.cfg
    E = frames.shape[0]
    rows = torch.arange(E, device=frames.device)
    idx = frame_idx.long()
    if cfg.interpolation:
      offs = torch.arange(cfg.frame_extract, device=frames.device)
      mask = (offs[None] <= interp_delay[:, None]).float()    # (E, fe)
      slots = torch.clamp(idx[:, :, None] + offs, 0,
                          cfg.num_stored_frames - 1)          # (E, 4, fe)
      sel = frames[rows[:, None, None], slots]                # (E,4,fe,H,W)
      img = (torch.sum(sel * mask[:, None, :, None, None], dim=2)
             / (interp_delay + 1).float()[:, None, None, None])
    else:
      img = frames[rows[:, None], idx]
    img = img.reshape(E, -1)
    if cfg.depth_norm and cfg.depth_image:
      img = (img - 1.25) / 0.425
    return img

  def _observation(self, state: EnvState):
    cfg = self.cfg
    E = state.step_counter.shape[0]
    parts = []
    if cfg.random_dir:
      parts.append(wrappers.dir_vector(state.dir_angle))
    if cfg.goal:
      parts += [state.robot.phys.pos, state.terrain.goal_pos]
    if not cfg.no_displacement:
      parts.append(state.disp_hist.reshape(E, -1))
    parts.append(state.imu_hist.reshape(E, -1))
    if cfg.add_last_action_input:
      parts.append(state.last_action_hist.reshape(E, -1))
    parts.append(state.motor_hist.reshape(E, -1))
    if cfg.get_image:
      parts.append(self._image_obs(state))
    return torch.cat(parts, dim=-1).float()

  # ------------------------------------------------------------------
  def _expand_action(self, action):
    """DiagonalAction (env_builder.py:102-107) + ActionRestrain clip."""
    if self.cfg.diagonal_act:
      right, left = action[:, :3], action[:, 3:6]
      action = torch.cat([right, left, left, right], dim=-1)
    return torch.minimum(torch.maximum(action, self._act_lb12),
                         self._act_ub12)

  def _step_pre(self, state: EnvState, action, draws: StepDraws):
    """The action expansion, the Butterworth filter with
    enable_action_filter (minitaur.Step:277-279, JAX env.py:466-469) and,
    with `moving`, the obstacles' step on the counter before its
    increment (JAX env.py:477-479); the moved terrain is stored, so the
    window, the camera and the next step all see it."""
    act12 = self._expand_action(action)
    if self.cfg.enable_action_filter:
      fstate, act12 = action_filter.apply(self._filter_coeffs,
                                          state.filter_state, act12)
      state = state.replace(filter_state=fstate)
    state = state.replace(
        last_action=act12, last_base_pos=state.robot.phys.pos,
        last_base_quat=maths.wxyz_to_xyzw(state.robot.phys.quat))
    if self.cfg.moving:
      state = state.replace(terrain=terr.moving_blocks_step(
          state.terrain, state.step_counter, draws.move_dirs))
    return state, act12

  def _pruned_boxes(self, boxes, base_xy):
    """The NEAR_BOXES boxes nearest by axis-aligned surface distance, ties
    to the lower index, as jax.lax.top_k breaks them (a stable sort: on
    multi_stairs more than NEAR_BOXES slabs can contain the base xy)."""
    if boxes.shape[1] <= self.NEAR_BOXES:
      return boxes
    dx = torch.clamp(torch.abs(base_xy[:, None, 0] - boxes[..., 0])
                     - boxes[..., 3], min=0.0)
    dy = torch.clamp(torch.abs(base_xy[:, None, 1] - boxes[..., 1])
                     - boxes[..., 4], min=0.0)
    d = dx * dx + dy * dy + torch.where(boxes[..., 7] > 0.5, 0.0, 1e9)
    idx = torch.sort(d, dim=-1, stable=True).indices[:, :self.NEAR_BOXES]
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 8))

  def _pruned_spheres(self, spheres, base_xy):
    """The NEAR_BOXES obstacle spheres (E, Q, 5) nearest to base_xy
    (E, 2) by surface distance, invalid ones last (JAX
    `_pruned_spheres`, env.py:220-229), ties to the lower index as
    jax.lax.top_k breaks them."""
    if spheres.shape[1] <= self.NEAR_BOXES:
      return spheres
    dx = base_xy[:, None, 0] - spheres[..., 0]
    dy = base_xy[:, None, 1] - spheres[..., 1]
    d = (torch.sqrt(dx * dx + dy * dy) - spheres[..., 3]
         + torch.where(spheres[..., 4] > 0.5, 0.0, 1e9))
    idx = torch.sort(d, dim=-1, stable=True).indices[:, :self.NEAR_BOXES]
    return torch.gather(spheres, 1, idx[..., None].expand(-1, -1, 5))

  def _robot_window(self, *args, **kw):
    """physics_kernel.robot_window, which models flat ground only: a
    non-flat env raises here rather than step on a plane."""
    if not self.kernel_capable:
      raise RuntimeError(
          f"physics_kernel.robot_window models flat ground; terrain "
          f"{self.cfg.terrain_type!r} has a heightfield and steps through "
          "the per-env engine")
    return physics_kernel.robot_window(*args, **kw)

  def _contact_fn(self, terrain: terr.TerrainState, dyn: a1.DynamicsParams,
                  base_xy=None):
    """The per-env engine's contact model (JAX `_contact_fn`, env.py
    :232-242): the terrain's ground, the NEAR_BOXES boxes nearest to
    base_xy (E, 2) (every box without it), the obstacle spheres; ground
    friction lateral_friction * fric_coeff[0], obstacle friction
    lateral_friction."""
    h_fn, n_fn = terr.height_fns(terrain, self._flat)
    boxes = terrain.boxes
    if base_xy is not None:
      boxes = self._pruned_boxes(boxes, base_xy)
    return contact.make_terrain_contact_fn(
        h_fn, n_fn, boxes=boxes,
        spheres=terrain.obstacle_spheres,
        friction=dyn.lateral_friction * self.cfg.fric_coeff[0],
        box_friction=dyn.lateral_friction)

  def step_batch(self, states: EnvState, actions, gen: torch.Generator):
    """Step every env: action expansion, the physics (one window launch
    over all envs on flat ground, else the per-env engine), sensors,
    task, camera.  Returns (states, obs (E, D), reward (E,), done (E,)
    bool, info)."""
    return self.step_from(states, actions,
                          self.draw_for_step(actions.shape[0], states, gen))

  def draw_for_step(self, n_env: int, states: EnvState, gen: torch.Generator
                 ) -> StepDraws:
    """Every draw of a step of n_env envs (leading axis the env's)."""
    return self.draw_step(n_env, states.terrain.boxes.shape[1], gen)

  def step_from(self, states: EnvState, actions, draws: StepDraws):
    """`step_batch` with its draws given."""
    with profiling.span("v4l.env.step"):
      return self._step_from(states, actions, draws)

  def _step_from(self, states: EnvState, actions, draws: StepDraws):
    cfg = self.cfg
    with profiling.span("v4l.env.pre"):
      states, act12 = self._step_pre(states, actions, draws)
      if self.kernel_capable:
        pos_xy = states.robot.phys.pos[:, :2]
        boxes = self._pruned_boxes(states.terrain.boxes, pos_xy)
        spheres = self._pruned_spheres(states.terrain.obstacle_spheres,
                                       pos_xy)
        fric_box = states.dyn.lateral_friction
        fric_ground = fric_box * cfg.fric_coeff[0]
    if not self.kernel_capable:
      rs, pen = self._engine_window(states, act12)
      return self._step_post(states, rs, act12, pen, draws)
    rs, pen = self._robot_window(
        self.model, states.robot, act12, states.dyn, boxes, spheres,
        fric_ground, fric_box, cfg.num_action_repeat * cfg.substeps,
        cfg.enable_action_interpolation)
    return self._step_post(states, rs, act12, pen, draws)

  def _engine_window(self, states: EnvState, act12):
    """The window of a non-flat step (JAX `step`, env.py:482-500):
    action_repeat substeps of the per-env engine over every env at once,
    boxes pruned by the base xy before the step, then the contact read of
    the post-window world.  Returns (robot state, penetration (E, P, 2))."""
    cfg = self.cfg
    with profiling.span("v4l.window"):
      cfn = self._contact_fn(states.terrain, states.dyn,
                             states.robot.phys.pos[:, :2])
      rs, _ = a1.robot_step(self.model, states.robot, act12, states.dyn,
                            cfn, cfg.num_action_repeat * cfg.substeps,
                            cfg.enable_action_interpolation)
      return rs, self._engine_pen(rs, cfn)

  def _engine_pen(self, rs: a1.RobotState, cfn):
    """The [ground, obstacle] penetration (E, P, 2) of the robot's contact
    points in the world of the contact function `cfn`."""
    kin = engine.fwd_kinematics(self.model, rs.phys)
    cpos, cvel, _ = engine.contact_points_world(self.model, rs.phys, kin)
    return cfn(cpos, cvel, self.model.cp_radius)[1]

  def _step_post(self, state: EnvState, rs, act12, pen, draws: StepDraws):
    """Sensors, task, reward, camera and observation after the window."""
    with profiling.span("v4l.env.post"):
      cfg = self.cfg
      ground_pen, box_pen = pen[..., 0], pen[..., 1]
      nonfoot_ground = torch.any((ground_pen > 0)
                                 & (self.model.cp_is_foot < 0.5), dim=-1)
      nonfoot_contact = nonfoot_ground | torch.any(box_pen > 0, dim=-1)
      state = state.replace(robot=rs)
      task_state = tasks.update(state.task, rs.phys.pos)
      m, imu, disp = self._sensor_readings(state)
      push = lambda new, hist: torch.cat([new[:, None], hist[:, :-1]], dim=1)
      state = state.replace(
          task=task_state, motor_hist=push(m, state.motor_hist),
          imu_hist=push(imu, state.imu_hist),
          disp_hist=push(disp, state.disp_hist),
          last_action_hist=push(act12, state.last_action_hist))
      task_cfg = self._task_cfg()
      is_done = tasks.done(task_cfg, task_state, rs.phys.pos, rs.phys.quat,
                           nonfoot_contact)
      rew, trackers = tasks.reward(
          task_cfg, task_state, maths.wxyz_to_xyzw(rs.phys.quat),
          rs.observed_torques, is_done, state.terrain.subgoals,
          state.terrain.goal_pos)
      state = state.replace(task=task_state.replace(subgoal_trackers=trackers),
                            step_counter=state.step_counter + 1)
      if self._redraws_dir:
        # RandoDirWrapper.observation (env_builder.py:127-142): every
        # dir_update_interval observations the direction is redrawn; it
        # steers the next step's reward and this step's observation
        rd, vec = wrappers.rando_dir_advance(
            wrappers.RandoDirState(state.dir_angle, state.dir_count),
            draws.dir_angle, cfg.dir_update_interval)
        state = state.replace(dir_angle=rd.angle, dir_count=rd.step_count,
                              task=state.task.replace(target_vel_dir=vec))
      if cfg.get_image:
        capture = (state.step_counter % cfg.get_image_interval) == 0
        if self._each_step_head:
          # per-step random visual delay (JAX env.py:554-562)
          shifted = torch.cat([draws.frame_head.to(torch.int32)[:, None],
                               state.frame_idx[:, :3] + cfg.frame_extract],
                              dim=1)
          state = state.replace(frame_idx=select(capture, shifted,
                                                 state.frame_idx))
        depth = self._render(state, draws.blind)
        # the whole ring is copied, as the JAX env's concatenate does
        frames = torch.cat([depth[:, None], state.frames[:, :-1]], dim=1)
        state = state.replace(frames=select(capture, frames, state.frames))
      info = {"subgoals_hit": torch.sum(1.0 - trackers, dim=-1)}
      return state, self._observation(state), rew, is_done, info

  def _task_cfg(self) -> tasks.TaskConfig:
    cfg = self.cfg
    return tasks.TaskConfig(
        goal=cfg.goal, z_constrain=cfg.z_constrain,
        other_direction_penalty=cfg.other_direction_penalty,
        z_penalty=cfg.z_penalty, time_step_s=cfg.time_step_s,
        num_action_repeat=cfg.num_action_repeat, height_fall_coeff=0.2,
        alive_reward=cfg.alive_reward, fall_reward=cfg.fall_reward,
        target_vel=cfg.target_vel, check_contact=cfg.check_contact,
        subgoal_reward=cfg.subgoal_reward, goal_coeff=cfg.goal_coeff)
