"""A1MoveGroundMPC: the RL env whose action is a velocity command that the
convex-MPC locomotion controller executes, batched over envs on one
device (torch mirror of vision4leg_tpu.envs.mpc_env).

Reference: vision4leg/envs/locomotion_gym_mpc_env_with_rich_information.py
  * action = (lin_speed, ang_speed), lin clipped to >= -0.05 (:480-484);
  * each env step runs `policy_freq` controller ticks of {gait/estimator
    update -> swing PD targets + stance MPC torques -> robot.Step
    (action_repeat substeps)} (:486-489);
  * observation = sorted {com_vel (world), imu rpy} + the depth frames
    (:574-588), or the frames alone when vision_only;
  * task = MoveForward/Goal with num_action_repeat * policy_freq scaling
    (env_builder.py:420-455).

On the flat terrains `step_batch` runs each tick's action-repeat window
as one launch of the physics-window kernel over all envs in its hybrid
mode (stance legs apply the MPC feedforward torque, swing legs track the
Raibert targets under PD); the controller stack between windows is
batched torch ops.  On the heightfield terrains it runs the JAX env's
per-env `step` (mpc_env.py:185-310) batched over the envs instead: the
same ticks over the per-env engine (`a1.substep` with the hybrid torque),
each env's heightfield in the contact model and the camera, and no
window launch.  The camera, the box pruning and the task plumbing are
A1GymEnv's.

`controller_step` advances every env by one controller tick alone (the
locomotion-controller demo's loop): an exact KKT inverse, then one tick
of the flat step's loop.

Reset settles every env for settle_steps * substeps substeps from the
standing pose at its own start position, as the reference does: on flat
ground through one non-hybrid launch of the same kernel (boxes pruned at
the start xy; `settle_windows` counts those launches), on a heightfield
through the per-env engine with every box, as the JAX reset does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vision4leg_torch.envs import tasks
from vision4leg_torch.envs import terrain as terr
from vision4leg_torch.envs.env import A1GymEnv, BlindSpots, EnvConfig, select
from vision4leg_torch.mpc import controllers as ctrl
from vision4leg_torch.mpc import convex_mpc
from vision4leg_torch.mpc import leg_kinematics as lk
from vision4leg_torch.ops import physics_envlast as pe
from vision4leg_torch.ops import physics_kernel
from vision4leg_torch.physics import engine, maths
from vision4leg_torch.robots import a1
from vision4leg_torch.robots import a1_params as P
from vision4leg_torch.utils import profiling

MPC_WEIGHTS = (5, 5, 0.2, 0, 0, 10, 0., 0., 1., 1., 1., 0., 0)


@dataclasses.dataclass(frozen=True)
class MpcEnvConfig(EnvConfig):
  policy_freq: int = 10
  vision_only: bool = False

  @property
  def action_dim(self) -> int:
    return 2

  @property
  def proprio_dim(self) -> int:
    return 0 if self.vision_only else 6  # com_vel(3) + rpy(3)


class MpcResetDraws(NamedTuple):
  """All randomness of an MPC reset (the dynamics are not randomized)."""
  terrain: terr.TerrainState
  init_jitter: torch.Tensor   # (E, 2) xy offset of the start position
  blind: BlindSpots


@dataclasses.dataclass
class MpcEnvState:
  robot: a1.RobotState
  dyn: a1.DynamicsParams
  terrain: terr.TerrainState
  task: tasks.TaskState
  controller: ctrl.ControllerState
  current_time: torch.Tensor      # (E,) controller clock (s)
  last_action: torch.Tensor       # (E, 2)
  last_base_pos: torch.Tensor     # (E, 3)
  frames: torch.Tensor            # (E, num_stored, 64, 64) or (E, 1, 1, 1)
  step_counter: torch.Tensor      # (E,) int32

  def replace(self, **kw) -> "MpcEnvState":
    return dataclasses.replace(self, **kw)


class A1MPCGymEnv(A1GymEnv):
  """Batched A1MoveGroundMPC on one device."""

  # options the JAX MPC env accepts and ignores (its frame indices are
  # fixed at k * frame_extract, its interpolation delay 0, its obstacles
  # still); the port rejects them
  _IGNORED_BY_JAX = ("reset_frame_idx", "reset_frame_idx_each_step",
                     "interpolation", "moving")

  def __init__(self, cfg: MpcEnvConfig, device=None):
    ignored = [k for k in self._IGNORED_BY_JAX if getattr(cfg, k)]
    if ignored:
      raise NotImplementedError(
          f"A1MoveGroundMPC options {ignored}: the JAX MPC env accepts and "
          "ignores them; the port rejects them (no shipped config sets "
          "them)")
    self._setup(cfg, device)
    clip = np.asarray(cfg.clip_num if cfg.clip_num is not None
                      else (0.3, 0.4), np.float32)
    self._act_low = torch.tensor(-clip, device=self.device)
    self._act_high = torch.tensor(clip, device=self.device)
    self.mpc_cfg = convex_mpc.MpcConfig(
        mass=float(P.MPC_BODY_MASS),
        inertia=tuple(float(x) for x in P.MPC_BODY_INERTIA),
        qp_weights=MPC_WEIGHTS, horizon=10, timestep=0.025, alpha=1e-5,
        admm_iters=40)
    # frozen Ruiz scaling and canonical KKT inverse of the warm QP path,
    # computed once in float64 on the CPU
    self.mpc_canon = convex_mpc.canonical_constants(self.mpc_cfg).to(
        self.device, torch.float32)
    self.gait_cfg = ctrl.GaitConfig()
    self.settle_windows = 0

  @property
  def action_low(self):
    return self._act_low

  @property
  def action_high(self):
    return self._act_high

  # ------------------------------------------------------------------
  def draw_reset(self, n_env: int, gen: torch.Generator) -> MpcResetDraws:
    cfg = self.cfg
    terrain = terr.TERRAIN_GENERATORS[cfg.terrain_type](gen, n_env,
                                                        self.device)
    r = cfg.random_init_range
    jitter = (torch.rand(n_env, 2, generator=gen, device=self.device) * 2 * r
              - r) if r > 0 else torch.zeros(n_env, 2, device=self.device)
    return MpcResetDraws(terrain, jitter, self.draw_blind_spots(n_env, gen))

  def settle(self, pos, terrain: terr.TerrainState,
             dyn: a1.DynamicsParams) -> a1.RobotState:
    """Every env dropped in the standing pose at `pos` (E, 3) and settled
    under PD to the standing command for settle_steps * substeps
    substeps: one launch of the physics window on flat ground, the
    per-env engine with every box unpruned on a heightfield (JAX `reset`,
    mpc_env.py:124-137)."""
    E = pos.shape[0]
    cmd = self._init_cmd.expand(E, 12).contiguous()
    phys = engine.zero_state(self.model, (E,)).replace(pos=pos,
                                                       joint_q=cmd.clone())
    n_sub = self.cfg.settle_steps * self.cfg.substeps
    if not self.kernel_capable:
      rs, _ = a1.robot_step(self.model, a1.init_robot_state(phys), cmd, dyn,
                            self._contact_fn(terrain, dyn), n_sub)
      return a1.init_robot_state(rs.phys)
    boxes = self._pruned_boxes(terrain.boxes, pos[:, :2])
    fb = dyn.lateral_friction
    rs, _ = self._robot_window(
        self.model, a1.init_robot_state(phys), cmd, dyn, boxes,
        terrain.obstacle_spheres, fb * self.cfg.fric_coeff[0], fb, n_sub)
    self.settle_windows += 1
    return a1.init_robot_state(rs.phys)

  def reset(self, n_env: int, gen: torch.Generator
            ) -> Tuple[MpcEnvState, torch.Tensor]:
    """A batch of n_env fresh envs and their observations (E, obs_dim)."""
    return self.reset_from(n_env, self.draw_for_reset(n_env, gen))

  def draw_for_reset(self, n_env: int, gen: torch.Generator) -> MpcResetDraws:
    return self.draw_reset(n_env, gen)

  def _reset_from(self, n_env: int, draws: MpcResetDraws
                  ) -> Tuple[MpcEnvState, torch.Tensor]:
    cfg = self.cfg
    E = n_env
    pos = torch.cat([self._init_pos[:2] + draws.init_jitter,
                     self._init_pos[2].expand(E, 1)], dim=-1)
    dyn = a1.default_dynamics(self.model, (E,))
    rs = self.settle(pos, draws.terrain, dyn)
    feet = lk.foot_positions_base_frame(rs.phys.joint_q)
    controller = ctrl.init_controller_state(
        feet, rs.phys.joint_q, convex_mpc.init_warm_state(self.mpc_canon, E))
    frames = (torch.zeros(E, cfg.num_stored_frames, 64, 64,
                          device=self.device)
              if cfg.get_image else torch.zeros(E, 1, 1, 1,
                                                device=self.device))
    state = MpcEnvState(
        robot=rs, dyn=dyn, terrain=draws.terrain,
        task=tasks.init_task_state(rs.phys.pos, terr.NUM_SUBGOALS),
        controller=controller,
        current_time=torch.zeros(E, device=self.device),
        last_action=torch.zeros(E, 2, device=self.device),
        last_base_pos=rs.phys.pos.clone(), frames=frames,
        step_counter=torch.zeros(E, dtype=torch.int32, device=self.device))
    if cfg.get_image:
      depth = self._render(state, draws.blind)
      state = state.replace(frames=depth[:, None].expand(
          E, cfg.num_stored_frames, 64, 64).clone())
    return state, self._observation(state)

  def _image_obs(self, state: MpcEnvState):
    """The frames at k * frame_extract (JAX mpc_env.py:144, 166-167)."""
    E = state.frames.shape[0]
    idx = (torch.arange(4, dtype=torch.int32, device=self.device)
           * self.cfg.frame_extract).expand(E, 4)
    return self._gather_frames(state.frames, idx,
                               torch.zeros(E, dtype=torch.int32,
                                           device=self.device))

  def _observation(self, state: MpcEnvState):
    cfg = self.cfg
    parts = []
    if not cfg.vision_only:
      # sorted keys: "com_vel" < "imu" (:581-588); com_vel is the
      # estimator's value in the world frame, imu the rpy
      quat = state.robot.phys.quat
      com_vel_body = ctrl.com_velocity_body(state.controller)
      parts += [maths.quat_rotate(quat, com_vel_body),
                maths.quat_to_rpy(quat)]
    if cfg.get_image:
      parts.append(self._image_obs(state))
    return torch.cat(parts, dim=-1).float()

  # ------------------------------------------------------------------
  def _contact_pen(self, rs: a1.RobotState, boxes, spheres, fric_ground,
                   fric_box):
    """[ground, obstacle] penetration (E, P, 2) of the current state."""
    st = physics_kernel.rs_to_envlast(rs)
    t = lambda x: x.movedim(0, -1)
    pen = pe.end_contact_pen(self.model, st, t(boxes),
                             t(spheres) if spheres.shape[1] > 0 else None,
                             fric_ground, fric_box)
    return pen.movedim(-1, 0)

  def _commands(self, actions):
    """The clipped actions (E, 2) and the commands they give: lin (E, 3)
    (forward speed clipped at -0.05, :480-484) and ang (E,)."""
    acts = torch.minimum(torch.maximum(actions, self._act_low),
                         self._act_high)
    lin = torch.cat([torch.clamp(acts[:, :1], min=-0.05),
                     torch.zeros_like(acts)], dim=-1)
    return acts, lin, acts[:, 1]

  def _window_world(self, states: MpcEnvState):
    """The world a flat step's windows see: the boxes and the spheres
    pruned at the step's start and the two friction coefficients (E,)."""
    pos_xy = states.robot.phys.pos[:, :2]
    fric_box = states.dyn.lateral_friction
    return (self._pruned_boxes(states.terrain.boxes, pos_xy),
            self._pruned_spheres(states.terrain.obstacle_spheres, pos_xy),
            fric_box * self.cfg.fric_coeff[0], fric_box)

  def step_inputs(self, states: MpcEnvState, actions):
    """What a flat env step holds fixed across its ticks: `_commands`,
    then `_window_world`."""
    return (*self._commands(actions), *self._window_world(states))

  def controller_tick(self, cs: ctrl.ControllerState, rs: a1.RobotState,
                      pen, t, lin, ang):
    """One tick of the controller stack for every env: gait (from the
    toes' contacts in pen (E, P, 2)), estimator, swing targets and the
    warm-path stance torques, at clock t (E,) for commands lin (E, 3) and
    ang (E,).  Returns (cs', the swing legs' joint targets (E, 12), the
    stance torques (E, 12), the stance mask (E, 12)): the hybrid window's
    command, tau_ff and tau_mask."""
    with profiling.span("v4l.mpc.tick"):
      foot_contacts = torch.amax(pen[:, :4], dim=-1) > 0.0   # (E, 4)
      cs = ctrl.gait_update(self.gait_cfg, cs, t, foot_contacts)
      quat = rs.phys.quat
      cs = ctrl.estimator_update(cs,
                                 maths.quat_rotate_inv(quat, rs.phys.lin))
      rpy = maths.quat_to_rpy(quat)
      rpy_rate = maths.quat_rotate_inv(quat, rs.phys.ang)
      feet = lk.foot_positions_base_frame(rs.phys.joint_q)
      cs, swing_q = ctrl.swing_action(cs, self.gait_cfg, rpy_rate[:, 2],
                                      lin, ang, feet)
      stance_tau, contact_state, cs = ctrl.stance_action_warm(
          self.mpc_cfg, self.mpc_canon, cs, rpy, rpy_rate, feet,
          rs.phys.joint_q, lin, ang)
      stance_mask = torch.repeat_interleave(
          contact_state.to(stance_tau.dtype), 3, dim=-1)
      return cs, swing_q, stance_tau, stance_mask

  def step_batch(self, states: MpcEnvState, actions, gen: torch.Generator):
    """Step every env: one exact KKT inverse, then policy_freq ticks of
    contact read -> gait -> estimator -> swing -> warm stance -> the
    action-repeat substeps (one hybrid window launch over all envs on
    flat ground, the per-env engine on a heightfield); then task, done,
    the NaN kill-switch, the camera and the observation.  Returns
    (states, obs (E, D), reward (E,), done (E,) bool, info)."""
    return self.step_from(states, actions,
                          self.draw_for_step(actions.shape[0], states, gen))

  def draw_for_step(self, n_env: int, states: MpcEnvState,
                 gen: torch.Generator) -> Optional[BlindSpots]:
    """A step's one draw: the camera's blind spots (None without it)."""
    return self.draw_blind_spots(n_env, gen) if self.cfg.get_image else None

  def _step_from(self, states: MpcEnvState, actions,
                 blind: Optional[BlindSpots]):
    """`step_batch` with its draw given (`A1GymEnv.step_from` opens the
    env step's span)."""
    cfg = self.cfg
    E = actions.shape[0]
    acts, lin, ang = self._commands(actions)
    states = states.replace(last_action=acts,
                            last_base_pos=states.robot.phys.pos)
    rs = states.robot

    # one exact KKT inverse per env step from the step-start pose; the
    # ticks' Newton-Schulz steps track the drift within the step
    cs = self._refresh_kkt(states.controller, rs)
    ticks = self._window_ticks if self.kernel_capable else self._engine_ticks
    rs, cs, t, pen = ticks(states, cs, lin, ang)
    states = states.replace(robot=rs, controller=cs, current_time=t)

    task_state = tasks.update(states.task, rs.phys.pos)
    nonfoot = (torch.any((pen[..., 0] > 0) & (self.model.cp_is_foot < 0.5),
                         dim=-1)
               | torch.any(pen[..., 1] > 0, dim=-1))
    task_cfg = self._task_cfg()
    is_done = tasks.done(task_cfg, task_state, rs.phys.pos, rs.phys.quat,
                         nonfoot)
    rew, trackers = tasks.reward(
        task_cfg, task_state, maths.wxyz_to_xyzw(rs.phys.quat),
        rs.observed_torques, is_done, states.terrain.subgoals,
        states.terrain.goal_pos)
    # NaN kill-switch (the reference collector asserts on NaN,
    # torchrl/collector/base.py:68-70): a diverged physics or controller
    # state ends the episode with the fall penalty and a finite reward,
    # so one bad env cannot poison the PPO update buffer
    finite = torch.isfinite(rew)
    is_done = is_done | ~finite
    rew = torch.where(finite, rew, cfg.fall_reward)
    states = states.replace(task=task_state.replace(subgoal_trackers=trackers),
                            step_counter=states.step_counter + 1)
    if cfg.get_image:
      capture = (states.step_counter % cfg.get_image_interval) == 0
      depth = self._render(states, blind)
      frames = torch.cat([depth[:, None], states.frames[:, :-1]], dim=1)
      states = states.replace(frames=select(capture, frames, states.frames))
    # the same kill-switch for the observation
    obs = self._observation(states)
    obs = torch.where(torch.isfinite(obs), obs, 0.0)
    return states, obs, rew, is_done, {}

  def _refresh_kkt(self, cs: ctrl.ControllerState, rs: a1.RobotState):
    """cs with the warm QP's KKT inverse computed exactly from the
    yawless pose and the feet of `rs`."""
    with profiling.span("v4l.mpc.kkt"):
      rpy = maths.quat_to_rpy(rs.phys.quat)
      feet = lk.foot_positions_base_frame(rs.phys.joint_q)
      kinv = convex_mpc.kkt_inverse(
          self.mpc_cfg, self.mpc_canon,
          torch.cat([rpy[:, :2], torch.zeros_like(rpy[:, 2:])], 1), feet)
    return cs.replace(qp_warm=cs.qp_warm.replace(kinv=kinv))

  def _window_ticks(self, states: MpcEnvState, cs, lin, ang, n_ticks=None):
    """The ticks of a flat step (JAX `step_batch`, mpc_env.py:340-419),
    policy_freq of them unless n_ticks is given: the controller stack,
    then one hybrid window launch of num_action_repeat * substeps
    substeps, boxes and spheres pruned at the step's start.  The first
    tick's contacts are read from the step's start; later ticks take the
    window's post-state penetration, which is the next tick's
    start-of-tick world.  Returns (robot state, controller, clock (E,),
    the post-step penetration (E, P, 2))."""
    cfg = self.cfg
    world = self._window_world(states)
    rs, t = states.robot, states.current_time
    pen = self._contact_pen(rs, *world)
    for _ in range(cfg.policy_freq if n_ticks is None else n_ticks):
      cs, swing_q, stance_tau, stance_mask = self.controller_tick(
          cs, rs, pen, t, lin, ang)
      rs, pen = self._robot_window(
          self.model, rs, swing_q, states.dyn, *world,
          cfg.num_action_repeat * cfg.substeps, False, stance_tau,
          stance_mask)
      t = t + cfg.num_action_repeat * cfg.time_step_s
    return rs, cs, t, pen

  def controller_step(self, states: MpcEnvState, lin, ang) -> MpcEnvState:
    """Every env advanced by one controller tick on flat ground at the
    commands lin (E, 3) and ang (E,), as the locomotion-controller demo
    drives the JAX env's `_controller_tick` (mpc_env.py:185-232): one
    exact KKT inverse from the yawless pose, then one of `_window_ticks`
    (one hybrid window launch) and the clock.  No task, reward or
    camera."""
    if not self.kernel_capable:
      raise NotImplementedError(
          f"controller_step runs the physics window on flat ground; "
          f"terrain {self.cfg.terrain_type!r} has a heightfield")
    cs = self._refresh_kkt(states.controller, states.robot)
    rs, cs, t, _ = self._window_ticks(states, cs, lin, ang, n_ticks=1)
    return states.replace(robot=rs, controller=cs, current_time=t)

  def _engine_ticks(self, states: MpcEnvState, cs, lin, ang):
    """The ticks of a heightfield step (JAX `step` and `_controller_tick`,
    mpc_env.py:185-261), batched over the envs: each tick reads the toes'
    contacts of the state it starts from, runs the controller stack, then
    num_action_repeat * substeps substeps of the per-env engine under the
    hybrid torque; one contact function, boxes pruned at the step's start
    base xy, serves every read and substep.  Returns what `_window_ticks`
    does."""
    cfg = self.cfg
    rs, dyn = states.robot, states.dyn
    cfn = self._contact_fn(states.terrain, dyn, rs.phys.pos[:, :2])
    model_d = a1.apply_dynamics(self.model, dyn)
    t = states.current_time
    for _ in range(cfg.policy_freq):
      cs, swing_q, stance_tau, stance_mask = self.controller_tick(
          cs, rs, self._engine_pen(rs, cfn), t, lin, ang)
      for _ in range(cfg.num_action_repeat * cfg.substeps):
        rs, _ = a1.substep(model_d, rs, swing_q, dyn, cfn, stance_tau,
                           stance_mask)
      t = t + cfg.num_action_repeat * cfg.time_step_s
    return rs, cs, t, self._engine_pen(rs, cfn)

  def _task_cfg(self) -> tasks.TaskConfig:
    cfg = self.cfg
    return tasks.TaskConfig(
        goal=cfg.goal, z_constrain=cfg.z_constrain,
        other_direction_penalty=cfg.other_direction_penalty,
        z_penalty=cfg.z_penalty, time_step_s=cfg.time_step_s,
        num_action_repeat=cfg.num_action_repeat * cfg.policy_freq,
        alive_reward=cfg.alive_reward, fall_reward=cfg.fall_reward,
        target_vel=cfg.target_vel, check_contact=cfg.check_contact,
        subgoal_reward=cfg.subgoal_reward, goal_coeff=cfg.goal_coeff)
