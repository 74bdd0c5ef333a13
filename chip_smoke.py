"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with the seconds since start:
  1. card name and power limit (nvidia-smi), torch / CUDA versions;
  2. build of the main path's CUDA kernels from this checkout's sources,
     one nvcc for each source, all started together (physics_window.cu;
     transformer_layer.cu with the layer's forward and backward), with
     ptxas's register and spill counts;
  3. the window kernel against its plain PyTorch version, on the card,
     at the shapes the main path gives it (1024 envs), on rollout states
     and on a batch standing on boxes and spheres (`contact_case`), and
     on the 101-env batch of the card test
     tests/test_torch_kernel_cuda.py::test_kernel_matches_plain[2]
     (`sphere_case`), by `physics_kernel.compare_with_plain`; two calls
     must give the same bits; then the kernel alone
     (`window_kernel_ms`), the whole wrapper call (with its env-first <->
     env-last packing) and the plain version timed with CUDA events on
     the rollout batch, the first two also on its first 8 envs (eval's
     batch), and the bound of `ops/window_cost.py` for the rollout data;
  4. the collection path: thin-goal LocoTransformer collection (get_env
     from config/rl/static/locotransformer/thin-goal.json, the
     actor-critic at the config's full width with seeded random weights,
     init_collector, one 16-step rollout at 1024 envs, fused layer off),
     with every kernel's launch count set to 0 just before the rollout
     and read just after;
  5. the transformer-layer kernels against their plain versions at
     B = 1024, 1000, 8 and 512, on the encoder's 17 tokens of phase 4's
     observations and on random x, and at B = 1024, 512 and 8 on the 16
     tokens of the vision-only model's encoder (T = 16) of the same
     observations and on random x: the forward against
     `ops/attention.layer_math` (its residual-saving mode must give the
     same bits), what the backward kernel writes against
     `layer_backward_rows` on the residuals the forward kernel wrote, and
     end to end
     `fused_transformer_layer_ad`'s gradients against autograd of
     `layer_math` (`attention.compare_grads_with_plain`: within the JAX
     package's tolerance of the float32 autograd or, where float32 cannot
     do better, within twice the plain layer's own float32 spread of the
     float64 autograd, the spread taken per gradient tensor over the
     inputs and eight copies moved by one float32 rounding unit.  Two
     things make float32 part there: a weight gradient sums 17,408
     products at B = 1024, and two float32 computations of it part by
     ~1e-4 where it cancels; and an FFN pre-activation within ~1e-7 of
     zero can take the other side of the ReLU in the kernel's forward
     than in the plain one, which moves the sample's whole gradient by
     O(0.1-1).  The one-ulp copies of the plain layer flip such kinks
     too, and the spread includes them.  The run prints the elements
     excused and every mask flip with its plain pre-activation); two
     backward calls must give the same bits; the backward kernel's ptxas
     counts; the forward, and forward + backward under autograd, of the
     kernels, of the plain version and of torch's own
     nn.TransformerEncoderLayer (the yardstick, never called by the port)
     timed with CUDA events, with the bounds of `attention.layer_cost` and
     `layer_grad_cost`.  The forward kernel's products run in
     3xTF32 on the tensor cores: its bound is three TF32 FLOPs for each
     float32 one at the dense TF32 peak, printed beside the same FLOPs on
     the float32 CUDA cores; also the forward at eval's B = 8, the saving
     forward's bound (`layer_saved_cost`: the residuals' bytes), the
     samples each tile takes at each B, the forward's ptxas counts (no
     spills) and its SASS's tensor-core (HMMA) instructions (at least
     one); the forward, forward + backward, plain and library times and
     the bounds also at (B, T) = (512, 17), (1024, 16), (512, 16) and
     (8, 16);
  6. the training path: the port's starter pieces build a PPOAgent from
     the same config (1024 envs, full width, fused layer on in
     collection and update), which trains two epochs with an eval after
     each and a checkpoint after the second, the launch counts set to 0
     just before and read just after and held to the exact counts of the
     path (the layer backward: 4 per minibatch, 4 x 48 = 192 an epoch);
     metrics finite, parameters changed, the checkpoint restored into a
     second agent equal to the first (`phase_training`);
  7. the starter's TF32 setting: `pi_v` on phase 4's observations under
     torch's defaults (cuDNN convolutions in TF32, as the starter runs)
     held against `pi_v` with TF32 off, at TF32_TOL;
  8. the window kernel's hybrid mode (the MPC env's window, 5 substeps:
     torque = (1-mask) PD + mask tau_ff) against its plain version at
     1024 envs by `compare_with_plain`, on the MPC env's own states after
     two steps with the tau_ff/mask of their next controller tick, and on
     a `contact_case` batch with random masks that mix stance and swing
     legs per env (`hybrid_contact_case`); timed as in phase 3, at 1024
     and 8 envs, and the bound of `ops/window_cost.py`;
  9. MPC collection: get_env from config/mpc/locotransformer/
     thin-goal.json, the LocoTransformer actor-critic at full width
     (action_dim 2, proprio 6), init_collector and one 8-step rollout at
     1024 envs (fused layer off); the window's launches set to 0 just
     before and held to 8 x policy_freq hybrid launches plus one per
     partial reset's settle, counted apart;
 10. the MPC controller's behaviour on the card (the criterion of
     tests/test_mpc.py::test_mpc_env_walks_forward): plane, 64 envs,
     action (0.3, 0) for 20 steps; no env done, base z > 0.15 m
     throughout, forward progress > 0.15 m on every env;
 11. the PPO update with the fused layer (both kernels) against the
     unfused update from one state, four minibatches each
     (`fused_update_check`), held to the float32 ReLU-kink band of
     tests/test_torch_ppo.py (FUSED_UPDATE_BAND): the LocoTransformer on
     four rows of 1024 of phase 4's observations, and the MPC model on
     the first 512 envs of four steps of phase 9's;
 12. MPC training (`phase_training` as in phase 6): the port's starter
     pieces build PPOAgents from config/mpc/locotransformer/thin-goal.json
     (two epochs) and config/mpc_vision_only/locotransformer/
     thin-goal.json (one epoch, the vision-only model: the layers at
     T = 16; its zero-size proprio normalizer's obs_norm_var_max must be
     0) at 1024 envs, full width, fused layer on; 8-step rollouts, an
     update of 3 x 8 minibatches of 1024 (the JAX learner takes whole
     time rows: batch_size 512 // 1024 envs gives one row), an eval of
     MPC_EVAL_HORIZON steps x 8 envs after each epoch; the window's
     hybrid launches held to 20 per env step, its settle launches (one a
     reset) counted apart; the checkpoint, MpcEnvState included,
     restored equal;
 13. MMDR on moving obstacles (`phase_training` as in phase 6):
     config/rl/moving/locotransformer_random_delay/thin-goal.json, the
     LocoTransformer at full width, 1024 envs, fused layer on, one epoch
     (a 16-step rollout, 3 x 16 minibatches of 1024), an eval of 32 x 8,
     the checkpoint (frame indices, interpolation delays and moving
     directions included) restored equal, launches held exactly; then
     every frame_idx[:, k] in [k fe, (k + 1) fe), one more step moving
     each of the first 50 boxes by its table step exactly
     (`check_mmdr_step`), observations finite;
 14. the Nature-CNN baseline (`starter/ppo_nature_cnn.py`'s module) on
     config/rl/moving/frame_extract4_random_delay/thin-wide.json, one
     epoch at 1024 envs (no fused layer: the window's launches held);
     then the window against its plain version by `compare_with_plain`
     on `moving_case`: that epoch's last states, the boxes moved by one
     more step and pruned, with the nearest box of every fourth env moved
     against a toe; two calls give the same bits; timed as in phase 3;
 15. one 16-step collection at 1024 envs of config/rl/static/
     frame_extract4_interpolation/thin-goal.json (each interpolated image
     between the minimum and maximum of the frames it averages) and of
     frame_extract4_fixed_delay/thin-goal.json (slots fe - 1 ... 4 fe - 1),
     both with the Nature-CNN model, and a 4-step collection of
     config/mpc_vision_only/baseline/thin-goal.json with the vision-only
     Nature-CNN model (4 x 20 hybrid launches, settles counted apart);
 16. the mountain (`phase_training` as in phase 6): config/rl/challenge/
     locotransformer/mountain.json, the LocoTransformer at full width,
     1024 envs, fused layer on, one epoch and an eval of 32 x 8 on the
     per-env engine and the heightfield camera: the window's launches
     held to 0, the layer's exactly; then a fresh reset of 1024 envs
     stands every base within 2 cm of the template's height above its
     own ground, and three more steps give the non-flat step's split
     on the host clock (engine window / camera / rest) and the march
     alone on CUDA events (`check_nonflat`, `time_nonflat_step`);
 17. one 16-step collection at 1024 envs of config/rl/static/
     frame_extract4_random_delay/thin-heightfield.json (Nature-CNN, the
     per-env grids) and of state-only-baseline.json (StateActorCritic, no
     camera), the window never launched, torch.cuda.max_memory_allocated
     printed, each step's split as in phase 16;
 18. one 16-step collection at 1024 envs each of config/rl/challenge/
     locotransformer/stairs.json and chair_desk.json on the window (16
     launches each); the window against its plain version by
     `compare_with_plain` on `stairs_case` (a toe of every env on a step's
     edge); two calls give the same bits; timed as in phase 3;
 19. MPC on the heightfield: config/mpc/locotransformer/
     thin-heightfield.json, the LocoTransformer at full width, 1024 envs,
     fused layer on, through a PPOAgent: the reset, a 2-step rollout and
     an eval of 2 steps x 8 envs on the per-env engine; the window never
     launched (rows 1 and 1h), the layer's launches exact, every output
     finite; each step's host-clock split (engine ticks, controller,
     camera, the resets after it, rest: `StepSplit`);
 20. thin-random-shape (`phase_random_shape`): config/rl/static/
     locotransformer/thin-random-shape.json draws the boxes of thin.json
     from the same seed (random_shape is ignored, as in the JAX env); a
     16-step collection of it at 1024 envs (16 window launches) and one
     step of config/mpc/baseline/thin-random-shape.json (20 hybrid
     launches, the settles counted apart);
 21. sim2sim (`phase_sim2sim`, `phase_training` as in phase 6): the
     Nature-CNN of vision4leg_torch/starter/ppo_nature_cnn_sim2sim.py on
     config/rl/static/frame_extract4_random_delay/thin-goal.json, one
     epoch at 1024 envs, its eval of 32 (of the transform's 2000) steps x
     8 on the transfer env (`sim2sim_eval_params`); the window's launches
     exact; the eval env's options as the transform sets them, and its
     eval reads the training collector's normalizer, the same object;
 22. bf16 collection and the action filter: a float32 and a bf16 16-step
     thin-goal rollout at 1024 envs, fused layer asked for in both, timed
     in turn; the layer launched 4 x 16 + 2 times in float32 and 0 times
     under bf16 (its forward runs the unfused layer, as the JAX layer
     routes a non-float32 input); the bf16 pi_v within BF16_BAND of the
     float32 one on the same observations (`phase_bf16`); then a 16-step
     thin-goal collection with enable_action_filter on (16 window
     launches) and the filtered commands' range;
 23. the locomotion-controller demo (`vision4leg_torch/starter/
     locomotion_controller_example.py`'s `run`, robot a1, DEMO_TIME s of
     its profile: 2,000 ticks at one env, standing then turning left):
     its first DEMO_HOLD_TICKS ticks in float64 through the kernel held
     against the same ticks through the window's plain version at 1e-9
     (`demo_float64_hold`); then the run, counts set to 0 just before:
     one hybrid launch a tick and one settle launch for the reset; the
     robot upright by the demo's criterion; sim and wall seconds, the
     per-tick host ms (KKT inverse, controller, window, contact read,
     rest; `SpanTimer`) and each segment's tracking line;
 24. the cold convex-MPC solve (`convex_mpc.compute_contact_forces`):
     the warm path within COLD_BAND of it on the JAX test's protocol
     (tests/test_mpc.py:352-398: one env walking at (0.3, 0), the first 8
     steps) and in every one of 1024 envs of phase 9's states, where its
     float32 solve is held against its float64 solve (COLD_F32_TOL) and
     the gap's distribution printed; its float64 solve of 8 envs on the card
     against the CPU's at 1e-8 relative; the native core
     (`mpc/native/convex_mpc.cpp`) built by g++ and held against the
     float64 cold solve on every robot's standing QP within 3.0 N; the
     cold and warm solve and the exact KKT inverse timed with CUDA events
     (`phase_cold_solver`; run right after phase 9);
 25. the sphere terrain: a 16-step collection at 1024 envs of thin-goal
     with terrain_type random_sphere_with_subgoal, the LocoTransformer
     with the fused layer on (launches exact: the window 16, the layer
     4 x 16 + 2); then `sphere_terrain_case` (its states' spheres pruned
     as step_batch prunes them, one sphere against a toe in every fourth
     env) by `compare_with_plain`, two calls with the same bits, timed as
     phase 3 (`phase_spheres`);
 26. random_dir (interval 5) and rotate_sensor with the displacement
     sensor on, on a 16-step thin-goal collection at 1024 envs: the
     window 16 launches, the observation width the JAX formula's, every
     direction redrawn exactly on the counts the interval divides
     (`DirWatch`);
 27. a policy the JAX package trained (runs/mmdr_moving_10M: MMDR on
     moving obstacles), on the port: a copy of the run in a temporary
     directory, a PPOAgent built from its params.json by the starter's
     pieces (fused layer on) warm-starts from its model_pf_best.flax,
     read without JAX (`utils/flax_msgpack.py`): epoch, frames and best
     eval as its log.csv's; rows 2 and 2ad held against their plain
     versions on its first observations with the trained weights
     (`check_layer_case`, B = 1024 and 8); then `evaluate` at 32 envs x
     999 steps, launches held (row 1 once a step, row 2 twice), the
     returns (mean, min, max, fall share) printed beside the JAX log's
     last five evals, the mean held to JAX_EVAL_FLOOR (`phase_jax_run`);
 28. the port's locotransformer_viewer on that copy (2 episodes of 999
     steps, the depth mp4 written and checked non-empty) and env_viewer
     on thin-goal (64 steps at one env, its env-steps/s), launches held
     (`phase_viewers`);
 29. the layer kernels at 33 tokens, the forward's large instantiation
     (run right after phase 5): the 16-channel LocoTransformer's
     tokenizer (seeded random weights, phase 4's observations with eight
     rgb frames put before the depth) at B = 1024 and 8, and random x,
     by `check_layer_case`; the forward, forward + backward, plain and
     library times and bounds at (1024, 33) and (8, 33); row 2 at (1024,
     17) timed again beside them; the model's pi_v fused against unfused
     (`phase_layer_33`);
 30. 16-step collections at 1024 envs, fused layer on, of config/rl/
     challenge/locotransformer/hill.json (random_hill, the per-env engine:
     no window launch) and of thin-goal with terrain_type multi_stairs and
     random_blocks (the window once a step) (`phase_terrains`);
 31. the trajectory-generator wrapper (envs/trajectory_generator.py) on a
     16-step thin-goal collection at 1024 envs, diagonal_act off: launches
     held, the phase of the envs no reset restarted, the commands within
     the joint limits (`phase_trajectory_generator`);
 32. the rest of the on-policy family (`phase_on_policy_family`): a
     16-step thin-goal collection at 1024 envs with the LocoTransformer at
     full width, fused collection forward (rows 1 and 2); from copies of
     its weights and trajectory one update_per_epoch each of A2C,
     REINFORCE and V-MPO with the fused update (row 2ad) and of TRPO
     unfused, over the 16,384 samples; A2C and V-MPO also unfused (four
     minibatches from one state held to FUSED_UPDATE_BAND, as phase 11;
     the whole epoch's difference printed); TRPO asked for a fused update raises before any
     launch, and a second derivative through the fused layer raises on
     the card; each learner's float64 update on the first 64 envs x 4
     steps on the card against the CPU within 1e-7 relative (TRPO's
     accepted step fraction printed on each); launches exact;
 33. PPO-aux (`phase_ppo_aux`): ImpalaFuseResidualActorCritic at (256,
     256), visual_dim 256, on thin-goal's observations, a 16-step
     collection at 1024 envs (row 1), one PPO-aux epoch at the config's
     opt_epochs 3 and aux_coeff 1.0; the float64 update on the first 64
     envs x 2 steps on the card against the CPU;
 34. the off-policy family (`phase_off_policy`): state-only-baseline's env
     at 1024 envs with terrain_type random_blocks_sparse_with_subgoal (the
     window carries every step), an OffPolicyAgent with a 2**20 replay on
     the card for each of TwinSACQ, TD3, DDPG and SAC at (256, 256),
     batch 256: pretrain 16 steps, train_epoch(16384); replay size and
     update_count exact, row 1 once a step; each learner's update from one
     replay sample with injected draws, and DQN's three modes on seeded
     batches, in float64 on the card against the CPU within 1e-9;
 35. the hierarchical collector (`phase_hierarchical`): phase 34's env,
     a frozen low level and a high level at (256, 256), a 16-step
     rollout (row 1), one PPO epoch on the high level; the stored actions
     1-dim, the act path on the card against the CPU within 1e-6;
 36. the deploy stack (`phase_deploy`): vision4leg_torch/hardware/
     execute_locotransformer.py --fake-robot over a copy of the JAX-trained
     runs/thin_goal_10M (read without JAX), DEPLOY_SECONDS of policy at
     25 Hz between stand, warmup and sit; the layer kernel launched at
     (1, 17) twice a tick and nothing else; the recorded observations'
     actions on the card against the CPU's plain path within
     DEPLOY_ACT_TOL; row 2 at (1, 17) and (3, 17) by `check_layer_case`
     on their tokens and on three seeded observations' (samples that
     differ everywhere), and timed at (1, 17) against its plain version
     and the library layer; the tick's and the forward's median and p99;
 37. env-axis data parallelism (`phase_ranks`), every epoch with partial
     resets at unequal counts a rank (`gated_epoch`): a world-1 NCCL
     thin-goal epoch bit-equal to the unranked agent's (cuDNN
     deterministic); two gloo ranks sharing the card at 2 x 512 envs,
     fused, against one agent at 1024 from the same seed: the same
     initial observations, each rank's launches of rows 1, 2 and 2ad
     exact, the trajectory's terminals, reset observations, first
     normalizer, action draws and first steps (RANK_GATED_FIELDS) the
     unranked one's, the ranks' parameters the same bits, four fused
     minibatches from one state within FUSED_UPDATE_BAND of the unranked
     ones (phase 11's protocol), the later steps and the whole epoch's
     difference printed;
 38. the long training path as a user starts it (`phase_long_run`):
     the LocoTransformer starter's `run_experiment` with the CLI of a
     long run, --config config/rl/moving/frame_extract4_random_delay/
     thin-goal.json --num_envs 1024 --num_epochs 10 (V4L_FUSED_ATTN=1,
     V4L_FUSED_UPDATE=1: the fused layer in collection, update and eval),
     the config's eval every 10 epochs (8 envs x 999 steps at epoch 9);
     launches set to 0 just before and held to the path's exact counts;
     log.csv with epochs 0-9 once each, the JAX log's columns first,
     every entry finite, 0 non-finite observations and rewards, an
     Eval_Rewards_Average at epoch 9; model_pf_best written;
 39. one JSON line with every kernel's numbers (launches summed over the
     paths, with each path's count and the shapes run), then the last
     line {"ok": true, "device": {...}}.

Cuts of depth: training runs two epochs (thin-goal, MPC) or one
(vision-only, MMDR, Nature-CNN, mountain, sim2sim) of the configs' 1500;
the non-MPC evals 32 of 999 steps (sim2sim: of 2000) and the MPC evals 4
(an MPC step is host-bound at ~0.25-0.5 s); MPC collection one 8-step
rollout, the vision-only baseline's 4 steps, the random-shape MPC
baseline's 1; the MPC heightfield 2 collection steps and 2 eval steps
(each step runs 100 substeps of the per-env engine, each reset 400); the
MPC walk 20 steps at 64 envs; the demo 10 s of its profile's 20 (its
first two segments); the JAX-trained policy's eval 32 envs of 999 steps,
its viewer 2 episodes; the env viewer 64 steps at one env; the on-policy
family, PPO-aux and the hierarchical collector one epoch each, the
off-policy learners 16 pretrain steps and one epoch of 16 steps each; the
float64 card-vs-CPU updates the first 64 envs of 4 steps (PPO-aux: 2);
the deploy run 2 s of policy; the ranks one epoch; the long run's
starter 10 of its 611 epochs (tools/long_train.py runs them all).
Widths are the configs' own.

Float32 matmuls and convolutions run with TF32 off (both flags set
below), since outputs are compared; phase 7 turns cuDNN's TF32 on for
one call.  Any failed phase raises: the script then exits non-zero and
prints no result line.  Without a CUDA card it exits non-zero before
doing anything.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()


def log(msg: str):
  print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


NUM_ENVS = 1024   # bench.py:167
CONFIG = "config/rl/static/locotransformer/thin-goal.json"
MPC_CONFIG = "config/mpc/locotransformer/thin-goal.json"
# pi_v with cuDNN's TF32 convolutions against pi_v in full float32: TF32
# keeps 10 mantissa bits (relative rounding 2**-11 = 4.9e-4 per product);
# over the encoder's three convolutions and the MLP/transformer that
# follows, 1e-2 absolute plus 1e-2 relative bounds what that rounding can
# move a policy mean or a value of O(0.1-1) without a fault
TF32_TOL = dict(atol=1e-2, rtol=1e-2)
WALK_ENVS, WALK_STEPS = 64, 20


def actor_critic(env, params, generator=None):
  """The LocoTransformer actor-critic at the config's full width."""
  from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
  from vision4leg_torch.starter.common import locotransformer_kwargs
  return LocoTransformerActorCritic(**locotransformer_kwargs(env, params),
                                    generator=generator)


def build_env(config, dev, overrides=None):
  """(env, meta, params) of a JSON config of this checkout on `dev`,
  unchanged but for the env_build entries in `overrides`."""
  from vision4leg_torch.envs.get_env import get_env
  root = os.path.dirname(os.path.abspath(__file__))
  with open(os.path.join(root, config)) as f:
    params = json.load(f)
  params["env"]["env_build"].update(overrides or {})
  env, meta = get_env(params["env_name"], params["env"], device=dev)
  return env, meta, params


def build_main_path(dev, config=CONFIG):
  """(env, meta, policy, params) of thin-goal collection on `dev` (or of
  `config`'s), read from the unchanged JSON config; policy weights random
  from seed 0."""
  import torch
  env, meta, params = build_env(config, dev)
  net = actor_critic(env, params, torch.Generator().manual_seed(0))
  return env, meta, net.to(dev).eval(), params


def build_mpc_path(dev):
  """build_main_path of thin-goal MPC collection."""
  return build_main_path(dev, MPC_CONFIG)


def mpc_window_inputs(env, states, actions):
  """The hybrid window's inputs of the first controller tick of an MPC env
  step from `states` under `actions`: the swing targets as the command,
  the stance torques as tau_ff, the stance legs as the mask."""
  _, lin, ang, boxes, spheres, fg, fb = env.step_inputs(states, actions)
  rs = states.robot
  pen = env._contact_pen(rs, boxes, spheres, fg, fb)
  _, swing_q, tau_ff, mask = env.controller_tick(
      states.controller, rs, pen, states.current_time, lin, ang)
  return (env.model, rs, swing_q, states.dyn, boxes, spheres, fg, fb,
          env.cfg.num_action_repeat * env.cfg.substeps, False, tau_ff, mask)


def rollout_window_inputs(env, st, act12):
  """The window's inputs of one env step of a flat RL env from states
  `st` under the 12-joint command act12: the boxes and the spheres
  pruned at each base, as step_batch hands them to the window."""
  xy = st.robot.phys.pos[:, :2]
  fb = st.dyn.lateral_friction
  return (env.model, st.robot, act12, st.dyn,
          env._pruned_boxes(st.terrain.boxes, xy),
          env._pruned_spheres(st.terrain.obstacle_spheres, xy),
          fb * env.cfg.fric_coeff[0], fb, env.cfg.num_action_repeat)


def sphere_case(dev):
  """The batch of tests/test_torch_kernel_cuda.py::test_kernel_matches_plain
  [2], built the same way: 101 envs standing near a box and a sphere from
  numpy seed 0, commands within 0.3 rad of the standing pose, 16
  substeps.  Its env 96 parted from the plain version before the window
  was built without FMA contraction (csrc/physics_window.cu header)."""
  import numpy as np
  import torch
  from vision4leg_torch.physics import engine
  from vision4leg_torch.robots import a1, a1_model
  E = 101
  rng = np.random.default_rng(0)
  model = a1_model.build(dt=0.0025, device=dev)
  t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
  q0 = np.array([0, 0.9, -1.8] * 4, np.float32)
  phys = engine.PhysState(
      pos=t(np.c_[rng.uniform(-0.1, 0.1, (E, 2)), np.full(E, 0.27)]),
      quat=t(np.tile([1.0, 0, 0, 0], (E, 1))),
      joint_q=t(q0 + rng.uniform(-0.1, 0.1, (E, 12))),
      ang=t(rng.normal(0, 0.2, (E, 3))), lin=t(rng.normal(0, 0.2, (E, 3))),
      joint_qd=t(rng.normal(0, 0.5, (E, 12))))
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
  spheres = np.zeros((E, 2, 5), np.float32)
  spheres[:, 0] = [-0.18, 0.13, 0.0, 0.12, 1.0]
  cmd = t(q0 + rng.uniform(-0.3, 0.3, (E, 12)))
  return (model, a1.init_robot_state(phys), cmd, dyn, t(boxes), t(spheres),
          t(np.ones(E)), t(np.ones(E)), 16)


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


def contact_case(model, tmpl, xy, cmd, dyn, n_sub):
  """Window inputs for `model` in which every env stands on obstacles of
  its own: the standing template `tmpl`'s pose varied per env (joint angles, height, tilt,
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


def card_name() -> str:
  """The card's name and power limit, as nvidia-smi gives them."""
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return smi.stdout.strip().splitlines()[0]


def time_ms(fn, n=25, warm=3):
  """Milliseconds per call of `fn`: CUDA events around n calls issued back
  to back after `warm` calls, so that the host's time to issue a call
  overlaps the card's work and a short kernel is not timed with its
  wrapper's Python."""
  import torch
  for _ in range(warm):
    fn()
  torch.cuda.synchronize()
  s, e = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
  s.record()
  for _ in range(n):
    fn()
  e.record()
  e.synchronize()
  return s.elapsed_time(e) / n


def layer_wrapper_counts():
  """The fused layer's launch counters (forward, backward): the calls its
  wrappers made, each of which launched a kernel or put one in a CUDA
  graph being captured."""
  from vision4leg_torch.ops import attention as att
  return (att.fused_transformer_layer.launches,
          att.fused_transformer_layer_bwd.launches)


def layer_kernels(fn):
  """fn() under a profiler of the card: (fn's result, (forward, backward)
  kernels of the fused layer the card ran, counted by name from the
  device trace, a CUDA graph's replays included)."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    out = fn()
    torch.cuda.synchronize()
  names = [e.name() for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")]
  return out, (sum("transformer_layer_kernel" in n for n in names),
               sum("transformer_layer_bwd_kernel" in n for n in names))


class UpdateKernels:
  """While entered, each PPO `update_per_epoch` (the base class's, which
  replays its minibatch step as a CUDA graph on one card) runs under
  `layer_kernels`: its layer kernels are counted from the device trace,
  and the calls its wrappers made (the eager steps' and the captures')
  are kept apart.  `launches(counts)` turns the wrapper counts of a path
  into its launches: the counts outside the updates, plus the kernels
  inside them.  The updates' times include the profiler's cost."""

  def __enter__(self):
    from vision4leg_torch.algo.on_policy_base import OnPolicyLearner
    self.calls, self.kernels = [0, 0], [0, 0]
    update = OnPolicyLearner.update_per_epoch

    def traced(learner, *args, **kw):
      before = layer_wrapper_counts()
      out, kernels = layer_kernels(lambda: update(learner, *args, **kw))
      for i, (a, b) in enumerate(zip(before, layer_wrapper_counts())):
        self.calls[i] += b - a
        self.kernels[i] += kernels[i]
      return out
    OnPolicyLearner.update_per_epoch = traced
    self._undo = lambda: setattr(OnPolicyLearner, "update_per_epoch",
                                 update)
    return self

  def __exit__(self, *exc):
    self._undo()

  def launches(self, counts):
    return tuple(c - k + n for c, k, n in zip(counts, self.calls,
                                              self.kernels))


def window_kernel_ms(args, fn=None, n=25, warm=3):
  """Milliseconds per launch of the window kernel alone on the window
  inputs `args`: `physics_kernel._launch` packs them once, and its launch
  runs the kernel (`fn`, the C launch function; default: this checkout's
  build) warm + n times back to back, the last n between CUDA events.
  The launch count is left as it was."""
  import torch
  from vision4leg_torch.ops import physics_kernel as pk
  fn = pk.build_library().physics_window_launch if fn is None else fn
  out = {}

  def launch(*a):
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(warm):
      fn(*a, stream)
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    errs = [fn(*a, stream) for _ in range(n)]
    e.record()
    e.synchronize()
    out["ms"] = s.elapsed_time(e) / n
    return max(errs, key=abs)

  before = pk.robot_window.launches
  pk._launch(*args, launch=launch)
  pk.robot_window.launches = before
  return out["ms"]


def take_envs(args, n):
  """Window inputs `args` cut to their first n envs (the model is
  shared)."""
  import dataclasses
  import torch

  def cut(x):
    if isinstance(x, torch.Tensor):
      return x[:n]
    if dataclasses.is_dataclass(x):
      return dataclasses.replace(x, **{
          f.name: cut(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x
  return (args[0],) + tuple(cut(a) for a in args[1:])


def same_bits(a, b) -> bool:
  """Whether two window results (RobotState, pen) hold the same bits."""
  import torch
  from vision4leg_torch.ops import physics_kernel as pk
  bits = lambda x: x.contiguous().view(
      torch.int64 if x.dtype == torch.float64 else torch.int32)
  pa, pb = pk._per_env(*a), pk._per_env(*b)
  return all(torch.equal(bits(pa[k]), bits(pb[k])) for k in pa)


def time_window(name, args, card, counts, hybrid=False):
  """The window on `args` (1024 envs) and on its first 8 envs: kernel
  alone and whole wrapper call, two turns each, the plain version once,
  and the bound of `ops/window_cost.py`; logged and returned for the
  kernels line."""
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.ops import window_cost
  ms = {}
  for n_env in (NUM_ENVS, 8):
    a = take_envs(args, n_env)
    before = pk.robot_window.launches
    ms[n_env] = dict(
        kernel=[window_kernel_ms(a) for _ in range(2)],
        wrapper=[time_ms(lambda: pk.robot_window(*a)) for _ in range(2)])
    pk.robot_window.launches = before
  p_ms = time_ms(lambda: pk.window_plain(*args), n=20)
  nbytes, ops = window_cost.window_bytes_and_ops(
      args[0], args[4], args[5], args[8], False, counts, hybrid=hybrid)
  t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
  bound_ms = max(t_bytes, t_ops)
  fmt = lambda v: " / ".join(f"{t:.4f}" for t in v)
  log(f"{name} physics_window on {card}, {args[8]} substeps: at "
      f"{NUM_ENVS} envs kernel alone {fmt(ms[NUM_ENVS]['kernel'])} ms, "
      f"wrapper call {fmt(ms[NUM_ENVS]['wrapper'])} ms; at 8 envs kernel "
      f"alone {fmt(ms[8]['kernel'])} ms, wrapper call "
      f"{fmt(ms[8]['wrapper'])} ms (25 back-to-back calls, two turns); "
      f"plain {p_ms:.3f} ms (20 calls, {NUM_ENVS} envs); bound "
      f"{bound_ms * 1e3:.3f} us ({nbytes} bytes -> {t_bytes * 1e3:.3f} us, "
      f"{ops} f32 ops -> {t_ops * 1e3:.3f} us)")
  return dict(ms=ms[NUM_ENVS]["kernel"][0], plain_ms=p_ms, bound_ms=bound_ms,
              bound_by="operations" if t_ops >= t_bytes else "bytes",
              library_ms=None), ms


# the mangled template arguments of the forward's T <= 32 instantiation
# (csrc TL_ATTN_SMALL = 2, 4)
SMALL_INSTANTIATION = "ILi2ELi4EE"
# tolerances of tests/test_pallas.py for the JAX fused layer
LAYER_FWD_TOL = dict(atol=2e-5, rtol=1e-4)
LAYER_GRAD_TOL = dict(atol=3e-5, rtol=1e-4)
# rollout/update minibatch, ragged, eval, and a minibatch of 512 samples
# (the MPC config's batch_size where it has <= 512 envs)
LAYER_BATCHES = (1024, 1000, 8, 512)
EVAL_BATCH = 8                    # the eval's envs (common.num_eval_envs)
# the vision-only model's 16 tokens (no proprio token)
VISION_BATCHES = (1024, 512, 8)
# (B, T) of the layer's timings beside the main shape (1024, 17)
TIMED_SHAPES = ((512, 17), (1024, 16), (512, 16), (8, 16))
TRAIN_EPOCHS = 2
EVAL_HORIZON = 32
MPC_EPOCHS, VISION_EPOCHS = 2, 1
# an MPC env step is host-bound at ~0.25-0.5 s on the card: eval cut to
# 4 steps of its 8 envs
MPC_EVAL_HORIZON = 4
VISION_CONFIG = "config/mpc_vision_only/locotransformer/thin-goal.json"
# the float32 ReLU-kink band of tests/test_torch_ppo.py: two float32
# updates that put one pre-activation on opposite sides of a kink part by
# up to 1.5e-4 in the parameters after four minibatches
FUSED_UPDATE_BAND = 1.5e-4


def _close(got, ref, atol, rtol):
  """(largest |got - ref|, whether |got - ref| <= atol + rtol |ref|
  everywhere)."""
  import torch
  d = (got - ref).abs()
  return float(d.max()), bool(torch.all(d <= atol + rtol * ref.abs()))


def check_layer_case(name, x, w, gen):
  """The forward kernel against `layer_math` on x (B, T, D), its saving
  mode's bits, the backward kernel's rows and the end-to-end gradients
  (`compare_grads_with_plain`); logged with the ReLU mask flips and the
  forward's samples a tile.  Returns the forward's and the backward
  rows' largest errors; raises on a disagreement."""
  import torch
  from vision4leg_torch.ops import attention as att
  B, T, D = x.shape
  with torch.no_grad():
    got = att.fused_transformer_layer(x, w)
    ref = att.layer_math(x, w)
    saved, res = att.fused_layer_forward_saved(x, w)
  torch.cuda.synchronize()
  err, ok = _close(got, ref, **LAYER_FWD_TOL)
  if not torch.equal(saved, got):
    raise AssertionError(f"the saving forward's output differs from the "
                         f"inference forward's on {name} at B={B}")
  g = torch.randn(x.shape, generator=gen, device=x.device)
  # what the backward kernel writes against its plain version on the
  # residuals the forward kernel wrote (the same ReLU mask on both sides):
  # every row gradient and per-sample column sum
  b_err, b_ok = 0.0, True
  for a, b in zip(att.fused_layer_backward_rows(res, g, w),
                  att.layer_backward_rows(res, g, w)):
    e, o = _close(a, b, **LAYER_GRAD_TOL)
    b_err, b_ok = max(b_err, e), b_ok and o
  # end to end: gradients of a weighted sum through both kernels against
  # autograd of the plain version (module docstring)
  g_ok, rep = att.compare_grads_with_plain(x, w, g)
  g_err = max(r["max_abs_err"] for r in rep.values())
  excused = {k: r["excused"] for k, r in rep.items() if r["excused"]}
  spread = max(r["f32_spread"] for r in rep.values())
  # ReLU kinks: FFN pre-activations on the other side of zero in the
  # kernel's forward than in the plain one
  with torch.no_grad():
    _, res_p = att.layer_forward_saved(x, w)
    h_pre = res_p.y.reshape(-1, w.w1.shape[0]) @ w.w1 + w.b1
  flips = (res.h.reshape(h_pre.shape) > 0) != (h_pre > 0)
  G = att.tile_samples(B, T, D, w.w1.shape[1])
  log(f"transformer_layer vs plain [{name}, B={B} T={T}, {G} samples a "
      f"tile]: forward max abs "
      f"err {err:.3e} (saving mode: the same bits); backward kernel vs "
      f"layer_backward_rows on the same residuals: max abs err "
      f"{b_err:.3e}; end to end vs autograd of layer_math (x and 16 "
      f"weights): max abs err {g_err:.3e}, largest plain float32 "
      f"spread {spread:.3e}, elements within twice the spread only "
      f"{excused or 0}, decided by the kernel's ReLU mask "
      f"{sum(r['mask_excused'] for r in rep.values())}, failed "
      f"{sum(r['failed'] for r in rep.values())}"
      f"; ReLU mask flips kernel vs plain forward "
      f"{int(flips.sum())} at plain pre-activations "
      f"{[f'{v:.2e}' for v in h_pre[flips].tolist()]}")
  if not (ok and b_ok and g_ok):
    raise AssertionError(f"transformer_layer disagrees with plain on "
                         f"{name} at B={B} T={T}: {rep}")
  return err, b_err


def library_layer(w):
  """torch.nn.TransformerEncoderLayer (the yardstick, never called by the
  port) with the weights `w`, in eval mode, on w's device."""
  import torch
  D, F = w.w1.shape
  lib = torch.nn.TransformerEncoderLayer(
      D, 1, F, dropout=0.0, layer_norm_eps=1e-6, batch_first=True).to(
          w.w1.device)
  lib.eval()
  with torch.no_grad():
    lib.self_attn.in_proj_weight.copy_(torch.cat([w.wq.t(), w.wk.t(),
                                                  w.wv.t()]))
    lib.self_attn.in_proj_bias.copy_(torch.cat([w.bq, w.bk, w.bv]))
    lib.self_attn.out_proj.weight.copy_(w.wo.t())
    lib.self_attn.out_proj.bias.copy_(w.bo)
    lib.linear1.weight.copy_(w.w1.t())
    lib.linear1.bias.copy_(w.b1)
    lib.linear2.weight.copy_(w.w2.t())
    lib.linear2.bias.copy_(w.b2)
    lib.norm1.weight.copy_(w.ln1_scale)
    lib.norm1.bias.copy_(w.ln1_bias)
    lib.norm2.weight.copy_(w.ln2_scale)
    lib.norm2.bias.copy_(w.ln2_bias)
  return lib


def phase_layer(net, vision_net, obs, card):
  """The fused-layer kernels against their plain versions on the main
  path's inputs: the LocoTransformer's 17 tokens and the vision-only
  model's 16 of the same observations; returns their numbers for the
  kernels line."""
  import torch
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import nvcc
  dev = obs.device
  with torch.no_grad():
    tokens = net._tokens(obs)                        # (1024, 17, 64)
    w0 = att.LayerWeights(*[t.detach() for t in
                            att.weights_from_layer(net.pf_layers[0])])
    w1 = att.LayerWeights(*[t.detach() for t in
                            att.weights_from_layer(net.pf_layers[1])])
    second = att.layer_math(tokens, w0)              # input of layer 2
  gen = torch.Generator(device=dev).manual_seed(3)
  noise = torch.randn(tokens.shape, generator=gen, device=dev)
  cases = {"tokens->pf_layers.0": (tokens, w0),
           "layer-1 out->pf_layers.1": (second, w1),
           "randn->pf_layers.0": (noise, w0)}
  max_err, bwd_err = 0.0, 0.0
  for name, (x_all, w) in cases.items():
    for B in LAYER_BATCHES:
      err, b_err = check_layer_case(name, x_all[:B].contiguous(), w, gen)
      max_err, bwd_err = max(max_err, err), max(bwd_err, b_err)
  # T = 16: the vision-only model's tokens of the same observations
  with torch.no_grad():
    v_tokens = vision_net._tokens(obs)                 # (1024, 16, 64)
    v0 = att.LayerWeights(*[t.detach() for t in
                            att.weights_from_layer(vision_net.pf_layers[0])])
    v1 = att.LayerWeights(*[t.detach() for t in
                            att.weights_from_layer(vision_net.pf_layers[1])])
    v_second = att.layer_math(v_tokens, v0)
  v_noise = torch.randn(v_tokens.shape, generator=gen, device=dev)
  for name, (x_all, w) in {
      "vision tokens->pf_layers.0": (v_tokens, v0),
      "vision layer-1 out->pf_layers.1": (v_second, v1),
      "randn T=16->pf_layers.0": (v_noise, v0)}.items():
    for B in VISION_BATCHES:
      err, b_err = check_layer_case(name, x_all[:B].contiguous(), w, gen)
      max_err, bwd_err = max(max_err, err), max(bwd_err, b_err)

  # two backward calls on the same inputs give the same bits
  x = tokens.clone().requires_grad_(True)
  w = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w0])
  g = torch.randn(tokens.shape, generator=gen, device=dev)
  runs = [torch.autograd.grad(att.fused_transformer_layer_ad(x, w), [x, *w],
                              g) for _ in range(2)]
  if not all(torch.equal(a, b) for a, b in zip(*runs)):
    raise AssertionError("two backward calls gave different gradients")
  log(f"fused_transformer_layer_ad at B={tokens.shape[0]}: two calls give "
      f"bit-identical gradients (x and 16 weights)")
  ptx = nvcc.ptxas_counts(nvcc.INFO["transformer_layer"]["log"])
  log(f"transformer_layer_bwd ptxas: {json.dumps({k: v for k, v in ptx.items() if 'bwd' in k})}")
  # the forward's two instantiations: their registers and spills, and
  # their tensor-core (HMMA) instructions, which show that their products
  # run on tensor cores; the small one (T <= 32, every path but the
  # 16-channel model's) must not spill
  fwd_ptx = {k: v for k, v in ptx.items() if "bwd" not in k}
  hmma = {k: v for k, v in nvcc.sass_counts("transformer_layer",
                                             "HMMA").items()
          if "bwd" not in k}
  log(f"transformer_layer (forward) ptxas: {json.dumps(fwd_ptx)}; HMMA "
      f"instructions in their SASS: {hmma}")
  small = [k for k in fwd_ptx if SMALL_INSTANTIATION in k]
  if len(small) != 1 or not all(hmma.values()) or \
     fwd_ptx[small[0]]["spill_store_bytes"] or \
     fwd_ptx[small[0]]["spill_load_bytes"]:
    raise AssertionError("the forward kernel's T <= 32 instantiation "
                         "spills, or an instantiation has no tensor-core "
                         "instructions")

  # torch's own layer (eval, no_grad: its fused native path), same weights
  D, F = tokens.shape[-1], w0.w1.shape[1]
  lib = library_layer(w0)
  with torch.no_grad():
    lib_err, lib_ok = _close(lib(tokens), att.layer_math(tokens, w0),
                             **LAYER_FWD_TOL)
  log(f"torch.nn.TransformerEncoderLayer (yardstick) vs plain at "
      f"B={tokens.shape[0]}: max abs err {lib_err:.3e}")
  if not lib_ok:
    raise AssertionError("the library layer disagrees with the plain one")

  before = (att.fused_transformer_layer.launches,
            att.fused_transformer_layer_bwd.launches)
  eval_x = tokens[:EVAL_BATCH].contiguous()
  with torch.no_grad():
    k_ms = time_ms(lambda: att.fused_transformer_layer(tokens, w0))
    p_ms = time_ms(lambda: att.layer_math(tokens, w0), n=20)
    l_ms = time_ms(lambda: lib(tokens), n=20)
    k_ms2 = time_ms(lambda: att.fused_transformer_layer(tokens, w0))
    k8_ms = time_ms(lambda: att.fused_transformer_layer(eval_x, w0))
  # forward + backward, as the PPO update runs it (row 2ad)
  xi = tokens.clone().requires_grad_(True)
  wi = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w0])
  g = torch.randn(tokens.shape, generator=gen, device=dev)
  inputs = [xi, *wi]
  ad_ms = time_ms(lambda: torch.autograd.grad(
      att.fused_transformer_layer_ad(xi, wi), inputs, g), n=20)
  plain_ad_ms = time_ms(lambda: torch.autograd.grad(
      att.layer_math(xi, wi), inputs, g), n=20)
  lib.train()                  # dropout 0: the same function, autograd
  lib_ad_ms = time_ms(lambda: torch.autograd.grad(
      lib(xi), [xi, *lib.parameters()], g), n=20)
  ad_ms2 = time_ms(lambda: torch.autograd.grad(
      att.fused_transformer_layer_ad(xi, wi), inputs, g), n=20)
  # its parts: the saving forward, and the backward (kernel, weight
  # products and sums) on one forward's residuals
  with torch.no_grad():
    save_ms = time_ms(lambda: att.fused_layer_forward_saved(tokens, w0))
    _, res = att.fused_layer_forward_saved(tokens, w0)
    bwd_ms = time_ms(lambda: att.fused_transformer_layer_bwd(res, g, w0))
    bwd_k_ms = time_ms(lambda: att.fused_layer_backward_rows(res, g, w0))
    bwd_plain_ms = time_ms(lambda: att.layer_backward_math(res, g, w0),
                           n=20)
  del res
  # the other shapes of the paths: each kernel, its plain version and the
  # library layer, forward and forward + backward
  shapes = {}
  for B_, T_ in TIMED_SHAPES:
    x_, w_ = ((tokens, w0) if T_ == tokens.shape[1] else (v_tokens, v0))
    shapes[f"{B_}x{T_}"] = time_layer_shape(x_[:B_].contiguous(), w_, lib,
                                            gen, card)
  att.fused_transformer_layer.launches, \
      att.fused_transformer_layer_bwd.launches = before
  B, T, D = tokens.shape
  nbytes, flops = att.layer_cost(B, T, D, F)
  # the products run in 3xTF32 on the tensor cores: three TF32
  # products for each float32 one at the dense TF32 peak; the same FLOPs
  # on the CUDA cores' float32 peak is the bound of earlier kernels
  t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
  t_tc = 3 * flops / 495e12 * 1e3
  bound_ms, fp32_bound_ms = max(t_bytes, t_tc), max(t_bytes, t_ops)
  s_bytes, _ = att.layer_saved_cost(B, T, D, F)
  save_bound_ms = max(s_bytes / 3.35e12 * 1e3, t_tc)
  tiles = {b: att.tile_samples(b, T, D, F) for b in LAYER_BATCHES}
  log(f"transformer_layer at B={B} T={T} D={D} F={F} on {card}: kernel "
      f"{k_ms:.4f} ms / {k_ms2:.4f} ms (25 back-to-back calls, two turns), "
      f"at B={EVAL_BATCH} {k8_ms:.4f} ms, plain {p_ms:.4f} ms, "
      f"torch.nn.TransformerEncoderLayer {l_ms:.4f} ms (20 calls each); "
      f"bound {bound_ms * 1e3:.3f} us in 3xTF32 ({nbytes} bytes -> "
      f"{t_bytes * 1e3:.3f} us, 3 x {flops} TF32 FLOP -> "
      f"{t_tc * 1e3:.3f} us), {fp32_bound_ms * 1e3:.3f} us for the same "
      f"FLOPs on the float32 CUDA cores ({t_ops * 1e3:.3f} us); samples a "
      f"tile by B: {tiles}")
  g_bytes, g_flops = att.layer_grad_cost(B, T, D, F)
  gt_bytes, gt_ops = g_bytes / 3.35e12 * 1e3, g_flops / 67e12 * 1e3
  g_bound = max(gt_bytes, gt_ops)
  log(f"fused_transformer_layer_ad forward + backward at B={B} on {card}: "
      f"{ad_ms:.4f} ms / {ad_ms2:.4f} ms (saving forward kernel + backward "
      f"kernel + weight products, two turns), plain autograd "
      f"{plain_ad_ms:.4f} ms, torch.nn.TransformerEncoderLayer autograd "
      f"{lib_ad_ms:.4f} ms (20 calls each); bound {g_bound * 1e3:.3f} us "
      f"({g_bytes} bytes -> {gt_bytes * 1e3:.3f} us, {g_flops} f32 FLOP -> "
      f"{gt_ops * 1e3:.3f} us); parts: saving forward {save_ms:.4f} ms "
      f"(bound {save_bound_ms * 1e3:.3f} us: {s_bytes} bytes with the "
      f"residuals), "
      f"backward {bwd_ms:.4f} ms (of which the backward kernel with its "
      f"weight transposes {bwd_k_ms:.4f} ms; the plain version "
      f"layer_backward_math {bwd_plain_ms:.4f} ms)")
  fwd = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
             bound_by="operations" if t_tc >= t_bytes else "bytes",
             library_ms=l_ms)
  bwd = dict(max_abs_err=bwd_err, ms=ad_ms, plain_ms=plain_ad_ms,
             bound_ms=g_bound,
             bound_by="operations" if gt_ops >= gt_bytes else "bytes",
             library_ms=lib_ad_ms)
  extra = dict(eval_batch_ms=k8_ms, fp32_bound_ms=fp32_bound_ms,
               saving_forward_ms=save_ms, saving_forward_bound_ms=save_bound_ms,
               tile_samples=tiles, forward_hmma_instructions=hmma,
               forward_ptxas=fwd_ptx, shapes=shapes)
  return fwd, bwd, extra


def time_layer_shape(x, w, lib, gen, card):
  """At x's (B, T): the forward kernel, `layer_math` and the library
  layer `lib` (its own weights; the time does not depend on them), and
  forward + backward under autograd of the three, timed with CUDA events;
  the bounds of `attention.layer_cost` (3xTF32) and `layer_grad_cost`.
  Logged and returned."""
  import torch
  from vision4leg_torch.ops import attention as att
  B, T, D = x.shape
  F = w.w1.shape[1]
  lib.eval()
  with torch.no_grad():
    k_ms = time_ms(lambda: att.fused_transformer_layer(x, w))
    p_ms = time_ms(lambda: att.layer_math(x, w), n=20)
    l_ms = time_ms(lambda: lib(x), n=20)
  xi = x.clone().requires_grad_(True)
  wi = att.LayerWeights(*[t.clone().requires_grad_(True) for t in w])
  g = torch.randn(x.shape, generator=gen, device=x.device)
  inputs = [xi, *wi]
  ad_ms = time_ms(lambda: torch.autograd.grad(
      att.fused_transformer_layer_ad(xi, wi), inputs, g), n=20)
  plain_ad_ms = time_ms(lambda: torch.autograd.grad(
      att.layer_math(xi, wi), inputs, g), n=20)
  lib.train()
  lib_ad_ms = time_ms(lambda: torch.autograd.grad(
      lib(xi), [xi, *lib.parameters()], g), n=20)
  lib.eval()
  nbytes, flops = att.layer_cost(B, T, D, F)
  bound = max(nbytes / 3.35e12, 3 * flops / 495e12) * 1e3
  g_bytes, g_flops = att.layer_grad_cost(B, T, D, F)
  g_bound = max(g_bytes / 3.35e12, g_flops / 67e12) * 1e3
  G = att.tile_samples(B, T, D, F)
  log(f"transformer_layer at B={B} T={T} on {card} ({G} samples a tile): "
      f"forward kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
      f"torch.nn.TransformerEncoderLayer {l_ms:.4f} ms, bound "
      f"{bound * 1e3:.3f} us (3xTF32); forward + backward "
      f"(fused_transformer_layer_ad) {ad_ms:.4f} ms, plain autograd "
      f"{plain_ad_ms:.4f} ms, library autograd {lib_ad_ms:.4f} ms, bound "
      f"{g_bound * 1e3:.3f} us")
  return dict(tile_samples=G, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
              bound_ms=bound, ad_ms=ad_ms, plain_ad_ms=plain_ad_ms,
              library_ad_ms=lib_ad_ms, ad_bound_ms=g_bound)


def phase_training(label, env, meta, params, build_module, epochs,
                   eval_horizon, card, fused=True, check=None, eval_env=None):
  """`epochs` PPO epochs of `params`' config through the port's starter
  pieces (`build_module` of a starter), fused layer on in collection and
  update (off with fused=False: the Nature-CNN models have no layer), an
  eval of eval_horizon steps after each; the launch counts set to 0 just
  before and read just after, held to the path's exact counts; metrics
  finite, parameters changed, the checkpoint restored into a second agent
  equal to the first.  `eval_env` evaluates on another env (sim2sim).  On
  the MPC env the window runs policy_freq hybrid
  launches a step, and each reset (the rollout's partial resets, the
  eval's) one settle launch, counted apart.  The updates' layer kernels
  are counted from a device trace (`UpdateKernels`: on one card the
  update replays its minibatch step as a CUDA graph, whose kernels no
  wrapper call launches).  `check(agent)` runs after the counts are read.
  Returns the launch counts, each epoch's numbers and what `check`
  returned (`checked`)."""
  import csv

  import torch
  from vision4leg_torch.algo.agent import PPOAgent, _flatten
  from vision4leg_torch.algo.on_policy_base import minibatches
  from vision4leg_torch.envs.mpc_env import A1MPCGymEnv
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import common
  from vision4leg_torch.utils.logger import Logger
  cfg = common.ppo_config(params, num_epochs=epochs)
  n_eval = common.num_eval_envs(params)
  mpc = isinstance(env, A1MPCGymEnv)

  def agent(seed, logger):
    return PPOAgent(
        env=env, ac_module=build_module(env, params), cfg=cfg,
        num_envs=NUM_ENVS, seed=seed, logger=logger,
        save_dir=os.path.join(logger.work_dir, "model"), eval_interval=1,
        save_interval=epochs, num_eval_envs=n_eval,
        obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"],
        reward_scale=meta["reward_scale"], fused_attention=fused,
        fused_update=fused, eval_env=eval_env, eval_horizon=eval_horizon,
        device=env.device)

  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
    logger = Logger("chip_smoke", params["env_name"], 0, params, tmp)
    t = time.perf_counter()
    a = agent(0, logger)
    torch.cuda.synchronize()
    log(f"[{label}] PPOAgent at {NUM_ENVS} envs (init + init_collector): "
        f"{time.perf_counter() - t:.2f}s")
    init = {k: v.clone() for k, v in a.module.state_dict().items()}
    settles = env.settle_windows if mpc else 0
    pk.robot_window.launches = 0
    att.fused_transformer_layer.launches = 0
    att.fused_transformer_layer_bwd.launches = 0
    t = time.perf_counter()
    with UpdateKernels() as updates:
      a.train()
      torch.cuda.synchronize()
    dt = time.perf_counter() - t
    settles = (env.settle_windows - settles) if mpc else 0
    layer, layer_bwd = updates.launches(layer_wrapper_counts())
    launches = {"physics_window": pk.robot_window.launches - settles,
                "physics_window_settle": settles,
                "transformer_layer": layer,
                "transformer_layer_bwd": layer_bwd}
    horizon = a.horizon
    rows, n_batches = minibatches(cfg, horizon, NUM_ENVS)
    n_mb, mb = cfg.opt_epochs * n_batches, rows * NUM_ENVS
    per_step = env.cfg.policy_freq if mpc else int(env.kernel_capable)
    per_epoch_layer = (4 * horizon + 2 + 4 * n_mb) + 2 * eval_horizon
    want = {"physics_window": epochs * (horizon + eval_horizon) * per_step,
            "physics_window_settle": settles,
            "transformer_layer": epochs * per_epoch_layer * fused,
            "transformer_layer_bwd": epochs * 4 * n_mb * fused}
    log(f"[{label}] trained {epochs} epochs in {dt:.2f}s; launches "
        f"{launches}, expected {want} (per epoch: window ({horizon} + "
        f"{eval_horizon} eval) steps x {per_step}"
        + (f" hybrid, the settles of the rollout's partial resets and the "
           f"eval's reset counted apart" if mpc else "")
        + (f"; layer 4 x {horizon} pi_v + 2 last value + 4 x {n_mb} update "
           f"at B={mb} (saving mode), 2 x {eval_horizon} eval at "
           f"B={n_eval}; layer backward 4 x {n_mb} update at B={mb})"
           if fused else "; no fused layer)")
        + f"; the updates' layer kernels (forward, backward) "
          f"{tuple(updates.kernels)} from the device trace, their wrapper "
          f"calls {tuple(updates.calls)}")
    if launches != want or (mpc and settles < epochs):
      raise AssertionError(f"[{label}] launch counts {launches} != {want}")
    checked = check(a) if check is not None else None

    with open(logger.csv_file_path, newline="") as f:
      rows_ = list(csv.DictReader(f))
    if len(rows_) != epochs:
      raise AssertionError(f"[{label}] {len(rows_)} log rows")
    epoch_rows = []
    for r in rows_:
      vals = {k: float(v) for k, v in r.items() if v not in ("", None)}
      bad = [k for k, v in vals.items() if not math.isfinite(v)]
      if bad or vals["diagnostics/nonfinite_obs"] != 0:
        raise AssertionError(f"[{label}] non-finite metrics {bad}")
      for k in ("Training/policy_loss", "Training/vf_loss",
                "Eval_Rewards_Average"):
        if k not in vals:
          raise AssertionError(f"[{label}] {k} missing from the log")
      if env.cfg.proprio_dim == 0 and \
         vals["diagnostics/obs_norm_var_max"] != 0:
        raise AssertionError(f"[{label}] obs_norm_var_max on a zero-size "
                             "normalizer is not 0")
      rate = cfg.epoch_frames / vals["Train___Time"]
      epoch_rows.append(dict(
          epoch=int(vals["EPOCH"]), collect_s=vals["Explore_Time"],
          update_s=vals["Update_Time"], eval_s=vals["Eval____Time"],
          env_steps_per_s=rate, vf_loss=vals["Training/vf_loss"],
          policy_loss=vals["Training/policy_loss"],
          eval_return=vals["Eval_Rewards_Average"],
          obs_norm_var_max=vals["diagnostics/obs_norm_var_max"]))
      log(f"[{label}] epoch {epoch_rows[-1]['epoch']} on {card}: "
          f"collection {vals['Explore_Time']:.3f}s, update ({n_mb} "
          f"minibatches of {mb}) {vals['Update_Time']:.3f}s, eval "
          f"({eval_horizon} steps x {n_eval} envs) "
          f"{vals['Eval____Time']:.3f}s; {cfg.epoch_frames} env-steps / "
          f"{vals['Train___Time']:.3f}s (collection + update) = "
          f"{rate:.1f} env-steps/s; vf_loss {vals['Training/vf_loss']:.4f}"
          f", policy_loss {vals['Training/policy_loss']:.5f}, eval return "
          f"{vals['Eval_Rewards_Average']:.3f}, obs_norm_var_max "
          f"{vals['diagnostics/obs_norm_var_max']:.4g}")
    changed = sum(not torch.equal(v, init[k])
                  for k, v in a.module.state_dict().items())
    if changed != len(init):
      raise AssertionError(f"[{label}] only {changed} of {len(init)} "
                           "parameter tensors changed")

    # the checkpoint after the last epoch, restored into a second agent
    b = agent(1, logger)
    if b.restore_checkpoint() != epochs:
      raise AssertionError("restore_checkpoint returned another epoch")

    def state(x):
      ts = x.train_state
      out = {f"module.{k}": v for k, v in x.module.state_dict().items()}
      for side in ("pf_opt", "vf_opt"):
        st = getattr(ts, side)
        out.update({f"{side}.mu.{i}": m for i, m in enumerate(st.mu)})
        out.update({f"{side}.nu.{i}": n for i, n in enumerate(st.nu)})
      out.update(_flatten(x.collector_state, "cs", {}))
      return out, (ts.pf_opt.count, ts.vf_opt.count, ts.epoch)

    (sa, ca), (sb, cb) = state(a), state(b)
    diff = [k for k in sa if not torch.equal(sa[k], sb[k])]
    if diff or ca != cb or set(sa) != set(sb):
      raise AssertionError(f"[{label}] restored state differs: {diff[:5]} "
                           f"{ca} {cb}")
    size = os.path.getsize(os.path.join(a.save_dir, "checkpoint"))
    log(f"[{label}] checkpoint ({size / 2 ** 20:.1f} MiB at {NUM_ENVS} "
        f"envs) restored into a second agent: {len(sa)} tensors (params, "
        f"both Adam states, collector with the env states) equal; counts "
        f"{cb}")
  launches["epochs"] = epoch_rows
  launches["minibatch"] = mb
  launches["checkpoint_mib"] = size / 2 ** 20
  launches["checked"] = checked
  return launches


def fused_update_check(net, obs, params, seed=0):
  """Four PPO minibatches of B samples, the rows of obs (4, B, D), with
  the fused layer in the update (the forward and backward kernels on the
  card) and without it, from the same module state and trajectory: the
  actions drawn from the policy, behaviour log-probs moved off it so that
  the ratio clips, seeded rewards; PPO settings of `params`' config with
  batch_size B, one opt epoch, rows in order.  Returns (largest |fused -
  unfused| over the parameters, largest parameter movement of the
  unfused update, the update metrics' largest difference)."""
  import copy
  import dataclasses

  import torch
  from vision4leg_torch.algo.on_policy_base import normal_log_prob
  from vision4leg_torch.algo.ppo import PPOLearner
  from vision4leg_torch.collector.rollout import Transition
  from vision4leg_torch.starter import common
  T, B = obs.shape[:2]
  dev = obs.device
  cfg = dataclasses.replace(common.ppo_config(params), batch_size=B,
                            epoch_frames=T * B, opt_epochs=1, shuffle=False)
  gen = torch.Generator(device=dev).manual_seed(seed)
  rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
  with torch.no_grad():
    (mean, std, _), value = net.pi_v(obs.reshape(T * B, -1))
  acts = mean + std * rnd(*mean.shape)
  logp = normal_log_prob(mean, std, acts) + 0.3 * (
      2 * torch.rand(T * B, 1, generator=gen, device=dev) - 1)
  split = lambda t: t.reshape(T, B, -1)
  no = torch.zeros(T, B, 1, dtype=torch.bool, device=dev)
  traj = Transition(obs=obs, acts=split(acts), log_probs=split(logp),
                    values=split(value), rewards=0.1 * rnd(T, B, 1),
                    terminals=no, time_limits=no, means=split(mean),
                    stds=split(std))
  out = {}
  for fused in (False, True):
    m = copy.deepcopy(net).train()
    learner = PPOLearner(cfg, lambda mm, x, f=fused: mm.pi(x, fused=f),
                         lambda mm, x, f=fused: mm.v(x, fused=f), m)
    _, metrics = learner.update_per_epoch(
        learner.init_state(m), traj, torch.zeros(B, device=dev),
        perms=[list(range(T))])
    out[fused] = ({k: v.detach() for k, v in m.state_dict().items()},
                  {k: float(v) for k, v in metrics.items()})
  init = net.state_dict()
  diff = max(float((out[True][0][k] - v).abs().max())
             for k, v in out[False][0].items())
  moved = max(float((v - init[k]).abs().max())
              for k, v in out[False][0].items())
  m_diff = max(abs(out[True][1][k] - v) for k, v in out[False][1].items())
  return diff, moved, m_diff


def phase_fused_update(label, net, obs, params, card):
  """`fused_update_check` on the card, held to FUSED_UPDATE_BAND, its
  backward kernels counted from a device trace; the launches it makes are
  comparisons and leave the counts as they were."""
  from vision4leg_torch.ops import attention as att
  before = layer_wrapper_counts()
  t = time.perf_counter()
  (diff, moved, m_diff), (_, bwd) = layer_kernels(
      lambda: fused_update_check(net, obs, params))
  att.fused_transformer_layer.launches, \
      att.fused_transformer_layer_bwd.launches = before
  T, B = obs.shape[:2]
  log(f"[{label}] fused PPO update vs unfused on {card}: {T} minibatches "
      f"of B={B}, from one state; largest parameter difference "
      f"{diff:.3e} (band {FUSED_UPDATE_BAND:g}; the unfused update moved "
      f"the parameters by up to {moved:.3e}); largest metric difference "
      f"{m_diff:.3e}; {bwd} backward kernels (device trace); "
      f"{time.perf_counter() - t:.2f}s")
  if bwd != 4 * T:
    raise AssertionError(f"[{label}] the fused update launched the layer "
                         f"backward {bwd} times, expected {4 * T}")
  if not diff <= FUSED_UPDATE_BAND:
    raise AssertionError(f"[{label}] fused update parts from the unfused "
                         f"one by {diff:.3e} > {FUSED_UPDATE_BAND:g}")
  return dict(batch=B, max_param_diff=diff, max_param_move=moved,
              max_metric_diff=m_diff)


def log_window_report(name, args, rep, counts):
  """One line per field of a compare_with_plain report."""
  n = {k: int(v.sum()) for k, v in counts.items()}
  q, mdl = args[1].phys.joint_q, args[0]
  past = int(((q < mdl.joint_lower) | (q > mdl.joint_upper)).any(-1).sum())
  log(f"physics_window vs plain [{name}, {q.shape[0]} envs, {past} with a "
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


def phase_tf32(net, obs):
  """pi_v under torch's default TF32 settings (matmul off, cuDNN
  convolutions on: what the starter runs) against pi_v with TF32 off, on
  the same observations."""
  import torch
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  out = {}
  try:
    for name, cudnn in (("off", False), ("default", True)):
      torch.backends.cuda.matmul.allow_tf32 = False
      torch.backends.cudnn.allow_tf32 = cudnn
      with torch.no_grad():
        (mean, _, _), value = net.pi_v(obs)
      out[name] = (mean, value)
  finally:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = flags
  errs = {}
  for i, k in enumerate(("mean", "value")):
    errs[k] = _close(out["default"][i], out["off"][i], **TF32_TOL)
  log(f"pi_v with torch's default TF32 (cuDNN convolutions TF32, matmul "
      f"float32) vs TF32 off on {obs.shape[0]} observations: max abs diff "
      f"mean {errs['mean'][0]:.3e}, value {errs['value'][0]:.3e}; "
      f"tolerance atol {TF32_TOL['atol']:g} + rtol {TF32_TOL['rtol']:g}")
  if not all(ok for _, ok in errs.values()):
    raise AssertionError(f"TF32 pi_v outside {TF32_TOL}: {errs}")
  return {k: e for k, (e, _) in errs.items()}


def hybrid_contact_case(mpc_env, tmpl, tick):
  """`contact_case` on the MPC model, around the envs of the MPC tick
  inputs `tick`, with its dynamics and substeps, random feedforward
  torques and random per-leg stance masks that mix stance and swing legs
  in every env (hybrid mode)."""
  import torch
  dev, n = mpc_env.device, tick[2].shape[0]
  g = torch.Generator().manual_seed(9)
  xy = tick[1].phys.pos[:, :2]
  cmd = tmpl.phys.joint_q + 0.3 * (
      torch.rand(n, 12, generator=g) - 0.5).to(dev)
  legs = (torch.rand(n, 4, generator=g) < 0.5).to(dev)
  legs[:, 0], legs[:, 1] = True, False
  tau_ff = (20.0 * (torch.rand(n, 12, generator=g) - 0.5)).to(dev)
  return contact_case(mpc_env.model, tmpl, xy, cmd, tick[3], tick[8]) + (
      False, tau_ff, torch.repeat_interleave(legs.float(), 3, dim=-1))


def check_repeatable(name, args):
  """Two kernel calls on the same inputs give the same bits, float32 and
  float64 (the launch count is left as it was)."""
  from vision4leg_torch.ops import physics_kernel as pk
  before = pk.robot_window.launches
  for a in (args, tuple(pk._double(x) for x in args)):
    if not same_bits(pk.robot_window(*a), pk.robot_window(*a)):
      raise AssertionError(f"two physics_window calls on {name} gave "
                           f"different bits")
  pk.robot_window.launches = before
  log(f"physics_window [{name}]: two calls gave the same bits, float32 "
      f"and float64")


def phase_hybrid(mpc_env, thin_env, card):
  """The window kernel's hybrid mode against its plain version at the MPC
  env's shapes; returns its numbers for the kernels line and its times."""
  import torch
  from vision4leg_torch.ops import physics_kernel as pk
  dev = mpc_env.device
  gen = torch.Generator(device=dev).manual_seed(5)
  t = time.perf_counter()
  states, _ = mpc_env.reset(NUM_ENVS, gen)
  torch.cuda.synchronize()
  log(f"MPC env reset at {NUM_ENVS} envs (one settle launch of "
      f"{mpc_env.cfg.settle_steps * mpc_env.cfg.substeps} substeps): "
      f"{time.perf_counter() - t:.2f}s")
  low, high = mpc_env.action_low, mpc_env.action_high
  rand_act = lambda: low + (high - low) * torch.rand(
      NUM_ENVS, 2, generator=gen, device=dev)
  for _ in range(2):
    states, _, _, _, _ = mpc_env.step_batch(states, rand_act(), gen)
  cases = {"MPC tick": mpc_window_inputs(mpc_env, states, rand_act())}
  mask = cases["MPC tick"][-1]
  stance = mask.reshape(NUM_ENVS, 4, 3)[..., 0]
  log(f"MPC tick inputs: stance legs per env {stance.sum(-1).float().mean():.2f} "
      f"on average, envs mixing stance and swing "
      f"{int(((stance > 0).any(-1) & (stance == 0).any(-1)).sum())}")

  cases["contact"] = hybrid_contact_case(
      mpc_env, thin_env.settled_template(), cases["MPC tick"])

  max_err = 0.0
  for name, args in cases.items():
    counts = {}
    pk.window_plain(*args, counts=counts)
    ok, rep = pk.compare_with_plain(args)
    torch.cuda.synchronize()
    log_window_report(f"hybrid, {name}", args, rep, counts)
    if not ok:
      raise AssertionError(f"hybrid physics_window disagrees with plain on "
                           f"{name}")
    max_err = max(max_err, rep["max_abs_err"])

  args = cases["MPC tick"]
  check_repeatable("hybrid, MPC tick", args)
  counts = {}
  pk.window_plain(*args, counts=counts)
  numbers, ms = time_window("hybrid", args, card, counts, hybrid=True)
  return dict(max_abs_err=max_err, **numbers), ms


def phase_mpc_collection(card, dev):
  """One thin-goal MPC rollout at NUM_ENVS envs through the collector;
  returns (hybrid launches, env-steps/s, settle launches, the policy, the
  first 512 envs' observations of its first 4 steps, the config, the env
  and its states after the rollout)."""
  import torch
  from vision4leg_torch.collector import rollout as rollout_lib
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  env, meta, net, params = build_mpc_path(dev)
  horizon = params["collector"]["epoch_frames"] // NUM_ENVS
  rollout = make_rollout(env, meta, net, params)
  gen = torch.Generator(device=dev).manual_seed(0)
  t = time.perf_counter()
  cs = rollout_lib.init_collector(env, NUM_ENVS, gen)
  torch.cuda.synchronize()
  log(f"MPC init_collector at {NUM_ENVS} envs: "
      f"{time.perf_counter() - t:.2f}s")
  settles = env.settle_windows
  pk.robot_window.launches = 0
  att.fused_transformer_layer.launches = 0
  t = time.perf_counter()
  cs, traj, last_v = rollout(cs)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t
  settle_launches = env.settle_windows - settles
  hybrid = pk.robot_window.launches - settle_launches
  rate = horizon * NUM_ENVS / dt
  want = horizon * env.cfg.policy_freq
  log(f"MPC rollout: {horizon} steps x {NUM_ENVS} envs in {dt:.3f}s = "
      f"{rate:.1f} env-steps/s on {card} (first rollout of the process); "
      f"physics_window launches {pk.robot_window.launches}: {hybrid} hybrid "
      f"(expected {horizon} x {env.cfg.policy_freq} = {want}) + "
      f"{settle_launches} settles of partial resets; transformer_layer "
      f"launches {att.fused_transformer_layer.launches} (fused layer off)")
  if hybrid != want or att.fused_transformer_layer.launches != 0:
    raise AssertionError(f"MPC rollout launch counts: {hybrid} hybrid, "
                         f"expected {want}")
  for name in ("obs", "acts", "log_probs", "values", "rewards"):
    if not torch.isfinite(getattr(traj, name)).all():
      raise AssertionError(f"non-finite MPC {name}")
  if traj.obs.shape != (horizon, NUM_ENVS, env.obs_dim) or not \
      torch.isfinite(last_v).all():
    raise AssertionError(f"MPC obs shape {tuple(traj.obs.shape)}")
  log(f"MPC outputs finite; terminals {int(traj.terminals.sum())}; mean "
      f"reward {float(traj.rewards.mean()):.4f}")
  return (hybrid, rate, settle_launches, net, traj.obs[:4, :512].clone(),
          params, env, cs.env_states)


def phase_walk(card, dev):
  """The JAX package's MPC behaviour criterion on the card."""
  import torch
  from vision4leg_torch.envs.mpc_env import A1MPCGymEnv, MpcEnvConfig
  env = A1MPCGymEnv(MpcEnvConfig(
      motor_control_mode="POSITION", clip_num=(0.3, 0.4), time_step_s=0.001,
      num_action_repeat=5, policy_freq=20, terrain_type="plane",
      target_vel=0.3, check_contact=False, settle_steps=300,
      alive_reward=0.1), device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  state, _ = env.reset(WALK_ENVS, gen)
  x0 = state.robot.phys.pos[:, 0].clone()
  act = torch.tensor([[0.3, 0.0]], device=dev).expand(WALK_ENVS, 2)
  z_min = torch.full((WALK_ENVS,), float("inf"), device=dev)
  any_done = torch.zeros(WALK_ENVS, dtype=torch.bool, device=dev)
  t = time.perf_counter()
  for _ in range(WALK_STEPS):
    state, _, _, done, _ = env.step_batch(state, act, gen)
    z_min = torch.minimum(z_min, state.robot.phys.pos[:, 2])
    any_done |= done
  torch.cuda.synchronize()
  dx = state.robot.phys.pos[:, 0] - x0
  log(f"MPC walk on plane on {card}: {WALK_ENVS} envs x {WALK_STEPS} steps "
      f"of (0.3, 0) in {time.perf_counter() - t:.2f}s; done {int(any_done.sum())}, "
      f"base z min {float(z_min.min()):.4f} m, forward progress min "
      f"{float(dx.min()):.4f} / max {float(dx.max()):.4f} m")
  if any_done.any() or not bool((z_min > 0.15).all()) or not bool(
      (dx > 0.15).all()):
    raise AssertionError("the MPC controller did not walk forward on the "
                         "card")
  return float(dx.min())


MMDR_CONFIG = "config/rl/moving/locotransformer_random_delay/thin-goal.json"
NATURE_MOVING_CONFIG = \
    "config/rl/moving/frame_extract4_random_delay/thin-wide.json"
INTERP_CONFIG = "config/rl/static/frame_extract4_interpolation/thin-goal.json"
FIXED_DELAY_CONFIG = \
    "config/rl/static/frame_extract4_fixed_delay/thin-goal.json"
VISUAL_MPC_CONFIG = "config/mpc_vision_only/baseline/thin-goal.json"
MPC_BASELINE_HORIZON = 4
# envs of the moving case whose nearest box is moved against a toe
INTO_CONTACT_EVERY = 4


def check_mmdr_step(env, states, label):
  """On trained states of a moving random-delay env: every frame_idx[:, k]
  lies in [k fe, (k + 1) fe); one more step (launch count left as it
  was) moves each of the first 50 boxes by its table step, from its
  direction before the step, and leaves the others; the observations are
  finite."""
  import torch
  from vision4leg_torch.envs import terrain as terr
  from vision4leg_torch.ops import physics_kernel as pk
  fe = env.cfg.frame_extract
  k = torch.arange(4, device=states.frame_idx.device) * fe
  idx = states.frame_idx
  if not bool(((idx >= k) & (idx < k + fe)).all()):
    raise AssertionError(f"[{label}] frame_idx outside [k fe, (k+1) fe)")
  before = pk.robot_window.launches
  gen = torch.Generator(device=env.device).manual_seed(11)
  low, high = env.action_low, env.action_high
  E = idx.shape[0]
  act = low + (high - low) * torch.rand(E, low.shape[0], generator=gen,
                                        device=env.device)
  boxes, dirs = states.terrain.boxes, states.terrain.box_dirs.long()
  after, obs, _, _, _ = env.step_batch(states, act, gen)
  pk.robot_window.launches = before
  table = torch.from_numpy(terr._DIRECTION).to(boxes.device)
  moving = (torch.arange(boxes.shape[1], device=boxes.device)
            < terr.NUM_SPARSE_BLOCKS)
  want = boxes[..., :2] + table[dirs] * moving[:, None].float()
  moved = after.terrain.boxes[..., :2]
  if not (torch.equal(moved, want)
          and torch.equal(after.terrain.boxes[..., 2:], boxes[..., 2:])):
    raise AssertionError(f"[{label}] boxes did not move by their table "
                         "step")
  if not bool(torch.isfinite(obs).all()):
    raise AssertionError(f"[{label}] non-finite observations")
  n_moving = int(((table[dirs] != 0).any(-1) & moving).sum())
  log(f"[{label}] frame_idx within [k fe, (k+1) fe) on {E} envs (distinct "
      f"rows {len({tuple(r) for r in idx.tolist()})}); one more step moved "
      f"{n_moving} boxes by their table step exactly, the rest stayed; "
      "observations finite")


def moving_case(env, states, seed=13):
  """The window's inputs of one step of a moving env from `states` (the
  boxes moved by that step and pruned, as step_batch hands them to the
  window) under random actions; in every INTO_CONTACT_EVERY-th env the
  nearest valid box is moved against a random toe, the toe 1 cm inside
  the box's -x face (a box that moved into the robot).  Returns (args,
  the envs moved into contact)."""
  import torch
  from vision4leg_torch.envs import terrain as terr
  from vision4leg_torch.physics import engine
  dev = env.device
  gen = torch.Generator(device=dev).manual_seed(seed)
  E = states.step_counter.shape[0]
  low, high = env.action_low, env.action_high
  act12 = env._expand_action(low + (high - low) * torch.rand(
      E, low.shape[0], generator=gen, device=dev))
  draws = env.draw_step(E, states.terrain.boxes.shape[1], gen)
  terrain = terr.moving_blocks_step(states.terrain, states.step_counter,
                                    draws.move_dirs)
  args = list(rollout_window_inputs(env, states.replace(terrain=terrain),
                                    act12))
  boxes = args[4].clone()
  rs = states.robot
  toes, _, _ = engine.contact_points_world(
      env.model, rs.phys, engine.fwd_kinematics(env.model, rs.phys))
  rows = torch.arange(0, E, INTO_CONTACT_EVERY, device=dev)
  toe = toes[rows, torch.randint(4, (rows.numel(),), generator=gen,
                                 device=dev)]
  hx = boxes[rows, 0, 3]
  boxes[rows, 0, 0] = toe[:, 0] + hx - 0.01
  boxes[rows, 0, 1] = toe[:, 1]
  boxes[rows, 0, 6] = 0.0
  boxes[rows, 0, 7] = 1.0
  args[4] = boxes
  return tuple(args), rows


def phase_moving_window(env, states, card):
  """compare_with_plain on `moving_case` of `states` (two calls: same
  bits), timed as phase 3; returns (max_abs_err, its timing numbers)."""
  import torch
  from vision4leg_torch.ops import physics_kernel as pk
  args, rows = moving_case(env, states)
  counts = {}
  pk.window_plain(*args, counts=counts)
  ok, rep = pk.compare_with_plain(args)
  torch.cuda.synchronize()
  log_window_report(f"moving, {rows.numel()} envs with a box moved into "
                    "a toe", args, rep, counts)
  if not ok:
    raise AssertionError("physics_window disagrees with plain on the "
                         "moving case")
  check_repeatable("moving", args)
  numbers, ms = time_window("moving", args, card, counts)
  return rep["max_abs_err"], numbers, ms


def phase_collection(label, config, build_module, horizon, card, dev,
                     check=None, overrides=None, setup=None):
  """One `horizon`-step rollout at NUM_ENVS envs of `config` with the
  starter module `build_module` (seeded random weights, no fused layer:
  the collector calls pi_v, or pi then v), launch counts set to 0 just
  before and held after: the window once a step (policy_freq hybrid
  launches on the MPC env, whose partial resets' settles are counted
  apart), the layer never.  `check(env, cs, traj)` runs after;
  `overrides` changes env_build entries of the config; `setup(env)` runs
  on the env before the collector starts.  Returns the launch counts and
  the rate."""
  import torch
  from vision4leg_torch.collector import rollout as rollout_lib
  from vision4leg_torch.envs.mpc_env import A1MPCGymEnv
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  env, meta, params = build_env(config, dev, overrides)
  if setup is not None:
    setup(env)
  mpc = isinstance(env, A1MPCGymEnv)
  net = build_module(env, params)
  net.init_weights(torch.Generator().manual_seed(0))
  net = net.to(dev).eval()
  gs = params["general_setting"]
  rollout = rollout_lib.make_rollout_fn(
      env, lambda x: (net.pi(x), net.v(x)), net.v, horizon=horizon,
      max_episode_frames=params["collector"]["max_episode_frames"],
      discount=gs["discount"], proprio_dim=env.cfg.proprio_dim,
      obs_norm=meta["obs_norm"], action_low=env.action_low,
      action_high=env.action_high, env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"])
  gen = torch.Generator(device=dev).manual_seed(0)
  torch.cuda.reset_peak_memory_stats()
  held = torch.cuda.memory_allocated()
  t = time.perf_counter()
  cs = rollout_lib.init_collector(env, NUM_ENVS, gen)
  torch.cuda.synchronize()
  log(f"[{label}] init_collector at {NUM_ENVS} envs: "
      f"{time.perf_counter() - t:.2f}s")
  settles = env.settle_windows if mpc else 0
  pk.robot_window.launches = 0
  att.fused_transformer_layer.launches = 0
  att.fused_transformer_layer_bwd.launches = 0
  t = time.perf_counter()
  cs, traj, last_v = rollout(cs)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t
  settles = (env.settle_windows - settles) if mpc else 0
  launches = {"physics_window": pk.robot_window.launches - settles,
              "physics_window_settle": settles}
  per_step = env.cfg.policy_freq if mpc else int(env.kernel_capable)
  rate = horizon * NUM_ENVS / dt
  log(f"[{label}] rollout: {horizon} steps x {NUM_ENVS} envs in {dt:.3f}s "
      f"= {rate:.1f} env-steps/s on {card} ({type(net).__name__}); "
      f"physics_window launches {launches} (expected {horizon} x "
      f"{per_step}" + (" + the partial resets' settles" if mpc else "")
      + "), transformer_layer launches "
      f"{att.fused_transformer_layer.launches}")
  if (launches["physics_window"] != horizon * per_step
      or att.fused_transformer_layer.launches
      or att.fused_transformer_layer_bwd.launches):
    raise AssertionError(f"[{label}] launch counts {launches}")
  for name in ("obs", "acts", "log_probs", "values", "rewards"):
    if not torch.isfinite(getattr(traj, name)).all():
      raise AssertionError(f"[{label}] non-finite {name}")
  if traj.obs.shape != (horizon, NUM_ENVS, env.obs_dim) or not \
      torch.isfinite(last_v).all():
    raise AssertionError(f"[{label}] obs shape {tuple(traj.obs.shape)}")
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  added = peak - held / 2 ** 30
  log(f"[{label}] torch.cuda.max_memory_allocated over init_collector and "
      f"the rollout: {peak:.3f} GiB, {added:.3f} GiB above what was "
      f"allocated before; terminals {int(traj.terminals.sum())} of "
      f"{horizon * NUM_ENVS}")
  launches["max_memory_gib"] = peak
  launches["added_memory_gib"] = added
  if check is not None:
    launches["checked"] = check(env, cs, traj)
  return launches, rate


def check_interpolation(env, cs, traj):
  """Each interpolated image of the collector's last observations lies
  between the minimum and the maximum of the frames it averages (after
  the same depth normalization), within float32 rounding."""
  import torch
  st = cs.env_states
  cfg = env.cfg
  E = st.frames.shape[0]
  rows = torch.arange(E, device=st.frames.device)
  offs = torch.arange(cfg.frame_extract, device=st.frames.device)
  slots = torch.clamp(st.frame_idx.long()[:, :, None] + offs, 0,
                      cfg.num_stored_frames - 1)
  sel = st.frames[rows[:, None, None], slots]            # (E, 4, fe, H, W)
  used = (offs[None] <= st.interp_delay[:, None])[:, None, :, None, None]
  inf = torch.tensor(float("inf"), device=sel.device)
  lo = torch.where(used, sel, inf).amin(2)
  hi = torch.where(used, sel, -inf).amax(2)
  norm = ((lambda x: (x - 1.25) / 0.425)
          if cfg.depth_norm and cfg.depth_image else (lambda x: x))
  img = cs.raw_obs[:, cfg.proprio_dim:].reshape(E, 4, 64, 64)
  slack = 1e-5 * (1 + img.abs())
  out = (img < norm(lo) - slack) | (img > norm(hi) + slack)
  delays = torch.bincount(st.interp_delay.long(),
                          minlength=cfg.frame_extract).tolist()
  varied = float(((hi - lo) > 0).float().mean())
  log(f"[interpolation] last observations: {int(out.sum())} of "
      f"{img.numel()} pixels outside [min, max] of their averaged frames; "
      f"envs by interp_delay 0..{cfg.frame_extract - 1}: {delays}; share "
      f"of pixels whose frames differ {varied:.4f}")
  if bool(out.any()):
    raise AssertionError("an interpolated image lies outside its frames")


def check_fixed_delay(env, cs, traj):
  """Every env observes slots fe - 1, 2 fe - 1, 3 fe - 1, 4 fe - 1."""
  import torch
  fe = env.cfg.frame_extract
  want = (torch.arange(1, 5, device=cs.raw_obs.device) * fe - 1).int()
  if not bool((cs.env_states.frame_idx == want).all()):
    raise AssertionError("fixed delay: frame_idx is not [fe-1, ..., 4fe-1]")
  log(f"[fixed delay] frame_idx {want.tolist()} on every env")


MOUNTAIN_CONFIG = "config/rl/challenge/locotransformer/mountain.json"
HEIGHTFIELD_CONFIG = \
    "config/rl/static/frame_extract4_random_delay/thin-heightfield.json"
STATE_CONFIG = "config/rl/static/state-only-baseline.json"
STAIRS_CONFIG = "config/rl/challenge/locotransformer/stairs.json"
CHAIR_DESK_CONFIG = "config/rl/challenge/locotransformer/chair_desk.json"
STANDING_BAND = 0.02   # base height above the local ground after a reset
SPLIT_STEPS = 3        # steps timed for the non-flat step's split


class StepSplit:
  """The host-clock split of an env's steps: `step_from`, `reset_from`
  (which the collector calls, and `step_batch` and `reset` under them)
  and the methods `spans` names are wrapped, each timed between
  synchronizes.  `records` gets one dict per step (seconds by span, the
  step's own under "step_from", and the label of the part of the run it
  belongs to), the resets that follow it added to it as "resets"; spans
  inside a reset count as the reset's only.  `mark(label)` labels the
  steps that follow and opens a record for their first reset (an
  eval's)."""

  def __init__(self, env, spans):
    self.env, self.records, self.stack = env, [], []
    self.label = "collection"
    self.names = ("step_from", "reset_from") + tuple(spans)
    for name in self.names:
      setattr(env, name, self._wrap(name, getattr(env, name)))

  def _wrap(self, name, fn):
    import torch

    def run(*a, **kw):
      torch.cuda.synchronize()
      t = time.perf_counter()
      if name == "step_from":
        self.records.append({"label": self.label})
      self.stack.append(name)
      try:
        out = fn(*a, **kw)
        torch.cuda.synchronize()
      finally:
        self.stack.pop()
      dt = time.perf_counter() - t
      if name == "reset_from" or "reset_from" not in self.stack:
        if not self.records:
          self.records.append({"label": self.label})
        rec = self.records[-1]
        key = "resets" if name == "reset_from" else name
        rec[key] = rec.get(key, 0.0) + dt
      return out
    return run

  def mark(self, label):
    self.label = label
    self.records.append({"label": f"{label} reset"})

  def close(self):
    for name in self.names:
      delattr(self.env, name)


def time_nonflat_step(env, states, label):
  """The non-flat step's host-clock split at the batch of `states`: the
  engine window (`_engine_window`: 16 substeps of the per-env engine and
  the post-window contact read), the camera (`_render`: the heightfield
  march, boxes, preprocessing) and the rest of `step_batch`, each
  between synchronizes (`StepSplit`), over SPLIT_STEPS steps; then the
  march alone (`camera._ray_heightfield_t` on the same poses).  Returns ms
  per step."""
  import torch
  from vision4leg_torch.envs import camera as cam
  from vision4leg_torch.envs import terrain as terr
  from vision4leg_torch.physics import maths
  split = StepSplit(env, ("_engine_window", "_render"))
  gen = torch.Generator(device=env.device).manual_seed(17)
  low, high = env.action_low, env.action_high
  E = states.step_counter.shape[0]
  try:
    for _ in range(SPLIT_STEPS):
      act = low + (high - low) * torch.rand(E, low.shape[0], generator=gen,
                                            device=env.device)
      states, obs, _, _, _ = env.step_batch(states, act, gen)
  finally:
    split.close()
  if not bool(torch.isfinite(obs).all()):
    raise AssertionError(f"[{label}] non-finite observations")
  spent = lambda key: sum(r.get(key, 0.0) for r in split.records)
  ms = {"physics": spent("_engine_window"), "camera": spent("_render"),
        "step": spent("step_from")}
  ms = {k: v / SPLIT_STEPS * 1e3 for k, v in ms.items()}
  ms["rest"] = ms["step"] - ms["physics"] - ms["camera"]
  if env.cfg.get_image:
    eye, dirs = cam.camera_rays(states.robot.phys.pos,
                                maths.quat_to_mat(states.robot.phys.quat))
    h_fn = terr.heightfield_fns(states.terrain)[0]
    ms["march"] = time_ms(lambda: cam._ray_heightfield_t(eye, dirs, h_fn),
                          n=5, warm=1)
  log(f"[{label}] non-flat step at {E} envs on the host clock, "
      f"{SPLIT_STEPS} steps: {ms['step']:.1f} ms a step = engine window "
      f"{ms['physics']:.1f} + camera {ms['camera']:.1f} + rest "
      f"{ms['rest']:.1f} ms"
      + (f"; the heightfield march alone {ms['march']:.2f} ms (CUDA "
         f"events, 5 calls)" if "march" in ms else ""))
  return ms


def check_nonflat(env, states, label):
  """A fresh reset of NUM_ENVS envs stands every base within STANDING_BAND
  of the settled template's height above its own ground; then the step's
  split (`time_nonflat_step`) from the trained `states`."""
  import torch
  from vision4leg_torch.envs import terrain as terr
  gen = torch.Generator(device=env.device).manual_seed(19)
  fresh, _ = env.reset(NUM_ENVS, gen)
  pos = fresh.robot.phys.pos
  above = pos[:, 2] - terr.heightfield_fns(fresh.terrain)[0](
      pos[:, None, :2])[:, 0]
  want = float(env.settled_template().phys.pos[2])
  off = float((above - want).abs().max())
  log(f"[{label}] after a reset of {NUM_ENVS} envs: base height above the "
      f"local ground {float(above.min()):.4f}..{float(above.max()):.4f} m "
      f"(the template stands at {want:.4f} m; max off {off:.2e} m); base z "
      f"{float(pos[:, 2].min()):.3f}..{float(pos[:, 2].max()):.3f} m")
  if not off <= STANDING_BAND:
    raise AssertionError(f"[{label}] a base stands {off} m off the "
                         "template's height above its ground")
  del fresh
  return dict(time_nonflat_step(env, states, label), standing_off_m=off)


def stairs_case(env, states, seed=23):
  """Window inputs of the stairs env in which a toe of every env stands on
  a step's edge: the 7 slabs as the env's window sees them, the settled
  template's pose varied per env (joint angles, velocities) and shifted
  so that a random toe lies within 3 cm of a random one of the 7 step
  edges, its sphere 1 cm inside to 0.5 cm above the higher step's top;
  the commands random within 0.3 rad of the standing pose."""
  import torch
  from vision4leg_torch.physics import engine
  from vision4leg_torch.robots import a1
  dev = env.device
  g = torch.Generator().manual_seed(seed)
  E = states.step_counter.shape[0]
  u = lambda lo, hi, *shape: (lo + (hi - lo) * torch.rand(
      *shape, generator=g)).to(dev)
  tmpl = env.settled_template()
  rows = torch.arange(E, device=dev)
  phys = engine.PhysState(
      pos=tmpl.phys.pos.expand(E, 3).clone(),
      quat=tmpl.phys.quat.expand(E, 4).clone(),
      joint_q=tmpl.phys.joint_q + u(-0.1, 0.1, E, 12),
      ang=u(-0.3, 0.3, E, 3), lin=u(-0.3, 0.3, E, 3),
      joint_qd=u(-1.0, 1.0, E, 12))
  toes, _, _ = engine.contact_points_world(
      env.model, phys, engine.fwd_kinematics(env.model, phys))
  toe = toes[rows, torch.randint(4, (E,), generator=g).to(dev)]
  boxes = states.terrain.boxes
  # the step edges: each slab's rising (k = 0..3) or falling (k = 3..6) end
  k = torch.randint(7, (E,), generator=g).to(dev)
  side = torch.where(k < 4, -1.0, 1.0)
  edge_x = boxes[rows, k, 0] + side * boxes[rows, k, 3]
  x = edge_x + u(-0.03, 0.03, E)
  inside = ((x[:, None] - boxes[..., 0]).abs() <= boxes[..., 3]) & (
      boxes[..., 7] > 0.5)
  top = torch.where(inside, boxes[..., 2] + boxes[..., 5],
                    torch.zeros_like(boxes[..., 2])).amax(-1)
  r_toe = env.model.cp_radius[0]
  z = top + r_toe - u(-0.005, 0.01, E)
  shift = torch.stack([x - toe[:, 0], u(-1.0, 1.0, E) - toe[:, 1],
                       z - toe[:, 2]], -1)
  phys = phys.replace(pos=phys.pos + shift)
  cmd = tmpl.phys.joint_q + u(-0.3, 0.3, E, 12)
  fb = states.dyn.lateral_friction
  return (env.model, a1.init_robot_state(phys), cmd, states.dyn, boxes,
          states.terrain.obstacle_spheres, fb * env.cfg.fric_coeff[0], fb,
          env.cfg.num_action_repeat)


def phase_stairs_window(env, states, card):
  """compare_with_plain on `stairs_case` of `states` (two calls: same
  bits), timed as phase 3; returns (max_abs_err, its timing numbers)."""
  import torch
  from vision4leg_torch.ops import physics_kernel as pk
  args = stairs_case(env, states)
  counts = {}
  pk.window_plain(*args, counts=counts)
  ok, rep = pk.compare_with_plain(args)
  torch.cuda.synchronize()
  log_window_report("stairs, a toe on a step edge in every env", args, rep,
                    counts)
  if not ok:
    raise AssertionError("physics_window disagrees with plain on the "
                         "stairs case")
  if not int(counts.get("box_contacts", torch.zeros(1)).sum()) > 0:
    raise AssertionError("the stairs case made no box contact")
  check_repeatable("stairs", args)
  numbers, ms = time_window("stairs", args, card, counts)
  return rep["max_abs_err"], numbers, ms


MPC_HF_CONFIG = "config/mpc/locotransformer/thin-heightfield.json"
MPC_HF_STEPS = 2       # phase 19's collection steps (of the config's 8)
MPC_HF_EVAL = 2        # phase 19's eval steps, at EVAL_BATCH envs
RANDOM_SHAPE_CONFIG = "config/rl/static/locotransformer/thin-random-shape.json"
THIN_CONFIG = "config/rl/static/locotransformer/thin.json"
RANDOM_SHAPE_MPC_CONFIG = "config/mpc/baseline/thin-random-shape.json"
SIM2SIM_CONFIG = "config/rl/static/frame_extract4_random_delay/thin-goal.json"
# bf16 against float32 forwards: the JAX package's band for its bf16
# collection, relative to max(|x|, 0.05) (tests/test_bf16_inference.py)
BF16_BAND = 0.08


def phase_mpc_heightfield(card, dev):
  """MPC on the heightfield: config/mpc/locotransformer/thin-heightfield.
  json at full width, NUM_ENVS envs, fused layer on in collection and
  eval, through a PPOAgent: the reset (init_collector), an
  MPC_HF_STEPS-step rollout, an eval of MPC_HF_EVAL steps x EVAL_BATCH
  envs; the launch counts set to 0 just before the rollout and read after
  the eval: no window launch (rows 1 and 1h), the layer's exactly; every
  output finite; each step's host-clock split (engine ticks, controller,
  camera, the resets that follow it, rest)."""
  import dataclasses

  import torch
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  label = "MPC heightfield"
  env, meta, params = build_env(MPC_HF_CONFIG, dev)
  if env.kernel_capable:
    raise AssertionError(f"[{label}] the env takes the window")
  split = StepSplit(env, ("_engine_ticks", "controller_tick", "_render"))
  cfg = dataclasses.replace(common.ppo_config(params),
                            epoch_frames=MPC_HF_STEPS * NUM_ENVS)
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
    t = time.perf_counter()
    agent = PPOAgent(
        env=env, ac_module=starter.build_module(env, params), cfg=cfg,
        num_envs=NUM_ENVS, seed=0, logger=None, save_dir=tmp,
        num_eval_envs=EVAL_BATCH, obs_norm=meta["obs_norm"],
        env_time_limit=meta["horizon"], reward_scale=meta["reward_scale"],
        fused_attention=True, fused_update=True, eval_horizon=MPC_HF_EVAL,
        device=dev)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t
  log(f"[{label}] PPOAgent at {NUM_ENVS} envs (init_collector's reset: "
      f"{env.cfg.settle_steps} settle substeps of the per-env engine): "
      f"{reset_s:.2f}s")
  split.records.clear()
  settles = env.settle_windows
  pk.robot_window.launches = 0
  att.fused_transformer_layer.launches = 0
  att.fused_transformer_layer_bwd.launches = 0
  t = time.perf_counter()
  cs, traj, last_v = agent.rollout(agent.collector_state)
  torch.cuda.synchronize()
  roll_s = time.perf_counter() - t
  split.mark("eval")
  t = time.perf_counter()
  ret, steps = agent.evaluate()
  torch.cuda.synchronize()
  eval_s = time.perf_counter() - t
  split.close()
  launches = {"physics_window": pk.robot_window.launches,
              "physics_window_settle": env.settle_windows - settles,
              "transformer_layer": att.fused_transformer_layer.launches,
              "transformer_layer_bwd":
                  att.fused_transformer_layer_bwd.launches}
  want = {"physics_window": 0, "physics_window_settle": 0,
          "transformer_layer": 4 * MPC_HF_STEPS + 2 + 2 * MPC_HF_EVAL,
          "transformer_layer_bwd": 0}
  log(f"[{label}] rollout {MPC_HF_STEPS} steps x {NUM_ENVS} envs "
      f"{roll_s:.2f}s, eval {MPC_HF_EVAL} steps x {EVAL_BATCH} envs "
      f"{eval_s:.2f}s on {card}; launches {launches}, expected {want} "
      f"(layer: 4 x {MPC_HF_STEPS} pi_v + 2 last value at B={NUM_ENVS}, "
      f"2 x {MPC_HF_EVAL} eval at B={EVAL_BATCH}; no window: the per-env "
      "engine)")
  if launches != want:
    raise AssertionError(f"[{label}] launch counts {launches} != {want}")
  for name in ("obs", "acts", "log_probs", "values", "rewards"):
    if not torch.isfinite(getattr(traj, name)).all():
      raise AssertionError(f"[{label}] non-finite {name}")
  if (traj.obs.shape != (MPC_HF_STEPS, NUM_ENVS, env.obs_dim)
      or not torch.isfinite(last_v).all() or not torch.isfinite(ret).all()):
    raise AssertionError(f"[{label}] obs shape {tuple(traj.obs.shape)} or "
                         "non-finite values / eval returns")
  splits = []
  for rec in split.records:
    ms = {k: v * 1e3 for k, v in rec.items() if k != "label"}
    ticks = ms.get("_engine_ticks", 0.0)
    row = {"phase": rec["label"],
           "step": ms.get("step_from", 0.0),
           "engine": ticks - ms.get("controller_tick", 0.0),
           "controller": ms.get("controller_tick", 0.0),
           "camera": ms.get("_render", 0.0),
           "resets": ms.get("resets", 0.0)}
    row["rest"] = row["step"] - ticks - row["camera"]
    splits.append(row)
    log(f"[{label}] {row['phase']} step on the host clock: step "
        f"{row['step']:.1f} ms = engine ticks {row['engine']:.1f} + "
        f"controller {row['controller']:.1f} + camera {row['camera']:.1f} "
        f"+ rest {row['rest']:.1f}; then resets {row['resets']:.1f} ms")
  log(f"[{label}] terminals {int(traj.terminals.sum())} of "
      f"{MPC_HF_STEPS * NUM_ENVS}; eval steps {steps.tolist()}; outputs "
      "finite")
  return launches, dict(reset_s=reset_s, rollout_s=roll_s, eval_s=eval_s,
                        terminals=int(traj.terminals.sum()), splits=splits)


def phase_random_shape(horizon, card, dev):
  """thin-random-shape mirrored: the env of RANDOM_SHAPE_CONFIG draws the
  boxes of THIN_CONFIG's from the same seed (random_shape is ignored, as
  in the JAX env); a `horizon`-step collection of it on the window and
  one step of RANDOM_SHAPE_MPC_CONFIG through the hybrid window."""
  import torch
  from vision4leg_torch.starter import ppo_locotransformer as starter
  from vision4leg_torch.starter import ppo_nature_cnn as nature_starter
  boxes = []
  for config in (RANDOM_SHAPE_CONFIG, THIN_CONFIG):
    env, _, _ = build_env(config, dev)
    draws = env.draw_reset(NUM_ENVS,
                           torch.Generator(device=dev).manual_seed(5))
    boxes.append(draws.terrain.boxes)
  if not torch.equal(*boxes):
    raise AssertionError("thin-random-shape draws other boxes than thin")
  log(f"[random shape] {tuple(boxes[0].shape)} boxes at {NUM_ENVS} envs "
      "equal to thin.json's from the same seed (random_shape ignored)")
  del boxes, env, draws
  return {
      "random-shape collection": phase_collection(
          "random-shape", RANDOM_SHAPE_CONFIG, starter.build_module,
          horizon, card, dev),
      "random-shape MPC baseline collection": phase_collection(
          "random-shape MPC baseline", RANDOM_SHAPE_MPC_CONFIG,
          nature_starter.build_module, 1, card, dev)}


def check_sim2sim(agent, eval_build):
  """The eval env's options are those sim2sim_eval_params sets, and an
  eval reads the training collector's normalizer, the same object."""
  from vision4leg_torch.data import normalizer as norm
  cfg = agent.eval_env.cfg
  for key in ("reset_frame_idx_each_step", "frame_extract",
              "get_image_interval", "interpolation",
              "fixed_delay_observation"):
    if key in eval_build and getattr(cfg, key) != eval_build[key]:
      raise AssertionError(f"[sim2sim] eval env {key} {getattr(cfg, key)}")
  if not cfg.reset_frame_idx_each_step or agent.eval_env is agent.env:
    raise AssertionError("[sim2sim] the eval env is not the transfer env")
  seen, filt = [], norm.filt_with_img_tail
  norm.filt_with_img_tail = lambda n, raw, d: (seen.append(n),
                                               filt(n, raw, d))[1]
  try:
    agent.evaluate()
  finally:
    norm.filt_with_img_tail = filt
  if not seen or any(n is not agent.collector_state.normalizer
                     for n in seen):
    raise AssertionError("[sim2sim] the eval did not read the training "
                         "collector's normalizer")
  log(f"[sim2sim] eval env: reset_frame_idx_each_step "
      f"{cfg.reset_frame_idx_each_step}, frame_extract {cfg.frame_extract}, "
      f"get_image_interval {cfg.get_image_interval}; {len(seen)} eval "
      "steps read the training collector's normalizer (the same object)")
  return {"eval_frame_extract": cfg.frame_extract}


def phase_sim2sim(card, dev):
  """The sim2sim starter's pieces (starter/ppo_nature_cnn_sim2sim.py) on
  SIM2SIM_CONFIG: one epoch at NUM_ENVS envs with an eval of EVAL_HORIZON
  (of the transform's 2000) steps on the transfer env, through
  `phase_training`; then `check_sim2sim`."""
  import copy

  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_nature_cnn_sim2sim as sim2sim
  env, meta, params = build_env(SIM2SIM_CONFIG, dev)
  eval_env, eval_horizon = common.eval_env_of(
      params, sim2sim.sim2sim_eval_params, dev)
  eval_build = sim2sim.sim2sim_eval_params(
      copy.deepcopy(params["env"]))["env_build"]
  log(f"[sim2sim] eval env from sim2sim_eval_params: horizon "
      f"{eval_horizon}, cut to {EVAL_HORIZON}")
  return phase_training(
      "sim2sim", env, meta, params, sim2sim.build_module, 1, EVAL_HORIZON,
      card, fused=False, eval_env=eval_env,
      check=lambda a: check_sim2sim(a, eval_build))


def phase_bf16(env, meta, params, card):
  """bf16 collection on the thin-goal main path: a float32 and a bf16
  16-step rollout (fused layer asked for in both), each from a PPOAgent
  of seed 0 at NUM_ENVS envs, timed in turn; the layer's launches held to
  the float32 path's count and to 0 under bf16 (its collection forward
  takes the unfused layer, as the JAX layer routes a non-float32 input);
  the bf16 twin's pi_v held to the float32 pi_v on the bf16 rollout's
  first observations within BF16_BAND."""
  import torch
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  cfg = common.ppo_config(params)
  horizon = cfg.epoch_frames // NUM_ENVS
  out = {}
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
    for name, dtype in (("float32", None), ("bf16", torch.bfloat16)):
      agent = PPOAgent(
          env=env, ac_module=starter.build_module(env, params), cfg=cfg,
          num_envs=NUM_ENVS, seed=0, logger=None, save_dir=tmp,
          obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"],
          reward_scale=meta["reward_scale"], fused_attention=True,
          fused_update=True, inference_dtype=dtype, device=env.device)
      pk.robot_window.launches = 0
      att.fused_transformer_layer.launches = 0
      torch.cuda.synchronize()
      t = time.perf_counter()
      _, traj, last_v = agent.rollout(agent.collector_state)
      torch.cuda.synchronize()
      dt = time.perf_counter() - t
      launches = {"physics_window": pk.robot_window.launches,
                  "transformer_layer": att.fused_transformer_layer.launches}
      want = {"physics_window": horizon,
              "transformer_layer": 0 if dtype else 4 * horizon + 2}
      log(f"[{name} collection] {horizon} steps x {NUM_ENVS} envs in "
          f"{dt:.3f}s = {horizon * NUM_ENVS / dt:.1f} env-steps/s on {card};"
          f" launches {launches}, expected {want}")
      if launches != want:
        raise AssertionError(f"[{name} collection] launch counts")
      for x in (traj.obs, traj.means, traj.values, traj.log_probs, last_v):
        if x.dtype != torch.float32 or not torch.isfinite(x).all():
          raise AssertionError(f"[{name} collection] non-finite or "
                               f"{x.dtype} stats")
      out[name] = dict(launches, seconds=dt,
                       env_steps_per_s=horizon * NUM_ENVS / dt)
    obs = traj.obs[0]
    with torch.no_grad():
      (m16, s16, _), v16 = agent.collect_module.pi_v(
          obs.to(torch.bfloat16), fused=False)
      (m32, s32, _), v32 = agent.module.pi_v(obs, fused=False)
  errs = {}
  for key, lo, hi in (("mean", m16, m32), ("std", s16, s32),
                      ("value", v16, v32)):
    errs[key] = float(((lo.float() - hi).abs()
                       / hi.abs().clamp(min=0.05)).max())
  log(f"[bf16 collection] pi_v in bf16 against float32 on the rollout's "
      f"first {NUM_ENVS} observations: max relative err {errs} (band "
      f"{BF16_BAND}); float32 / bf16 rollout time "
      f"{out['float32']['seconds'] / out['bf16']['seconds']:.3f}")
  if not max(errs.values()) < BF16_BAND:
    raise AssertionError(f"[bf16 collection] pi_v off by {errs}")
  out["bf16"]["pi_v_rel_err"] = errs
  return out


def check_action_filter(env, cs, traj):
  """The filtered commands' range over the envs; the filter's output
  history holds the last command."""
  import torch
  st = cs.env_states
  act = st.last_action
  if not torch.equal(st.filter_state.yhist[:, 0], act):
    raise AssertionError("[action filter] the filter's newest output is "
                         "not the last command")
  lo, hi = float(act.min()), float(act.max())
  log(f"[action filter] filtered joint commands over {act.shape[0]} envs: "
      f"{lo:.4f}..{hi:.4f} rad; the filter's newest input minus output "
      f"max {float((st.filter_state.xhist[:, 0] - act).abs().max()):.4f} "
      "rad")
  return {"min": lo, "max": hi}


# ---------------------------------------------------------------------------
# phases 23-26: the locomotion-controller demo, the cold solver and the
# native core, the sphere terrain, random_dir and rotate_sensor
# ---------------------------------------------------------------------------

DEMO_TIME = 10.0       # phase 23's profile: 5 s standing, 5 s turning left
DEMO_HOLD_TICKS = 20   # its ticks held in float64 against the plain window
DEMO_HOLD_TOL = 1e-9   # the window's float64 rule, on positions and angles
COLD_BAND = 0.35       # warm vs cold forces (tests/test_mpc.py:398)
# the float32 cold solve against its float64 solve at 1024 envs: 4.5e-5
# on 128 envs of these states on the CPU
COLD_F32_TOL = 1e-2
COLD_F64_TOL = 1e-8    # card vs CPU float64 cold solve, relative
COLD_F64_ENVS = 8
NATIVE_TOL = 3.0       # N, native core vs cold solve (tests/test_mpc.py:172)
NATIVE_ITERS = 200     # the cold solve's budget on the standing cases
MPC_WEIGHTS = (5, 5, 0.2, 0, 0, 10, 0., 0., 1., 1., 1., 0., 0)
SPHERE_OVERRIDES = {"terrain_type": "random_sphere_with_subgoal"}
RANDOM_DIR_OVERRIDES = {"random_dir": True, "dir_update_interval": 5,
                        "rotate_sensor": True, "no_displacement": False}


class SpanTimer:
  """Host-clock seconds of every call of the methods `names` of `obj`,
  each call between synchronizes (`times`: a list by name)."""

  def __init__(self, obj, names):
    self.obj, self.names = obj, tuple(names)
    self.times = {name: [] for name in self.names}
    for name in self.names:
      setattr(obj, name, self._wrap(name, getattr(obj, name)))

  def _wrap(self, name, fn):
    import torch

    def run(*a, **kw):
      torch.cuda.synchronize()
      t = time.perf_counter()
      out = fn(*a, **kw)
      torch.cuda.synchronize()
      self.times[name].append(time.perf_counter() - t)
      return out
    return run

  def close(self):
    for name in self.names:
      delattr(self.obj, name)


def demo_float64_hold(env, ticks):
  """The demo's first `ticks` ticks from its reset, in float64 on the
  card (the env's model, QP scaling and state cast up): once through the
  kernel (row 1h's float64 instantiation), once with the window's plain
  version in its place.  Returns the largest difference of each output
  and the base's largest move over the ticks; the launch count is left as
  it was."""
  import copy
  import torch
  from vision4leg_torch.mpc import convex_mpc
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import locomotion_controller_example as demo
  before = pk.robot_window.launches
  state, _ = env.reset(1, torch.Generator(device=env.device).manual_seed(0))
  env64 = copy.copy(env)
  env64.model = pk._double(env.model)
  env64.mpc_canon = convex_mpc.canonical_constants(env.mpc_cfg).to(
      env.device, torch.float64)
  s64 = pk._double(state)
  kern = demo.run("a1", env=env64, state=s64, ticks=ticks)
  window = pk.robot_window
  pk.robot_window = pk.window_plain
  try:
    plain = demo.run("a1", env=env64, state=s64, ticks=ticks)
  finally:
    pk.robot_window = window
  pk.robot_window.launches = before
  diff = {k: float(abs(kern[k] - plain[k]).max())
          for k in ("pos", "rpy", "vel_body")}
  for k in ("joint_q", "joint_qd", "quat"):
    diff[k] = float((getattr(kern["state"].robot.phys, k)
                     - getattr(plain["state"].robot.phys, k)).abs().max())
  moved = float(abs(plain["pos"] - plain["pos"][:1]).max())
  return diff, moved


def phase_demo(card, dev):
  """The locomotion-controller demo on row 1h (`demo.run`, one env,
  DEMO_TIME s: 2,000 ticks of one hybrid window launch each after the
  reset's one settle launch), its first DEMO_HOLD_TICKS ticks held in
  float64 against the plain window; the robot upright by the demo's own
  criterion; the per-tick host split on the host clock (`SpanTimer`)."""
  import torch
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import locomotion_controller_example as demo
  env = demo.build_env("a1", dev)
  t = time.perf_counter()
  diff, moved = demo_float64_hold(env, DEMO_HOLD_TICKS)
  log(f"[demo] first {DEMO_HOLD_TICKS} ticks in float64, kernel vs plain "
      f"window on the card: max abs diff {diff} (tolerance "
      f"{DEMO_HOLD_TOL}); the base moved {moved:.3e} m; "
      f"{time.perf_counter() - t:.2f}s")
  if not max(diff[k] for k in ("pos", "rpy", "joint_q", "quat")) \
      <= DEMO_HOLD_TOL or not max(diff.values()) <= 100 * DEMO_HOLD_TOL:
    raise AssertionError(f"[demo] float64 ticks part from the plain "
                         f"window: {diff}")
  split = SpanTimer(env, ("reset", "_refresh_kkt", "controller_tick",
                          "_robot_window", "_contact_pen"))
  settles = env.settle_windows
  pk.robot_window.launches = 0
  try:
    torch.cuda.synchronize()
    t = time.perf_counter()
    traj = demo.run("a1", DEMO_TIME, env=env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
  finally:
    split.close()
  ticks = len(traj["t"])
  settle = env.settle_windows - settles
  hybrid = pk.robot_window.launches - settle
  sim = float(traj["t"][-1])
  # the reset's settle is the first _robot_window call, inside the reset
  settle_s = split.times["_robot_window"].pop(0)
  reset_s = sum(split.times.pop("reset"))
  per_tick = {k: sum(v) / ticks * 1e3 for k, v in split.times.items()}
  per_tick["rest"] = (wall - reset_s) / ticks * 1e3 - sum(per_tick.values())
  if any(len(v) != ticks for v in split.times.values()):
    raise AssertionError(f"[demo] span calls "
                         f"{ {k: len(v) for k, v in split.times.items()} }")
  lines = demo.segment_lines(traj)
  ok = demo.upright(traj)
  log(f"[demo] robot=a1 sim {sim:.3f}s in {wall:.3f}s wall on {card} "
      f"({sim / wall:.3f}x realtime, each span between synchronizes); "
      f"upright={ok}; {ticks} ticks; physics_window launches "
      f"{pk.robot_window.launches}: {hybrid} hybrid + {settle} settle; "
      f"reset {reset_s * 1e3:.1f} ms (its settle {settle_s * 1e3:.1f}); "
      f"per-tick host ms: KKT inverse {per_tick['_refresh_kkt']:.3f}, "
      f"controller {per_tick['controller_tick']:.3f}, window "
      f"{per_tick['_robot_window']:.3f}, contact read "
      f"{per_tick['_contact_pen']:.3f}, rest {per_tick['rest']:.3f}")
  for line in lines:
    log(f"[demo] {line.strip()}")
  want = int(DEMO_TIME / (env.cfg.num_action_repeat * env.cfg.time_step_s))
  if not ok or ticks != want or hybrid != ticks or settle != 1:
    raise AssertionError(f"[demo] upright={ok}, ticks {ticks}, launches "
                         f"{hybrid} hybrid + {settle} settle")
  return dict(physics_window=hybrid, physics_window_settle=settle), dict(
      sim_s=sim, wall_s=wall, ticks=ticks, per_tick_host_ms=per_tick,
      reset_ms=reset_s * 1e3, settle_ms=settle_s * 1e3,
      segments=demo.segment_report(traj), float64_hold=diff)


def mpc_stance_args(env, states):
  """The stance QP's state arguments of every env of MPC `states` under
  the commands of their last actions, as the next controller tick of an
  env step that kept the command would pose them (the warm iterates
  carry that command's solve): (args, the yawless rpy, the feet)."""
  from vision4leg_torch.mpc import controllers as ctrl
  from vision4leg_torch.mpc import leg_kinematics as lk
  from vision4leg_torch.physics import maths
  _, lin, ang = env._commands(states.last_action)
  rs = states.robot
  rpy = maths.quat_to_rpy(rs.phys.quat)
  rate = maths.quat_rotate_inv(rs.phys.quat, rs.phys.ang)
  feet = lk.foot_positions_base_frame(rs.phys.joint_q)
  contact, head, tail = ctrl._stance_inputs(states.controller, rpy, lin, ang,
                                            0.45)
  return (*head, rate, contact, feet, *tail), head[2], feet


def warm_vs_cold(env, states):
  """Per env of MPC `states`: the largest |f_warm - f_cold| over
  max(|f_cold|, 1) at the next tick (`mpc_stance_args`; the warm path from
  the carried iterates and a fresh KKT inverse, as an env step starts),
  and the stance arguments, the yawless rpy and the feet."""
  from vision4leg_torch.mpc import convex_mpc as cm
  cfg, canon = env.mpc_cfg, env.mpc_canon
  args, yawless, feet = mpc_stance_args(env, states)
  f_cold = cm.compute_contact_forces(cfg, *args)
  kinv = cm.kkt_inverse(cfg, canon, yawless, feet)
  f_warm, _ = cm.compute_contact_forces_warm(
      cfg, canon, states.controller.qp_warm.replace(kinv=kinv), *args,
      warm_iters=cfg.warm_iters, ns_iters=cfg.ns_iters)
  scale = f_cold.abs().amax(dim=(1, 2)).clamp(min=1.0)
  return ((f_cold - f_warm).abs().amax(dim=(1, 2)) / scale, f_cold, args,
          yawless, feet)


def phase_cold_solver(card, env, states):
  """The cold solve (`convex_mpc.compute_contact_forces`) on the card:
  * the JAX test's band (tests/test_mpc.py:352-398): the warm forces
    within COLD_BAND of the cold ones at the start of each of the first 8
    steps of one env walking at (0.3, 0) on plane (policy_freq 20, settle
    100, as that test);
  * at NUM_ENVS envs of phase 9's states: the float32 cold solve against
    its float64 solve within COLD_F32_TOL; the warm-vs-cold gap within
    COLD_BAND in every env, with its distribution (the band is the
    reference's property, not a bound: both solvers stop far from
    convergence, and on other states, such as uniform random commands,
    its tail can pass 0.35 in the reference's algorithm too); cold
    solve, warm solve and exact KKT inverse timed with CUDA events;
  * the card's float64 cold solve of COLD_F64_ENVS envs against the
    CPU's within COLD_F64_TOL;
  * the native core built with g++ and held against the float64 cold
    solve on every robot's standing QP within NATIVE_TOL."""
  import torch
  from vision4leg_torch.envs.mpc_env import A1MPCGymEnv, MpcEnvConfig
  from vision4leg_torch.mpc import convex_mpc as cm
  from vision4leg_torch.mpc import robot_params
  from vision4leg_torch.mpc.native import mpc_osqp
  from vision4leg_torch.robots import a1_params as P
  dev = env.device
  walk = A1MPCGymEnv(MpcEnvConfig(
      motor_control_mode="POSITION", clip_num=(0.3, 0.4), time_step_s=0.001,
      num_action_repeat=5, policy_freq=20, terrain_type="plane",
      target_vel=0.3, check_contact=False, settle_steps=100,
      alive_reward=0.1), device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  wstate, _ = walk.reset(1, gen)
  act = torch.tensor([[0.3, 0.0]], device=dev)
  walk_err = []
  for _ in range(8):
    wstate = wstate.replace(last_action=act)
    walk_err.append(float(warm_vs_cold(walk, wstate)[0].max()))
    wstate, _, _, done, _ = walk.step_batch(wstate, act, gen)
    if bool(done.any()):
      raise AssertionError("[cold solver] the walking env fell")
  log(f"[cold solver] the JAX test's protocol (one env walking at (0.3, 0), "
      f"8 steps): warm vs cold max relative err by step "
      f"{[round(e, 4) for e in walk_err]} (band {COLD_BAND})")
  if not max(walk_err) < COLD_BAND:
    raise AssertionError(f"[cold solver] warm path off the cold solve by "
                         f"{max(walk_err)} on the walk")
  del walk, wstate

  cfg, canon = env.mpc_cfg, env.mpc_canon
  err, f_cold, args, yawless, feet = warm_vs_cold(env, states)
  a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
  f64 = cm.compute_contact_forces(cfg, *a64)
  f32_err = float(((f_cold.double() - f64).abs().amax(dim=(1, 2))
                   / f64.abs().amax(dim=(1, 2)).clamp(min=1.0)).max())
  warm = states.controller.qp_warm
  kinv = cm.kkt_inverse(cfg, canon, yawless, feet)
  cold_ms = time_ms(lambda: cm.compute_contact_forces(cfg, *args), n=10)
  warm_ms = time_ms(lambda: cm.compute_contact_forces_warm(
      cfg, canon, warm.replace(kinv=kinv), *args,
      warm_iters=cfg.warm_iters, ns_iters=cfg.ns_iters), n=10)
  kkt_ms = time_ms(lambda: cm.kkt_inverse(cfg, canon, yawless, feet), n=10)
  q = torch.quantile(err.double(), torch.tensor([0.5, 0.99], device=dev,
                                                dtype=torch.float64))
  beyond = int((err >= COLD_BAND).sum())
  log(f"[cold solver] {NUM_ENVS} envs of the MPC collection's states: "
      f"float32 vs float64 cold solve max relative err {f32_err:.3e} "
      f"(tolerance {COLD_F32_TOL}); warm vs cold relative err median "
      f"{float(q[0]):.4f}, 99th percentile {float(q[1]):.4f}, max "
      f"{float(err.max()):.4f}, {beyond} envs at or past {COLD_BAND}; "
      f"total fz cold {float(-f_cold[..., 2].sum(-1).mean()):.2f} N mean; "
      f"on {card}: cold solve {cold_ms:.3f} ms, warm solve {warm_ms:.3f} "
      f"ms, exact KKT inverse {kkt_ms:.3f} ms (CUDA events, 10 calls)")
  if not bool(torch.isfinite(f_cold).all()) or not f32_err < COLD_F32_TOL:
    raise AssertionError(f"[cold solver] float32 cold solve off its "
                         f"float64 solve by {f32_err}")
  if beyond:
    raise AssertionError(f"[cold solver] warm path off the cold solve by "
                         f"{float(err.max())} in {beyond} envs")

  def to64(a):
    """An argument of the first COLD_F64_ENVS envs, floats in float64
    (the desired position and rpy are shared (3,) vectors)."""
    a = a if a.dim() == 1 else a[:COLD_F64_ENVS]
    return a.double() if a.is_floating_point() else a
  a64 = tuple(to64(a) for a in args)
  f_gpu = cm.compute_contact_forces(cfg, *a64)
  f_cpu = cm.compute_contact_forces(cfg, *(a.cpu() for a in a64))
  rel64 = float((f_gpu.cpu() - f_cpu).abs().max() / f_cpu.abs().max())
  log(f"[cold solver] float64 cold solve of {COLD_F64_ENVS} envs: card vs "
      f"CPU max relative err {rel64:.3e} (tolerance {COLD_F64_TOL})")
  if not rel64 < COLD_F64_TOL:
    raise AssertionError(f"[cold solver] float64 card vs CPU {rel64}")
  t = time.perf_counter()
  path = mpc_osqp.build()
  build_s = time.perf_counter() - t
  sets = {"a1 (RL-MPC SRB)": (float(P.MPC_BODY_MASS),
                              tuple(float(x) for x in P.MPC_BODY_INERTIA),
                              0.24, robot_params.A1.hip_positions)}
  sets.update({name: (rp.body_mass, tuple(rp.body_inertia), rp.body_height,
                      rp.hip_positions)
               for name, rp in robot_params.ROBOTS.items()})
  native_err = {}
  for name, (mass, inertia, h, hips) in sets.items():
    feet_np = [[x, y, -h] for x, y, _ in hips]
    core = mpc_osqp.ConvexMpc(mass, list(inertia), 4, 10, 0.025,
                              list(MPC_WEIGHTS), 1e-5)
    f_nat = torch.tensor(core.compute_contact_forces(
        [0.0, 0.0, h], [0.0] * 3, [0.0] * 3, [0.0] * 3, [1] * 4,
        sum(feet_np, []), [0.45] * 4, [0.0, 0.0, h], [0.0] * 3, [0.0] * 3,
        [0.0] * 3)[:12], dtype=torch.float64).reshape(4, 3)
    c64 = cm.MpcConfig(mass=mass, inertia=inertia, qp_weights=MPC_WEIGHTS,
                       admm_iters=NATIVE_ITERS)
    z = torch.tensor([[0.0, 0.0, h]], dtype=torch.float64, device=dev)
    zero = torch.zeros(1, 3, dtype=torch.float64, device=dev)
    f_t = cm.compute_contact_forces(
        c64, z, zero, zero, zero,
        torch.ones(1, 4, dtype=torch.int32, device=dev),
        torch.tensor(feet_np, dtype=torch.float64, device=dev)[None],
        torch.full((1, 4), 0.45, dtype=torch.float64, device=dev), z[0],
        zero[0], zero[0], zero[0])[0].cpu()
    native_err[name] = float((f_nat - f_t).abs().max())
  log(f"[cold solver] native core built by g++ in {build_s:.2f}s "
      f"({os.path.relpath(path)}); standing QPs, native vs float64 cold "
      f"solve ({NATIVE_ITERS} iterations) on the card: max abs diff N "
      f"{native_err} (tolerance {NATIVE_TOL})")
  if not max(native_err.values()) <= NATIVE_TOL:
    raise AssertionError(f"[cold solver] native core off: {native_err}")
  return dict(walk_warm_vs_cold_max_rel=walk_err,
              warm_vs_cold_rel=dict(median=float(q[0]), p99=float(q[1]),
                                    max=float(err.max()), beyond=beyond),
              float32_vs_float64=f32_err, cold_ms=cold_ms,
              warm_ms=warm_ms, kkt_inverse_ms=kkt_ms,
              float64_card_vs_cpu=rel64, native_build_s=build_s,
              native_vs_cold_n=native_err)


def sphere_terrain_case(env, states, seed=29):
  """The window's inputs of one step of the sphere env from `states`
  under random actions: the generator's spheres pruned at each base (as
  step_batch hands them to the window); in every INTO_CONTACT_EVERY-th
  env the nearest sphere moved against a random toe, resting on the
  ground with the toe 1 cm inside it.  Returns (args, those envs)."""
  import torch
  from vision4leg_torch.physics import engine
  dev = env.device
  gen = torch.Generator(device=dev).manual_seed(seed)
  E = states.step_counter.shape[0]
  low, high = env.action_low, env.action_high
  act12 = env._expand_action(low + (high - low) * torch.rand(
      E, low.shape[0], generator=gen, device=dev))
  args = list(rollout_window_inputs(env, states, act12))
  spheres = args[5].clone()
  rs = states.robot
  toes, _, _ = engine.contact_points_world(
      env.model, rs.phys, engine.fwd_kinematics(env.model, rs.phys))
  rows = torch.arange(0, E, INTO_CONTACT_EVERY, device=dev)
  toe = toes[rows, torch.randint(4, (rows.numel(),), generator=gen,
                                 device=dev)]
  r = spheres[rows, 0, 3]
  reach = r + env.model.cp_radius[0] - 0.01
  dz = r - toe[:, 2]
  h = torch.sqrt(torch.clamp(reach * reach - dz * dz, min=0.0))
  phi = 2 * math.pi * torch.rand(rows.numel(), generator=gen, device=dev)
  spheres[rows, 0, 0] = toe[:, 0] + h * torch.cos(phi)
  spheres[rows, 0, 1] = toe[:, 1] + h * torch.sin(phi)
  spheres[rows, 0, 2] = r
  spheres[rows, 0, 4] = 1.0
  args[5] = spheres
  return tuple(args), rows


def phase_spheres(card, dev):
  """random_sphere_with_subgoal on the window: a 16-step thin-goal
  collection at NUM_ENVS envs with the LocoTransformer, fused layer on
  (`agent_collection`: launches held exactly, row 1 once a step, row 2
  as phase 22's float32 collection) and its depth frames non-constant;
  then `sphere_terrain_case` of its last states against the plain version
  (`compare_with_plain`), two calls with the same bits, timed as phase
  3."""
  import torch
  from vision4leg_torch.ops import physics_kernel as pk
  env, meta, params = build_env(CONFIG, dev, SPHERE_OVERRIDES)
  launches, rate, cs, traj = agent_collection("spheres collection", env,
                                              meta, params, card)
  horizon = traj.obs.shape[0]
  depth = traj.obs[..., env.cfg.proprio_dim:].reshape(
      horizon, NUM_ENVS, 4, 64, 64)
  if not bool((depth.amax((-1, -2)) - depth.amin((-1, -2)) > 0.1).all()):
    raise AssertionError("[spheres collection] constant depth frames")
  states = cs.env_states
  args, rows = sphere_terrain_case(env, states)
  counts = {}
  pk.window_plain(*args, counts=counts)
  ok, rep = pk.compare_with_plain(args)
  torch.cuda.synchronize()
  log_window_report(f"spheres, {rows.numel()} envs with a sphere against "
                    "a toe", args, rep, counts)
  if not ok:
    raise AssertionError("physics_window disagrees with plain on the "
                         "sphere case")
  if not int(counts.get("sphere_contacts", torch.zeros(1)).sum()) > 0:
    raise AssertionError("the sphere case made no sphere contact")
  check_repeatable("spheres", args)
  numbers, ms = time_window("spheres", args, card, counts)
  return (dict(launches, env_steps_per_s=rate),
          dict(max_abs_err=rep["max_abs_err"], **numbers), ms,
          rep["max_abs_err"])


class DirWatch:
  """Records each RL step's RandoDir angle and count before and after
  `step_from` (installed on the env by `setup`), and checks them."""

  def setup(self, env):
    self.env, self.records = env, []
    step = env.step_from

    def watched(states, actions, draws):
      before = (states.dir_angle.clone(), states.dir_count.clone())
      out = step(states, actions, draws)
      self.records.append(before + (out[0].dir_angle.clone(),
                                    out[0].dir_count.clone()))
      return out
    env.step_from = watched

  def check(self, env, cs, traj):
    """The observation width is the JAX formula's; every step counts one
    observation and redraws the direction exactly on the counts the
    interval divides (a redrawn angle is a new draw: equal with
    probability 0); the (cos, sin) prefix is unit."""
    import torch
    del env.step_from
    cfg = env.cfg
    want = 2 + 12 + 36 + 3 * 7 + (36 if cfg.add_last_action_input else 0) \
        + (6 if cfg.goal else 0) + cfg.image_dim
    if env.obs_dim != want or traj.obs.shape[-1] != want:
      raise AssertionError(f"[random_dir] obs width {env.obs_dim}, JAX "
                           f"formula {want}")
    redraws = 0
    for a0, c0, a1, c1 in self.records:
      if not torch.equal(c1, c0 + 1):
        raise AssertionError("[random_dir] the count did not step by one")
      due = (c1 % cfg.dir_update_interval) == 0
      if not torch.equal(a1 != a0, due):
        raise AssertionError("[random_dir] a direction redrew off its "
                             "schedule")
      redraws += int(due.sum())
    steps = len(self.records)
    log(f"[random_dir] obs width {want} (the JAX formula: 2 + 3 x 7 "
        f"displacement and rotation + 12 + 36 + 36 + the frames); "
        f"{steps} steps, {redraws} redraws, each on a count divisible by "
        f"{cfg.dir_update_interval}; final states' disp_hist "
        f"{tuple(cs.env_states.disp_hist.shape)}")
    if steps == 0 or redraws == 0:
      raise AssertionError("[random_dir] no redraw was checked")
    return dict(obs_width=want, redraws=redraws)


def phase_random_dir(horizon, card, dev):
  """random_dir (interval 5) and rotate_sensor (displacement sensor on)
  on the thin-goal collection at NUM_ENVS envs: the window once a step,
  the observation width and the redraw schedule (`DirWatch`)."""
  from vision4leg_torch.starter import ppo_locotransformer as starter
  watch = DirWatch()
  return phase_collection(
      "random_dir + rotate_sensor", CONFIG, starter.build_module, horizon,
      card, dev, watch.check, overrides=RANDOM_DIR_OVERRIDES,
      setup=watch.setup)


# --- phases 27-31: JAX-trained runs, viewers, 33 tokens, terrains, TG ------
JAX_RUN = "runs/mmdr_moving_10M/A1MoveGround/0"
JAX_RUN_ID = "mmdr_moving_10M"
# the JAX run's log.csv: its last five evals (epochs 569-609) lie in
# 396.9-550.5; phase 27 holds the port's eval to half the lowest
JAX_EVAL_FLOOR = 198.5
JAX_EVAL_ENVS, JAX_EVAL_STEPS = 32, 999
VIEWER_EPISODES, VIEWER_STEPS = 2, 999   # the config's max_episode_frames
ENV_VIEWER_STEPS = 64
T33_BATCHES = (1024, 8)
HILL_CONFIG = "config/rl/challenge/locotransformer/hill.json"
# the 16-channel LocoTransformer's pi_v, fused against unfused: two
# layers of the forward tolerance and the MLP heads after them
RGBD_PI_V_TOL = dict(atol=1e-4, rtol=1e-4)


def copy_run(tmp, run, run_id):
  """A copy of the committed run `run` under tmp/run_id/A1MoveGround/0
  (the starters' log_dir/id/env_name/seed layout); returns its work
  dir."""
  root = os.path.dirname(os.path.abspath(__file__))
  work = os.path.join(tmp, run_id, "A1MoveGround", "0")
  shutil.copytree(os.path.join(root, run), work)
  return work


def copy_jax_run(tmp):
  """A copy of the committed JAX run JAX_RUN under tmp/JAX_RUN_ID."""
  return copy_run(tmp, JAX_RUN, JAX_RUN_ID)


def jax_log(work):
  """(last epoch, total frames, every eval (epoch, return)) of a run's
  log.csv."""
  import csv
  with open(os.path.join(work, "log.csv"), newline="") as f:
    rows = list(csv.DictReader(f))
  evals = [(int(float(r["EPOCH"])), float(r["Eval_Rewards_Average"]))
           for r in rows if r.get("Eval_Rewards_Average")]
  return int(float(rows[-1]["EPOCH"])), int(float(rows[-1]["Total Frames"])), \
      evals


def phase_jax_run(card, dev):
  """A policy the JAX package trained (JAX_RUN, MMDR on moving
  obstacles), on the port: the agent built from a copy's params.json by
  the starter's pieces (fused layer on) warm-starts from its .flax
  snapshot, read without JAX (epoch, frames and best eval as its
  log.csv's); rows 2 and 2ad held against their plain versions on its
  first observations with the trained weights (`check_layer_case`); then
  `evaluate` at JAX_EVAL_ENVS envs x JAX_EVAL_STEPS steps, the launch
  counts set to 0 just before (row 1 once a step, row 2 twice: pi's two
  layers), the mean return held to JAX_EVAL_FLOOR.  The float32 physics
  parts between the implementations at contact onsets, so the returns
  are compared as distributions, not episode by episode.  Returns the
  numbers, the launches and the tmp dir's copy (for phase 28)."""
  import torch
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.data import normalizer as norm
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  from vision4leg_torch.envs.get_env import get_env
  from vision4leg_torch.utils.logger import Logger
  tmp = tempfile.mkdtemp(prefix="chip_smoke_run_")
  work = copy_jax_run(tmp)
  with open(os.path.join(work, "params.json")) as f:
    params = json.load(f)
  env, meta = get_env(params["env_name"], params["env"], device=dev)
  logger = Logger(JAX_RUN_ID, params["env_name"], 0, params, tmp)
  cfg = common.ppo_config(params)
  t = time.perf_counter()
  agent = PPOAgent(
      env=env, ac_module=starter.build_module(env, params), cfg=cfg,
      num_envs=NUM_ENVS, seed=0, logger=logger,
      save_dir=os.path.join(logger.work_dir, "model"),
      num_eval_envs=JAX_EVAL_ENVS, obs_norm=meta["obs_norm"],
      env_time_limit=meta["horizon"], reward_scale=meta["reward_scale"],
      fused_attention=True, fused_update=True,
      eval_horizon=JAX_EVAL_STEPS, device=dev)
  epoch = agent.restore_checkpoint()
  torch.cuda.synchronize()
  last, frames, evals = jax_log(work)
  best = max(r for _, r in evals)
  log(f"[JAX run] PPOAgent from {JAX_RUN}/params.json at {NUM_ENVS} envs, "
      f"warm start from model_pf_best.flax: epoch {epoch}, "
      f"{agent.total_frames} frames, best eval {agent.best_eval:.4f} "
      f"(log.csv: last epoch {last}, {frames} frames, best eval "
      f"{best:.4f}) in {time.perf_counter() - t:.2f}s")
  if (epoch, agent.total_frames, agent.best_eval) != (last + 1, frames,
                                                      best):
    raise AssertionError("[JAX run] the warm start does not match log.csv")

  # rows 2 and 2ad on the trained weights and the first observations
  gen = torch.Generator(device=dev).manual_seed(27)
  net = agent.module
  with torch.no_grad():
    obs = norm.filt_with_img_tail(agent.collector_state.normalizer,
                                  agent.collector_state.raw_obs,
                                  env.cfg.proprio_dim)
    tokens = net._tokens(obs)
    w0, w1 = [att.LayerWeights(*[t.detach() for t in
                                 att.weights_from_layer(layer)])
              for layer in net.pf_layers]
    second = att.layer_math(tokens, w0)
  max_err, bwd_err = 0.0, 0.0
  for name, (x_all, w) in {"trained tokens->pf_layers.0": (tokens, w0),
                           "trained layer-1 out->pf_layers.1": (second, w1)
                           }.items():
    for B in (NUM_ENVS, EVAL_BATCH):
      err, b_err = check_layer_case(name, x_all[:B].contiguous(), w, gen)
      max_err, bwd_err = max(max_err, err), max(bwd_err, b_err)

  pk.robot_window.launches = 0
  att.fused_transformer_layer.launches = 0
  att.fused_transformer_layer_bwd.launches = 0
  t = time.perf_counter()
  rets, steps = agent.evaluate()
  torch.cuda.synchronize()
  dt = time.perf_counter() - t
  launches = {"physics_window": pk.robot_window.launches,
              "transformer_layer": att.fused_transformer_layer.launches}
  want = {"physics_window": JAX_EVAL_STEPS,
          "transformer_layer": 2 * JAX_EVAL_STEPS}
  rets = rets.double().cpu()
  fell = float((steps < JAX_EVAL_STEPS).float().mean())
  numbers = dict(mean=float(rets.mean()), min=float(rets.min()),
                 max=float(rets.max()), std=float(rets.std()),
                 fall_share=fell, seconds=dt, epoch=epoch,
                 jax_last_five=evals[-5:])
  log(f"[JAX run] eval of the JAX-trained policy on {card}: "
      f"{JAX_EVAL_ENVS} envs x {JAX_EVAL_STEPS} steps in {dt:.2f}s; return "
      f"mean {numbers['mean']:.2f}, min {numbers['min']:.2f}, max "
      f"{numbers['max']:.2f}, std {numbers['std']:.2f}, fall share "
      f"{fell:.3f}; the JAX log's last five evals (epoch, return): "
      f"{[(e, round(r, 1)) for e, r in evals[-5:]]}; launches {launches} "
      f"(expected {want})")
  if launches != want or att.fused_transformer_layer_bwd.launches:
    raise AssertionError(f"[JAX run] launch counts {launches}")
  if not numbers["mean"] >= JAX_EVAL_FLOOR:
    raise AssertionError(f"[JAX run] mean eval return {numbers['mean']:.2f}"
                         f" below {JAX_EVAL_FLOOR}")
  return numbers, launches, (max_err, bwd_err), tmp


def phase_viewers(tmp, card, dev):
  """The port's locotransformer_viewer on phase 27's copy of the JAX run
  (VIEWER_EPISODES episodes of VIEWER_STEPS steps, the depth video
  written into tmp and checked non-empty), then env_viewer on thin-goal
  for ENV_VIEWER_STEPS steps at one env with its env-steps/s; each with
  the launch counts set to 0 just before (the viewer's policy runs the
  unfused layer, as the JAX viewer's: row 1 once a step)."""
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import env_viewer, locotransformer_viewer
  from vision4leg_torch.starter.viewer_common import run_viewer
  video = os.path.join(tmp, "depth.mp4")
  work = os.path.join(tmp, JAX_RUN_ID, "A1MoveGround", "0")
  paths = {}
  for label, call, steps in (
      ("viewer", lambda: run_viewer(
          locotransformer_viewer._build_module,
          ["--config", os.path.join(work, "params.json"), "--log_dir", tmp,
           "--id", JAX_RUN_ID, "--episodes", str(VIEWER_EPISODES),
           "--video", video, "--device", str(dev)], horizon=VIEWER_STEPS),
       VIEWER_STEPS),
      ("env viewer", lambda: env_viewer.main(
          ["--config", os.path.join(os.path.dirname(os.path.abspath(
              __file__)), CONFIG), "--steps", str(ENV_VIEWER_STEPS),
           "--device", str(dev)]),
       ENV_VIEWER_STEPS)):
    pk.robot_window.launches = 0
    att.fused_transformer_layer.launches = 0
    t = time.perf_counter()
    out = call()
    dt = time.perf_counter() - t
    paths[label] = {"physics_window": pk.robot_window.launches,
                    "transformer_layer": att.fused_transformer_layer.launches,
                    "seconds": dt}
    log(f"[{label}] {dt:.2f}s on {card}; launches {paths[label]}")
    if (paths[label]["physics_window"] != steps
        or paths[label]["transformer_layer"]):
      raise AssertionError(f"[{label}] launch counts {paths[label]}")
    if label == "viewer":
      size = os.path.getsize(video)
      paths[label].update(video_bytes=size, returns=out["returns"].tolist())
      log(f"[viewer] returns {[round(r, 2) for r in out['returns'].tolist()]}"
          f", depth video {size} bytes")
      if not size > 0:
        raise AssertionError("[viewer] empty video")
    else:
      paths[label]["env_steps_per_s"] = out["env_steps_per_s"]
  return paths


def phase_layer_33(obs, card, dev):
  """The layer kernels at the 16-channel LocoTransformer's 33 tokens (the
  forward's large instantiation): its tokenizer at the config's widths
  with seeded random weights on phase 4's observations with eight rgb
  frames of the same seed put before the depth, the forward and the
  gradients at T33_BATCHES (`check_layer_case`); the forward, forward +
  backward, plain and library times and bounds (`time_layer_shape`); row
  2 at (1024, 17) timed again beside it on random tokens; the model's
  pi_v fused against unfused (RGBD_PI_V_TOL), its launches counted."""
  import torch
  from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.starter.common import locotransformer_kwargs
  env, _, params = build_env(CONFIG, dev)
  kw = dict(locotransformer_kwargs(env, params),
            visual_input_shape=(16, 64, 64))
  net = LocoTransformerActorCritic(
      **kw, generator=torch.Generator().manual_seed(16)).to(dev).eval()
  gen = torch.Generator(device=dev).manual_seed(33)
  p = env.cfg.proprio_dim
  rgb = torch.rand(obs.shape[0], 12 * 64 * 64, generator=gen, device=dev)
  x = torch.cat([obs[:, :p], rgb, obs[:, p:]], dim=-1)
  with torch.no_grad():
    tokens = net._tokens(x)
    w0 = att.LayerWeights(*[t.detach() for t in
                            att.weights_from_layer(net.pf_layers[0])])
  if tokens.shape[1] != 33:
    raise AssertionError(f"the 16-channel tokenizer gave {tokens.shape}")
  errs = [check_layer_case(name, x_all[:B].contiguous(), w0, gen)
          for name, x_all in (
              ("rgbd tokens T=33->pf_layers.0", tokens),
              ("randn T=33->pf_layers.0",
               torch.randn(tokens.shape, generator=gen, device=dev)))
          for B in T33_BATCHES]
  before = (att.fused_transformer_layer.launches,
            att.fused_transformer_layer_bwd.launches)
  lib = library_layer(w0)
  shapes = {f"{B}x33": time_layer_shape(tokens[:B].contiguous(), w0, lib,
                                        gen, card)
            for B in T33_BATCHES}
  x17 = torch.randn(NUM_ENVS, 17, tokens.shape[-1], generator=gen,
                    device=dev)
  with torch.no_grad():
    k17 = [time_ms(lambda: att.fused_transformer_layer(x17, w0))
           for _ in range(2)]
  log(f"transformer_layer at B={NUM_ENVS} T=17 beside T=33 on {card}: "
      f"{k17[0]:.4f} / {k17[1]:.4f} ms (the small instantiation)")
  att.fused_transformer_layer.launches, \
      att.fused_transformer_layer_bwd.launches = before
  with torch.no_grad():
    att.fused_transformer_layer.launches = 0
    (m_f, _, _), v_f = net.pi_v(x, fused=True)
    torch.cuda.synchronize()
    launches = {"transformer_layer": att.fused_transformer_layer.launches}
    (m_p, _, _), v_p = net.pi_v(x, fused=False)
  pi_err = max(float((m_f - m_p).abs().max()), float((v_f - v_p).abs().max()))
  ok = all(_close(a, b, **RGBD_PI_V_TOL)[1] for a, b in ((m_f, m_p),
                                                         (v_f, v_p)))
  log(f"16-channel LocoTransformer pi_v at B={x.shape[0]} (33 tokens) on "
      f"{card}: fused vs unfused max abs err {pi_err:.3e}; launches "
      f"{launches}")
  if not ok or launches["transformer_layer"] != 4:
    raise AssertionError("[T=33] the 16-channel pi_v fused disagrees with "
                         "unfused, or its launches are off")
  return dict(max_abs_err=max(e for e, _ in errs),
              bwd_max_abs_err=max(b for _, b in errs), shapes=shapes,
              row2_1024x17_ms=k17, pi_v_max_abs_err=pi_err), launches


def agent_collection(label, env, meta, params, card, wrap=None):
  """One rollout of a PPOAgent's collector (the LocoTransformer of the
  starter, fused layer on, seeded random weights) at NUM_ENVS envs, the
  launch counts set to 0 just before and held after: the window once a
  step on a flat terrain and never on a heightfield, the layer 4 a step
  and 2 for the bootstrap; every output finite.  Returns the launches
  (with the seconds), the rate, the collector state and the
  trajectory."""
  import torch
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  cfg = common.ppo_config(params)
  horizon = cfg.epoch_frames // NUM_ENVS
  t = time.perf_counter()
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
    agent = PPOAgent(
        env=env, ac_module=starter.build_module(env, params), cfg=cfg,
        num_envs=NUM_ENVS, seed=0, logger=None, save_dir=tmp,
        obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"],
        reward_scale=meta["reward_scale"], fused_attention=True,
        fused_update=True, device=env.device)
    torch.cuda.synchronize()
    log(f"[{label}] PPOAgent at {NUM_ENVS} envs (init + init_collector): "
        f"{time.perf_counter() - t:.2f}s")
    pk.robot_window.launches = 0
    att.fused_transformer_layer.launches = 0
    att.fused_transformer_layer_bwd.launches = 0
    t = time.perf_counter()
    cs, traj, last_v = agent.rollout(agent.collector_state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
  launches = {"physics_window": pk.robot_window.launches,
              "transformer_layer": att.fused_transformer_layer.launches}
  want = {"physics_window": horizon * int(env.kernel_capable),
          "transformer_layer": 4 * horizon + 2}
  rate = horizon * NUM_ENVS / dt
  log(f"[{label}] rollout: {horizon} steps x {NUM_ENVS} envs in {dt:.3f}s "
      f"= {rate:.1f} env-steps/s on {card}; launches {launches}, expected "
      f"{want}; terminals {int(traj.terminals.sum())}")
  if launches != want or att.fused_transformer_layer_bwd.launches:
    raise AssertionError(f"[{label}] launch counts {launches}")
  for x in (traj.obs, traj.values, traj.log_probs, traj.rewards, last_v):
    if not torch.isfinite(x).all():
      raise AssertionError(f"[{label}] non-finite outputs")
  return dict(launches, seconds=dt), rate, cs, traj


def phase_terrains(card, dev):
  """16-step collections at NUM_ENVS envs, fused layer on, of the hill
  (config/rl/challenge/locotransformer/hill.json: random_hill on the
  per-env engine) and of thin-goal with terrain_type multi_stairs and
  random_blocks (the window)."""
  out = {}
  for label, config, overrides in (
      ("hill collection", HILL_CONFIG, None),
      ("multi_stairs collection", CONFIG, {"terrain_type": "multi_stairs"}),
      ("random_blocks collection", CONFIG,
       {"terrain_type": "random_blocks"})):
    env, meta, params = build_env(config, dev, overrides)
    out[label] = agent_collection(label, env, meta, params, card)[:2]
    del env
  return out


def phase_trajectory_generator(card, dev):
  """The trajectory-generator wrapper on a 16-step thin-goal collection
  at NUM_ENVS envs (12 motor angles: diagonal_act off), the open-loop
  trot at the env's control step, the LocoTransformer reading the phase's
  (cos, sin) as two more proprio inputs (fused layer on): the window once
  a step, the layer 4 a step and 2 for the bootstrap; the phase of every
  env that no reset restarted at 16 steps of 2 pi f dt, every command
  within the joint limits."""
  import math

  import torch
  from vision4leg_torch.collector import rollout as rollout_lib
  from vision4leg_torch.envs.trajectory_generator import (
      OpenloopGaitGenerator, TrajectoryGeneratorWrapper)
  from vision4leg_torch.models.actor_critic import LocoTransformerActorCritic
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.robots import a1_params as P
  from vision4leg_torch.starter import common
  env, meta, params = build_env(CONFIG, dev, {"diagonal_act": False})
  dt_ctrl = env.cfg.time_step_s * env.cfg.num_action_repeat
  tg = OpenloopGaitGenerator(control_dt=dt_ctrl)
  wrapped = TrajectoryGeneratorWrapper(env, tg)
  p = env.cfg.proprio_dim
  net = LocoTransformerActorCritic(
      **dict(common.locotransformer_kwargs(env, params),
             state_input_shape=p + 2),
      generator=torch.Generator().manual_seed(0)).to(dev).eval()
  order = lambda x: torch.cat([x[:, :p], x[:, -2:], x[:, p:-2]], dim=-1)
  gs = params["general_setting"]
  horizon = common.ppo_config(params).epoch_frames // NUM_ENVS
  rollout = rollout_lib.make_rollout_fn(
      wrapped, lambda x: net.pi_v(order(x), fused=True),
      lambda x: net.v(order(x), fused=True), horizon=horizon,
      max_episode_frames=params["collector"]["max_episode_frames"],
      discount=gs["discount"], proprio_dim=p, obs_norm=meta["obs_norm"],
      action_low=wrapped.action_low, action_high=wrapped.action_high,
      env_time_limit=meta["horizon"], reward_scale=meta["reward_scale"])
  gen = torch.Generator(device=dev).manual_seed(0)
  cs = rollout_lib.init_collector(wrapped, NUM_ENVS, gen)
  pk.robot_window.launches = 0
  att.fused_transformer_layer.launches = 0
  att.fused_transformer_layer_bwd.launches = 0
  t = time.perf_counter()
  cs, traj, last_v = rollout(cs)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t
  launches = {"physics_window": pk.robot_window.launches,
              "transformer_layer": att.fused_transformer_layer.launches}
  want = {"physics_window": horizon, "transformer_layer": 4 * horizon + 2}
  ran = ~traj.terminals[..., 0].any(0)
  phase = cs.env_states.tg.phase[ran].double()
  expect = math.fmod(horizon * 2 * math.pi * tg.frequency_hz * dt_ctrl,
                     2 * math.pi)
  phase_err = float((phase - expect).abs().max()) if phase.numel() else 0.0
  cmd = cs.env_states.env.last_action
  lo, hi = (torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (P.JOINT_LOWER, P.JOINT_UPPER))
  in_limits = bool(((cmd >= lo - 1e-6) & (cmd <= hi + 1e-6)).all())
  log(f"[trajectory generator] {horizon} steps x {NUM_ENVS} envs in "
      f"{dt:.3f}s = {horizon * NUM_ENVS / dt:.1f} env-steps/s on {card}; "
      f"launches {launches}, expected {want}; obs width "
      f"{traj.obs.shape[-1]} (env {env.obs_dim} + 2); {int(ran.sum())} envs "
      f"never reset, their phase within {phase_err:.2e} of {expect:.6f}; "
      f"commands within the joint limits: {in_limits}")
  if (launches != want or att.fused_transformer_layer_bwd.launches
      or traj.obs.shape[-1] != env.obs_dim + 2 or not in_limits
      or not int(ran.sum()) or phase_err > 1e-4):
    raise AssertionError("[trajectory generator] collection check failed")
  for x in (traj.obs, traj.values, traj.log_probs, traj.rewards, last_v):
    if not torch.isfinite(x).all():
      raise AssertionError("[trajectory generator] non-finite outputs")
  return dict(launches, seconds=dt), horizon * NUM_ENVS / dt


# ---------------------------------------------------------------------------
# phases 32-35: the rest of the on-policy family, the off-policy family,
# the hierarchical collector
# ---------------------------------------------------------------------------

F64_ENVS = 64          # the float64 card-vs-CPU updates: the first 64 envs
F64_STEPS = 4          # ... of the first 4 steps (phase 33: F64_AUX_STEPS;
F64_AUX_STEPS = 2      # the Impala encoder costs ~10x the Nature CNN)
F64_REL = 1e-7         # on-policy updates, card vs CPU, float64
OFF_F64_REL = 1e-9     # one off-policy update, card vs CPU, float64
HIER_ACT_TOL = 1e-6    # the hierarchical act_fn, card vs CPU, float32
OFF_POLICY_OVERRIDES = {"terrain_type": "random_blocks_sparse_with_subgoal"}
OFF_POLICY_STEPS = 16  # pretrain and epoch steps at NUM_ENVS envs
REPLAY_CAPACITY = 2 ** 20
DQN_ACTIONS = 6
CARD_DEVICE = "cuda"   # the card side of the float64 comparisons


def zero_counts():
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  pk.robot_window.launches = 0
  att.fused_transformer_layer.launches = 0
  att.fused_transformer_layer_bwd.launches = 0


def read_counts():
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  return {"physics_window": pk.robot_window.launches,
          "transformer_layer": att.fused_transformer_layer.launches,
          "transformer_layer_bwd": att.fused_transformer_layer_bwd.launches}


def set_counts(counts):
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  pk.robot_window.launches = counts["physics_window"]
  att.fused_transformer_layer.launches = counts["transformer_layer"]
  att.fused_transformer_layer_bwd.launches = counts["transformer_layer_bwd"]


def rel_diff(a, b):
  """Largest |a - b| over a dict of tensors, relative to the largest |b|
  over all of them (one scale for the whole state: a tensor whose update
  is rounding alone, as the key bias's, whose gradient is exactly 0 in
  exact arithmetic, would make a per-tensor ratio meaningless)."""
  diff = scale = 0.0
  for k, v in b.items():
    v = v.detach().cpu().double()
    diff = max(diff, float((a[k].detach().cpu().double() - v).abs().max()))
    scale = max(scale, float(v.abs().max()))
  return diff / max(scale, 1e-300)


def on_policy_configs(params, batch_size=None):
  """The A2C, REINFORCE, V-MPO and TRPO configs of `params`' ppo section
  (its rates, opt_epochs, batch and GAE settings; each algorithm's own
  lr_decay, TRPO's own opt_epochs); `batch_size` replaces the batch (and
  epoch_frames)."""
  import dataclasses

  from vision4leg_torch.algo import a2c, trpo, vmpo
  from vision4leg_torch.algo.on_policy_base import OnPolicyConfig
  from vision4leg_torch.starter import common
  base = common.ppo_config(params)
  fields = {f.name: getattr(base, f.name)
            for f in dataclasses.fields(OnPolicyConfig)
            if f.name != "lr_decay"}
  if batch_size is not None:
    fields.update(batch_size=batch_size, epoch_frames=batch_size)
  no_opt = {k: v for k, v in fields.items() if k != "opt_epochs"}
  return {"A2C": (a2c.A2CLearner, a2c.A2CConfig(**fields)),
          "REINFORCE": (a2c.ReinforceLearner, a2c.A2CConfig(**fields)),
          "V-MPO": (vmpo.VMPOLearner, vmpo.VMPOConfig(**fields)),
          "TRPO": (trpo.TRPOLearner, trpo.TRPOConfig(**no_opt))}


def run_update(learner_cls, cfg, net, traj, last_v, fused, perms,
               pi_aux=False):
  """One update_per_epoch of a copy of `net` by `learner_cls` (fused=None:
  a module without the switch); returns (the copy's state_dict, the
  metrics as floats, the learner)."""
  import copy
  m = copy.deepcopy(net).train()
  kw = {"fused": fused} if fused is not None else {}
  args = (cfg, lambda mm, x: mm.pi(x, **kw), lambda mm, x: mm.v(x, **kw), m)
  if pi_aux:
    learner = learner_cls(*args, apply_pi_aux=lambda mm, x: mm.pi_with_aux(x))
  else:
    learner = learner_cls(*args)
  _, metrics = learner.update_per_epoch(learner.init_state(m), traj, last_v,
                                        perms=perms)
  return ({k: v.detach() for k, v in m.state_dict().items()},
          {k: float(v) for k, v in metrics.items()}, learner)


def float64_card_vs_cpu(label, learners, net, traj, last_v, envs, steps,
                        pi_aux=False):
  """Each learner's update of a float64 copy of `net` on the card and on
  the CPU, from the first `envs` envs x `steps` steps of the trajectory
  (float64) with its rows in order: the largest relative parameter and
  metric difference, held to F64_REL; the step fraction TRPO accepted on
  each."""
  import copy

  import torch
  from vision4leg_torch.collector.rollout import Transition
  traj = Transition(*(x[:steps, :envs] for x in traj))
  last_v = last_v[:envs]
  perms = [list(range(steps))] * 10
  out = {}
  for name, (cls, cfg) in learners.items():
    got = {}
    for dev in (CARD_DEVICE, "cpu"):
      m = copy.deepcopy(net).to(dev).double()
      tr = Transition(*(x.to(dev).double() if x.is_floating_point()
                        else x.to(dev) for x in traj))
      sd, metrics, learner = run_update(cls, cfg, m, tr,
                                        last_v.to(dev).double(), None, perms,
                                        pi_aux)
      got[dev] = (sd, metrics, getattr(learner, "last_search", {}).get(
          "step_frac"))
    card = got[CARD_DEVICE]
    err = rel_diff(card[0], got["cpu"][0])
    m_err = max(abs(card[1][k] - v) / max(abs(v), 1e-300)
                for k, v in got["cpu"][1].items())
    frac = ("" if got["cpu"][2] is None else
            f"; TRPO accepted step fraction {card[2]} on the card, "
            f"{got['cpu'][2]} on the CPU")
    log(f"[{label}] {name} float64 update on the card vs the CPU "
        f"({envs} envs x {steps} steps): largest parameter difference "
        f"{err:.3e} of the largest parameter, metrics {m_err:.3e} relative "
        f"(gate {F64_REL:g})"
        f"{frac}")
    if not (err <= F64_REL and m_err <= F64_REL):
      raise AssertionError(f"[{label}] {name} float64 card/CPU update "
                           f"parts by {err:.3e} / {m_err:.3e}")
    if card[2] != got["cpu"][2]:
      raise AssertionError(f"[{label}] TRPO accepted other steps")
    out[name] = dict(param_rel=err, metric_rel=m_err, step_frac=card[2])
  return out


def second_derivative_raises(net, obs):
  """A second derivative through the fused layer on the card (the
  gradient of the policy mean's square with create_graph, as TRPO's
  Fisher-vector product takes it) raises: the layer is
  once-differentiable.  Its launches are a check and are not counted."""
  import torch
  before = read_counts()
  p = [q for n, q in net.named_parameters() if n.startswith("pf_layers")]
  mean, _, _ = net.pi(obs, fused=True)
  try:
    torch.autograd.grad((mean ** 2).sum(), p, create_graph=True,
                        allow_unused=True)
  except RuntimeError as e:
    if "once-differentiable" not in str(e):
      raise
    raised = True
  else:
    raised = False
  set_counts(before)
  log(f"[on-policy family] a second derivative through the fused layer on "
      f"the card raised: {raised}")
  if not raised:
    raise AssertionError("a second derivative through the fused layer did "
                         "not raise on the card")


def collection_rollout(env, meta, params, pi_v, v, horizon):
  from vision4leg_torch.collector import rollout as rollout_lib
  gs = params["general_setting"]
  return rollout_lib.make_rollout_fn(
      env, pi_v, v, horizon=horizon,
      max_episode_frames=params["collector"]["max_episode_frames"],
      discount=gs["discount"], proprio_dim=env.cfg.proprio_dim,
      obs_norm=meta["obs_norm"], action_low=env.action_low,
      action_high=env.action_high, env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"])


def timed_rollout(env, rollout, seed, dev):
  """init_collector at NUM_ENVS envs, then the rollout with the counts set
  to 0 just before; (traj, last value, launches with the seconds)."""
  import torch
  from vision4leg_torch.collector import rollout as rollout_lib
  cs = rollout_lib.init_collector(
      env, NUM_ENVS, torch.Generator(device=dev).manual_seed(seed))
  zero_counts()
  t = time.perf_counter()
  _, traj, last_v = rollout(cs)
  torch.cuda.synchronize()
  return traj, last_v, dict(read_counts(), seconds=time.perf_counter() - t)


def fused_vs_unfused(name, cls, cfg, net, traj, last_v, perms, fused_sd,
                     result):
  """The fused update against the unfused one from the same state, as
  `phase_fused_update` holds PPO's: four minibatches of NUM_ENVS samples
  (the first four steps, in order, one opt epoch) within
  FUSED_UPDATE_BAND.  The whole epoch's difference (48 minibatches, from
  `fused_sd`) is printed beside it: float32 ReLU-kink flips compound over
  the steps there (tests/test_torch_ppo.py), so it is not gated."""
  import dataclasses

  import torch
  from vision4leg_torch.collector.rollout import Transition
  t = time.perf_counter()
  plain, _, _ = run_update(cls, cfg, net, traj, last_v, False, perms)
  torch.cuda.synchronize()
  result["unfused_seconds"] = time.perf_counter() - t
  epoch = max(float((fused_sd[k] - v).abs().max()) for k, v in plain.items())
  cfg4 = dataclasses.replace(cfg, opt_epochs=1, shuffle=False,
                             batch_size=NUM_ENVS, epoch_frames=4 * NUM_ENVS)
  traj4 = Transition(*(x[:4] for x in traj))
  before = read_counts()
  four = [run_update(cls, cfg4, net, traj4, last_v, f, [list(range(4))])[0]
          for f in (True, False)]
  set_counts(before)
  diff = max(float((four[0][k] - v).abs().max()) for k, v in four[1].items())
  init = net.state_dict()
  moved = max(float((v - init[k]).abs().max()) for k, v in four[1].items())
  log(f"[on-policy family] {name} fused vs unfused: 4 minibatches of "
      f"{NUM_ENVS} from one state, largest parameter difference {diff:.3e} "
      f"(band {FUSED_UPDATE_BAND:g}; the unfused update moved the "
      f"parameters by up to {moved:.3e}); the whole epoch's ("
      f"{cfg.opt_epochs * (traj.rewards.shape[0] // max(cfg.batch_size // NUM_ENVS, 1))}"
      f" minibatches) {epoch:.3e}, not gated; unfused epoch "
      f"{result['unfused_seconds']:.3f}s")
  if not diff <= FUSED_UPDATE_BAND:
    raise AssertionError(f"[on-policy family] {name} fused update parts "
                         f"by {diff:.3e}")
  return dict(four_minibatches=diff, four_minibatches_move=moved,
              whole_epoch=epoch)


def phase_on_policy_family(env, meta, params, card, dev):
  """Phase 32: one 16-step thin-goal rollout at NUM_ENVS envs with the
  LocoTransformer at full width (seeded weights, fused collection forward:
  rows 1 and 2), then from copies of the same weights and trajectory one
  update_per_epoch each of A2C, REINFORCE and V-MPO with the fused update
  (row 2ad) and of TRPO unfused, over the whole batch; A2C and V-MPO also
  unfused (`fused_vs_unfused`: four minibatches held to
  FUSED_UPDATE_BAND, the whole epoch printed); TRPO asked for a fused update
  raises before any launch, and a second derivative through the fused
  layer raises on the card; each learner's float64 update on the first
  F64_ENVS envs x F64_STEPS steps (batch_size their count) on the card
  against the CPU at F64_REL.  Launch counts exact."""
  import torch
  from vision4leg_torch.starter import common
  t0 = time.perf_counter()
  net = actor_critic(env, params, torch.Generator().manual_seed(32)).to(dev)
  horizon = common.ppo_config(params).epoch_frames // NUM_ENVS
  rollout = collection_rollout(env, meta, params,
                               lambda x: net.pi_v(x, fused=True),
                               lambda x: net.v(x, fused=True), horizon)
  traj, last_v, coll = timed_rollout(env, rollout, 32, dev)
  paths = {"on-policy family collection (fused)": coll}
  want = {"physics_window": horizon, "transformer_layer": 4 * horizon + 2,
          "transformer_layer_bwd": 0}
  log(f"[on-policy family] rollout {horizon} x {NUM_ENVS} in "
      f"{coll['seconds']:.3f}s on {card}; launches {coll}, expected {want}")
  if {k: coll[k] for k in want} != want:
    raise AssertionError(f"[on-policy family] collection launches {coll}")
  perms = [torch.randperm(horizon, generator=torch.Generator().manual_seed(
      e)).tolist() for e in range(10)]
  results, fused_gate = {}, {}
  for name, (cls, cfg) in on_policy_configs(params).items():
    fused = name != "TRPO"
    if not fused:
      zero_counts()
      try:
        cls(cfg, None, None, net, fused_update=True)
      except NotImplementedError as e:
        log(f"[on-policy family] TRPO asked for a fused update raised: {e}")
      else:
        raise AssertionError("TRPO took a fused update")
      if any(read_counts().values()):
        raise AssertionError("TRPO's refusal launched a kernel")
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    sd, metrics, learner = run_update(cls, cfg, net, traj, last_v, fused,
                                      perms)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts = read_counts()
    rows = max(cfg.batch_size // NUM_ENVS, 1)
    n_mb = (cfg.v_opt_times if name == "TRPO" else cfg.opt_epochs) * (
        horizon // rows)
    per_mb = {"REINFORCE": 2}.get(name, 4) * fused
    want_u = {"physics_window": 0, "transformer_layer": per_mb * n_mb,
              "transformer_layer_bwd": per_mb * n_mb}
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    init = net.state_dict()
    moved = sum(not torch.equal(v, init[k]) for k, v in sd.items())
    kind = "fused" if fused else "unfused"
    extra = (f"; accepted step fraction {learner.last_search['step_frac']}"
             f", kl_after {metrics['Training/kl_after']:.3e}"
             if name == "TRPO" else "")
    log(f"[on-policy family] {name} update_per_epoch ({kind}, {n_mb} "
        f"minibatches of {rows * NUM_ENVS}"
        + (" after the full-batch natural-gradient step"
           if name == "TRPO" else "")
        + f") over {horizon} x {NUM_ENVS} samples on {card}: {dt:.3f}s; "
        f"launches {counts}, expected {want_u}; {moved}/{len(sd)} tensors "
        f"moved; policy_loss {metrics['Training/policy_loss']:.5f}{extra}")
    if counts != want_u or bad or not moved:
      raise AssertionError(f"[on-policy family] {name}: launches {counts}, "
                           f"non-finite {bad}, moved {moved}")
    paths[f"{name} update ({kind})"] = dict(counts, seconds=dt)
    results[name] = dict(seconds=dt, minibatches=n_mb, metrics=metrics)
    if name == "TRPO":
      results[name]["step_frac"] = learner.last_search["step_frac"]
    if name in ("A2C", "V-MPO"):
      fused_gate[name] = fused_vs_unfused(name, cls, cfg, net, traj, last_v,
                                          perms, sd, results[name])
  second_derivative_raises(net, traj.obs[0, :8])
  n = F64_ENVS * F64_STEPS
  f64 = float64_card_vs_cpu("on-policy family", on_policy_configs(params, n),
                            net, traj, last_v, F64_ENVS, F64_STEPS)
  dt = time.perf_counter() - t0
  log(f"[on-policy family] phase 32 in {dt:.2f}s")
  return paths, dict(updates=results, fused_vs_unfused=fused_gate,
                     float64=f64, seconds=dt)


def phase_ppo_aux(env, meta, params, card, dev):
  """Phase 33: ImpalaFuseResidualActorCritic at the config's widths
  (`common.nature_kwargs`: encoder (256, 256), visual_dim 256, heads (256,
  256)) on thin-goal's observation layout, seeded weights; one 16-step
  rollout at NUM_ENVS envs (row 1 once a step; the model has no
  transformer layer), one PPO-aux epoch at the config's opt_epochs and
  aux_coeff 1.0 over the whole batch; the float64 update on the first
  F64_ENVS envs x F64_AUX_STEPS steps on the card against the CPU."""
  import dataclasses

  import torch
  from vision4leg_torch.algo import ppo_aux
  from vision4leg_torch.models.actor_critic import \
      ImpalaFuseResidualActorCritic
  from vision4leg_torch.starter import common
  t0 = time.perf_counter()
  net = ImpalaFuseResidualActorCritic(
      **common.nature_kwargs(env, params),
      generator=torch.Generator().manual_seed(33)).to(dev)
  base = common.ppo_config(params)
  cfg = ppo_aux.PPOAuxConfig(**dataclasses.asdict(base), aux_coeff=1.0)
  horizon = base.epoch_frames // NUM_ENVS
  rollout = collection_rollout(env, meta, params,
                               lambda x: (net.pi(x), net.v(x)), net.v,
                               horizon)
  traj, last_v, coll = timed_rollout(env, rollout, 33, dev)
  zero_counts()
  t = time.perf_counter()
  sd, metrics, _ = run_update(ppo_aux.PPOAuxLearner, cfg, net, traj, last_v,
                              None, [list(range(horizon))] * cfg.opt_epochs,
                              pi_aux=True)
  torch.cuda.synchronize()
  upd = dict(read_counts(), seconds=time.perf_counter() - t)
  paths = {"PPO-aux (Impala) collection": coll, "PPO-aux update": upd}
  rows = max(cfg.batch_size // NUM_ENVS, 1)
  n_mb = cfg.opt_epochs * (horizon // rows)
  bad = [k for k, v in metrics.items() if not math.isfinite(v)]
  init = net.state_dict()
  moved = sum(not torch.equal(v, init[k]) for k, v in sd.items())
  log(f"[PPO-aux] rollout {horizon} x {NUM_ENVS} in {coll['seconds']:.3f}s"
      f", update ({n_mb} minibatches of {rows * NUM_ENVS}) in "
      f"{upd['seconds']:.3f}s on {card}; launches {paths}; aux_loss "
      f"{metrics['Training/aux_loss']:.5f}, {moved}/{len(sd)} tensors moved")
  want = {"physics_window": horizon, "transformer_layer": 0,
          "transformer_layer_bwd": 0}
  if ({k: coll[k] for k in want} != want or any(
      upd[k] for k in want) or bad or moved != len(sd)):
    raise AssertionError(f"[PPO-aux] launches {paths}, non-finite {bad}, "
                         f"moved {moved}")
  n = F64_ENVS * F64_AUX_STEPS
  f64 = float64_card_vs_cpu(
      "PPO-aux", {"PPO-aux": (ppo_aux.PPOAuxLearner, dataclasses.replace(
          cfg, batch_size=n, epoch_frames=n))}, net, traj, last_v,
      F64_ENVS, F64_AUX_STEPS, pi_aux=True)
  dt = time.perf_counter() - t0
  log(f"[PPO-aux] phase 33 in {dt:.2f}s")
  return paths, dict(collect_s=coll["seconds"], update_s=upd["seconds"],
                     minibatches=n_mb, metrics=metrics, float64=f64,
                     seconds=dt)


def det_acting(m, obs, sigma=0.1):
  """A deterministic tanh policy in the agent's Gaussian acting interface:
  tanh(atanh(a) + sigma n), TD3's additive exploration noise
  (tests/test_off_policy_learning.py)."""
  import torch
  a = torch.clamp(m(obs), -0.999, 0.999)
  return torch.atanh(a), torch.full_like(a, sigma), None


def off_policy_learners(obs_dim, act_dim, gen):
  """{name: (learner, its state's networks on the CPU, acting function)}
  of TwinSACQ, TD3, DDPG and SAC at (256, 256) with the OffPolicyConfig
  defaults; SAC's V(s) is a one-output MLP."""
  from vision4leg_torch.algo.off_policy import learners as ol
  from vision4leg_torch.models import off_policy_nets as nets
  cfg = ol.OffPolicyConfig()
  pf = lambda: nets.TanhGaussianPolicy(obs_dim, act_dim, generator=gen)
  det = lambda: nets.DetTanhPolicy(obs_dim, act_dim, generator=gen)
  q = lambda: nets.QNet(obs_dim, act_dim, generator=gen)
  v = lambda: nets.DiscreteQNet(obs_dim, 1, generator=gen)
  gauss = lambda m, o: m(o)
  apply_q = lambda m, o, a: m(o, a)
  return {
      "TwinSACQ": (ol.TwinSACQLearner(cfg, gauss, apply_q, act_dim),
                   (pf(), q(), q()), gauss),
      "TD3": (ol.TD3Learner(cfg, gauss, apply_q), (det(), q(), q()),
              det_acting),
      "DDPG": (ol.DDPGLearner(cfg, gauss, apply_q), (det(), q()),
               det_acting),
      "SAC": (ol.SACLearner(cfg, gauss, apply_q, gauss, act_dim),
              (pf(), q(), v()), gauss)}


def copy_state(learner, state, dev, dtype):
  """A fresh state of `learner` (its Adam states at init) on copies of the
  networks and targets of `state`, on dev in dtype."""
  import copy
  nets = [copy.deepcopy(m).to(dev, dtype) for m in state.params.values()]
  out = learner.init_state(*nets)
  for k, m in out.target_params.items():
    m.load_state_dict(state.target_params[k].state_dict())
  return out


def off_policy_float64(learner, state, batch, draws, label):
  """One update from `batch` with `draws` in float64 on the card and on
  the CPU, from copies of `state`'s networks: the largest relative
  difference over every network, target and metric, held to
  OFF_F64_REL."""
  import torch
  got = {}
  for dev in (CARD_DEVICE, "cpu"):
    st = copy_state(learner, state, dev, torch.float64)
    b = {k: (v.to(dev, torch.float64) if v.is_floating_point()
             else v.to(dev)) for k, v in batch.items()}
    d = None if draws is None else {k: v.to(dev, torch.float64)
                                    for k, v in draws.items()}
    st, metrics = learner.update(st, b, draws=d)
    flat = {f"{side}.{n}.{k}": v for side, nets in (
        ("params", st.params), ("targets", st.target_params))
        for n, m in nets.items() for k, v in m.state_dict().items()}
    got[dev] = (flat, {k: float(v) for k, v in metrics.items()})
  err = rel_diff(got[CARD_DEVICE][0], got["cpu"][0])
  m_err = max(abs(got[CARD_DEVICE][1][k] - v) / max(abs(v), 1e-300)
              for k, v in got["cpu"][1].items())
  log(f"[off-policy] {label} one float64 update on the card vs the CPU: "
      f"largest difference {err:.3e} of the largest parameter (networks "
      f"and targets), metrics {m_err:.3e} relative (gate "
      f"{OFF_F64_REL:g})")
  if not (err <= OFF_F64_REL and m_err <= OFF_F64_REL):
    raise AssertionError(f"[off-policy] {label} float64 card/CPU update "
                         f"parts by {err:.3e} / {m_err:.3e}")
  return dict(rel=err, metric_rel=m_err)


def phase_off_policy(card, dev):
  """Phase 34: state-only-baseline.json's env at NUM_ENVS envs with its
  terrain_type changed to thin-goal's random_blocks_sparse_with_subgoal
  (so that the window kernel carries every step), an OffPolicyAgent with
  a 2**20-transition replay on the card for each of TwinSACQ, TD3, DDPG
  and SAC at (256, 256) (the OffPolicyConfig defaults, batch 256):
  pretrain OFF_POLICY_STEPS steps, then train_epoch of OFF_POLICY_STEPS x
  NUM_ENVS frames, one update a step; the replay's size and update_count
  exact, row 1 once a step; each learner's single update from one replay
  sample with injected draws in float64 on the card against the CPU
  (OFF_F64_REL); the DQN learner in its three modes, one update each on
  seeded batches of the obs width at batch 256, the same gate."""
  import torch
  from vision4leg_torch.algo.off_policy import learners as ol
  from vision4leg_torch.algo.off_policy.agent import OffPolicyAgent
  from vision4leg_torch.data import replay as replay_lib
  from vision4leg_torch.models import off_policy_nets as nets
  t0 = time.perf_counter()
  env, _, _ = build_env(STATE_CONFIG, dev, OFF_POLICY_OVERRIDES)
  if not env.kernel_capable:
    raise AssertionError("[off-policy] the env does not take the window")
  obs_dim, act_dim = env.obs_dim, env.cfg.action_dim
  frames = OFF_POLICY_STEPS * NUM_ENVS
  paths, out = {}, {}
  gen = torch.Generator().manual_seed(34)
  for name, (learner, cpu_nets, acting) in off_policy_learners(
      obs_dim, act_dim, gen).items():
    state = learner.init_state(*[m.to(dev) for m in cpu_nets])
    agent = OffPolicyAgent(env=env, learner=learner, learner_state=state,
                           apply_pf=acting, num_envs=NUM_ENVS,
                           replay_capacity=REPLAY_CAPACITY, seed=34,
                           pretrain_frames=frames, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    agent.pretrain()
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t
    size_p = agent.replay.size
    t = time.perf_counter()
    avg_rew, infos = agent.train_epoch(frames)
    torch.cuda.synchronize()
    dt_e = time.perf_counter() - t
    counts = read_counts()
    paths[f"off-policy {name} pretrain + epoch"] = dict(
        counts, seconds=dt_p + dt_e)
    count = agent.learner_state.update_count
    bad = [k for k, v in infos.items() if not math.isfinite(v)]
    log(f"[off-policy] {name}: pretrain {OFF_POLICY_STEPS} steps x "
        f"{NUM_ENVS} envs in {dt_p:.3f}s, train_epoch({frames}) in "
        f"{dt_e:.3f}s ({frames / dt_e:.1f} env-steps/s, one update of "
        f"{learner.cfg.batch_size} a step) on {card}; replay size "
        f"{size_p} then {agent.replay.size} of {REPLAY_CAPACITY}, "
        f"update_count {count}; launches {counts}; mean reward "
        f"{avg_rew:.4f}; metrics {json.dumps(infos)}")
    if (size_p != frames or agent.replay.size != 2 * frames
        or count != OFF_POLICY_STEPS or bad or not math.isfinite(avg_rew)
        or counts != {"physics_window": 2 * OFF_POLICY_STEPS,
                      "transformer_layer": 0, "transformer_layer_bwd": 0}):
      raise AssertionError(f"[off-policy] {name} epoch check failed")
    g = torch.Generator().manual_seed(35)
    B = learner.cfg.batch_size
    idx = torch.randint(0, agent.replay.size, (B,), generator=g)
    batch = replay_lib.sample(agent.replay, B, idx=idx.to(dev))
    draws = {k: torch.randn(B, act_dim, generator=g, dtype=torch.float64)
             for k in ("noise", "next_noise")}
    out[name] = dict(pretrain_s=dt_p, epoch_s=dt_e, replay_size=size_p,
                     update_count=count, avg_reward=avg_rew,
                     float64=off_policy_float64(
                         learner, agent.learner_state, batch, draws, name))
    del agent, state, batch
    torch.cuda.empty_cache()
  cfg = ol.OffPolicyConfig()
  B = cfg.batch_size
  g = torch.Generator().manual_seed(36)
  batch = {"obs": torch.randn(B, obs_dim, generator=g),
           "acts": torch.randint(0, DQN_ACTIONS, (B,), generator=g),
           "next_obs": torch.randn(B, obs_dim, generator=g),
           "rewards": torch.randn(B, 1, generator=g),
           "terminals": (torch.rand(B, 1, generator=g) < 0.1).float()}
  for mode, net in (
      ("dqn", nets.DiscreteQNet(obs_dim, DQN_ACTIONS, generator=g)),
      ("qrdqn", nets.DiscreteQNet(obs_dim, DQN_ACTIONS,
                                  num_quantiles=cfg.num_quantiles,
                                  generator=g)),
      ("bootstrapped", nets.BootstrappedQNet(obs_dim, DQN_ACTIONS,
                                             cfg.num_heads, generator=g))):
    learner = ol.DQNLearner(cfg, lambda m, o: m(o), mode=mode)
    b = dict(batch)
    if mode == "bootstrapped":
      b["masks"] = (torch.rand(B, cfg.num_heads, generator=g) < 0.5).float()
    out[f"DQN {mode}"] = dict(float64=off_policy_float64(
        learner, learner.init_state(net), b, None, f"DQN ({mode})"))
  dt = time.perf_counter() - t0
  log(f"[off-policy] phase 34 in {dt:.2f}s")
  out["seconds"] = dt
  return paths, out


def phase_hierarchical(card, dev):
  """Phase 35: phase 34's env at NUM_ENVS envs, a frozen low-level
  StateActorCritic at (256, 256) on [cos, sin, proprio] and a high level
  at (256, 256) on the full observation (seeded weights); one 16-step
  hierarchical rollout (row 1 once a step), the stored actions 1-dim; one
  PPO epoch on the high level (state-only-baseline.json's ppo section);
  the act_fn on the card against a CPU copy on the same observations and
  noise within HIER_ACT_TOL."""
  import copy

  import torch
  from vision4leg_torch.algo.ppo import PPOLearner
  from vision4leg_torch.collector import hierarchical
  from vision4leg_torch.models.actor_critic import StateActorCritic
  from vision4leg_torch.starter import common
  t0 = time.perf_counter()
  env, meta, params = build_env(STATE_CONFIG, dev, OFF_POLICY_OVERRIDES)
  proprio = env.cfg.proprio_dim
  g = torch.Generator().manual_seed(35)
  W = dict(hidden_shapes=(256, 256), append_hidden_shapes=(256, 256))
  low = StateActorCritic(env.cfg.action_dim, proprio + 2, **W,
                         generator=g).to(dev).eval()
  high = StateActorCritic(1, env.obs_dim, **W, generator=g).to(dev)
  cfg = common.ppo_config(params)
  horizon = cfg.epoch_frames // NUM_ENVS
  rollout = hierarchical.make_hierarchical_rollout_fn(
      env, high.pi, high.v, low.pi, horizon=horizon,
      max_episode_frames=params["collector"]["max_episode_frames"],
      discount=params["general_setting"]["discount"], proprio_dim=proprio,
      obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"])
  low0 = {k: v.clone() for k, v in low.state_dict().items()}
  traj, last_v, coll = timed_rollout(env, rollout, 35, dev)
  paths = {"hierarchical collection": coll}
  learner = PPOLearner(cfg, lambda m, x: m.pi(x), lambda m, x: m.v(x), high)
  h0 = {k: v.clone() for k, v in high.state_dict().items()}
  t = time.perf_counter()
  _, metrics = learner.update_per_epoch(
      learner.init_state(high), traj, last_v,
      gen=torch.Generator(device=dev).manual_seed(35))
  torch.cuda.synchronize()
  dt_u = time.perf_counter() - t
  metrics = {k: float(v) for k, v in metrics.items()}
  moved = sum(not torch.equal(v, h0[k]) for k, v in high.state_dict().items())
  # the act path on the card against a CPU copy, same obs and noise
  act = hierarchical.make_hierarchical_act_fn(
      high.pi, low.pi, proprio, env.action_low, env.action_high)
  chigh, clow = copy.deepcopy(high).cpu(), copy.deepcopy(low).cpu()
  cact = hierarchical.make_hierarchical_act_fn(
      chigh.pi, clow.pi, proprio, env.action_low.cpu(),
      env.action_high.cpu())
  noise = torch.randn(NUM_ENVS, 1,
                      generator=torch.Generator().manual_seed(36))
  with torch.no_grad():
    a = act(traj.obs[-1], None, noise=noise.to(dev))
    b = cact(traj.obs[-1].cpu(), None, noise=noise)
  act_err = max(float((x.cpu() - y).abs().max()) for x, y in zip(a, b))
  log(f"[hierarchical] rollout {horizon} x {NUM_ENVS} in "
      f"{coll['seconds']:.3f}s, PPO epoch on the high level in {dt_u:.3f}s "
      f"on {card}; launches {coll}; stored actions "
      f"{tuple(traj.acts.shape)}; act_fn card vs CPU {act_err:.3e} (tol "
      f"{HIER_ACT_TOL:g}); high level {moved}/{len(h0)} tensors moved; "
      f"policy_loss {metrics['Training/policy_loss']:.5f}")
  want = {"physics_window": horizon, "transformer_layer": 0,
          "transformer_layer_bwd": 0}
  if ({k: coll[k] for k in want} != want
      or traj.acts.shape != (horizon, NUM_ENVS, 1)
      or not act_err <= HIER_ACT_TOL or not moved
      or any(not torch.equal(v, low0[k]) for k, v in low.state_dict().items())
      or not all(math.isfinite(v) for v in metrics.values())):
    raise AssertionError("[hierarchical] check failed")
  dt = time.perf_counter() - t0
  log(f"[hierarchical] phase 35 in {dt:.2f}s")
  return paths, dict(collect_s=coll["seconds"], update_s=dt_u,
                     act_err=act_err, metrics=metrics, seconds=dt)


DEPLOY_RUN = "runs/thin_goal_10M/A1MoveGround/0"
DEPLOY_ID = "thin_goal_10M"
DEPLOY_SECONDS = 2.0   # phase 36's policy seconds at 25 Hz
DEPLOY_MIN_TICKS = 25  # half of its 50 ticks: the loop keeps its pace
# the deploy policy's actions on the card against the CPU's plain path on
# the same observations: the gate of phase 1's pi_v card/CPU probe (the
# layer kernel's 3xTF32 products and the card's float32 convolutions
# against the CPU's float32, ~1e-6 on a mean of O(1))
DEPLOY_ACT_TOL = 1e-4
RANK_ENVS = NUM_ENVS // 2   # phase 37: two gloo ranks sharing the card
# their initial observations against one rank's: the same draws and the
# same per-env arithmetic; 1e-4 allows the card's batched products to
# round differently at 512 and 1024 envs on depths of up to 10 m
RANK_OBS_TOL = 1e-4
# phase 37's episode cap: from staggered episode counters, envs reach it
# at different steps and in unequal numbers on each rank (`gated_epoch`)
RANK_MAX_EP = 8
# the ranks against one rank, |a - b| <= tol (1 + |b|): the log-probs
# (the action draws) of every step and
# RANK_GATED_FIELDS over the first RANK_GATED_STEPS steps.  The ranks'
# normalizer merges its moments in float64 where one rank sums them in
# float32 (~1e-7 relative), which moves the normalized observations, the
# actions and the physics a little (on the card, 2 x 512 against 1024:
# ~6e-7 on these fields); tests/test_torch_parallel.py holds 4 steps on
# the CPU at 1e-4.  The rewards and the proprio observations are printed,
# not gated: a contact that flips on a 6e-7 change of the action moves a
# reward by ~2e-3 at the first step, and the normalizer's 1 / (std +
# 1e-4) turns the rounding of a mean into ~1e-3 on a term that is the
# same in every env
RANK_TRAJ_TOL = 1e-4
RANK_GATED_STEPS = 2
# the first step's normalizer, merged over the ranks, against one rank's
# on the same initial observations: float64 moments against float32 sums
# over 1024 rows, which carry up to ~log2(1024) 2^-24 ~ 6e-7 of rounding
# (on the card, 2 x 512 against 1024: 2.9e-7)
RANK_NORM_TOL = 1e-5
RANK_GATED_FIELDS = ("acts", "means", "stds", "values", "log_probs",
                     "image_obs_mean")


def percentiles(xs):
  import numpy as np
  a = np.asarray(xs) * 1e3
  return dict(median_ms=float(np.median(a)), p99_ms=float(np.percentile(
      a, 99)), max_ms=float(a.max()), n=int(a.size))


def layer_kernel_ms(x, w, n=25, warm=3):
  """Milliseconds per launch of the layer's forward kernel alone at x's
  shape: `attention._launch` checks and allocates once, and its launch
  runs the kernel warm + n times back to back, the last n between CUDA
  events (at B = 1 the wrapper's checks take longer than the kernel, so
  `time_ms` of the call times the host).  The launch count is left as it
  was."""
  import torch
  from vision4leg_torch.ops import attention as att
  fn = att.build_library().transformer_layer_launch
  out = {}

  def launch(*a):
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(warm):
      fn(*a, stream)
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    errs = [fn(*a, stream) for _ in range(n)]
    e.record()
    e.synchronize()
    out["ms"] = s.elapsed_time(e) / n
    return max(errs, key=abs)

  before = att.fused_transformer_layer.launches
  att._launch(x, w, launch=launch)
  att.fused_transformer_layer.launches = before
  return out["ms"]


def phase_deploy(card, dev):
  """The deploy stack on the card (vision4leg_torch/hardware/
  execute_locotransformer.py --fake-robot) over a policy the JAX package
  trained (DEPLOY_RUN, read without JAX): stand, warmup, DEPLOY_SECONDS
  of policy at 25 Hz, sit, on the loopback robot; the counts set to 0
  just before and read just after (the layer kernel at (1, 17) twice a
  tick, nothing else); every recorded observation's action on the card
  against the CPU's plain path within DEPLOY_ACT_TOL; row 2 at (1, 17)
  and (3, 17) by `check_layer_case` on those observations' tokens and
  on three seeded observations' (samples that differ everywhere), and
  timed at (1, 17) against its plain version and the library layer (and
  the kernel alone, `layer_kernel_ms`); the tick's and the forward's
  latency."""
  import numpy as np
  import torch
  from vision4leg_torch.hardware import execute_locotransformer as deploy
  from vision4leg_torch.hardware.export import load_actor_critic
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.utils.args import get_params
  with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as tmp:
    work = copy_run(tmp, DEPLOY_RUN, DEPLOY_ID)
    argv = ["--config", os.path.join(work, "params.json"), "--log_dir", tmp,
            "--id", DEPLOY_ID, "--seed", "0", "--fake-robot", "--seconds",
            str(DEPLOY_SECONDS), "--device", str(dev)]
    t = time.perf_counter()
    ex = deploy.build_executor(deploy.parse_args(argv))
    build_s = time.perf_counter() - t
    forward, ticks, record = [], [], []
    fn, step = ex.policy.policy_fn, ex.control_step

    def timed_policy(obs):
      t0 = time.perf_counter()
      act = fn(obs)
      forward.append(time.perf_counter() - t0)
      record.append((obs, act))
      return act

    def timed_step():
      t0 = time.perf_counter()
      out = step()
      ticks.append(time.perf_counter() - t0)
      return out

    ex.policy.policy_fn, ex.control_step = timed_policy, timed_step
    zero_counts()
    t = time.perf_counter()
    ex.execute(DEPLOY_SECONDS)
    run_s = time.perf_counter() - t
    counts = read_counts()
    params = get_params(os.path.join(work, "params.json"))
    cpu = load_actor_critic(params, work, "best", "cpu")
    card_net = load_actor_critic(params, work, "best", dev)
  n_layers = len(cpu.pf_layers)
  want = {"physics_window": 0, "transformer_layer": n_layers * len(record),
          "transformer_layer_bwd": 0}
  log(f"[deploy] execute_locotransformer --fake-robot on {card}: built in "
      f"{build_s:.2f}s, ran {run_s:.2f}s (stand 2 s, warmup 20 ticks, "
      f"{DEPLOY_SECONDS} s of policy, sit 2 s): {len(record)} policy "
      f"ticks; launches {counts}, expected {want}")
  if counts != want or len(record) < DEPLOY_MIN_TICKS:
    raise AssertionError(f"[deploy] launches {counts} != {want} or only "
                         f"{len(record)} ticks")
  obs = np.stack([o for o, _ in record])
  acts = np.stack([a for _, a in record])
  with torch.no_grad():
    ref = cpu.pi(torch.from_numpy(obs), fused=False)[0].numpy()
  act_err = float(np.abs(acts - ref).max())
  log(f"[deploy] card actions vs the CPU plain path on the {len(obs)} "
      f"recorded observations: max abs err {act_err:.3e} (gate "
      f"{DEPLOY_ACT_TOL:g}); actions in [{acts.min():.3f}, "
      f"{acts.max():.3f}]")
  if not (np.isfinite(acts).all() and act_err < DEPLOY_ACT_TOL):
    raise AssertionError(f"[deploy] card/CPU action mismatch {act_err}")
  gen = torch.Generator(device=dev).manual_seed(36)
  err, b_err = 0.0, 0.0
  # the recorded ticks differ only through the last-action history (the
  # loopback robot stands still and its camera sees a constant depth), so
  # the partial tiles are held on seeded observations as well, whose
  # samples differ everywhere: a kernel that mixes up a tile's samples
  # fails there
  seeded = np.random.default_rng(36).normal(
      0.0, 1.0, (3, obs.shape[1])).astype(np.float32)
  with torch.no_grad():
    w0 = att.LayerWeights(*[t.detach() for t in
                            att.weights_from_layer(card_net.pf_layers[0])])
    w1 = att.LayerWeights(*[t.detach() for t in
                            att.weights_from_layer(card_net.pf_layers[1])])
    cases = []
    for what, o in (("deploy", obs[:3]), ("seeded", seeded)):
      tokens = card_net._tokens(torch.from_numpy(o).to(dev))
      cases += [(f"{what} tokens->pf_layers.0", tokens, w0),
                (f"{what} layer-1 out->pf_layers.1",
                 att.layer_math(tokens, w0), w1)]
    tokens = cases[0][1]
  x = cases[2][1]
  spread = float((x[1:] - x[:1]).abs().amax(dim=(1, 2)).min())
  log(f"[deploy] the seeded samples' tokens part from the first by at "
      f"least {spread:.3e} (max abs over a sample)")
  if not spread > 0.1:
    raise AssertionError(f"[deploy] the seeded samples are too alike "
                         f"({spread})")
  for B in (1, 3):
    for name, x, w in cases:
      e, b = check_layer_case(name, x[:B].contiguous(), w, gen)
      err, b_err = max(err, e), max(b_err, b)
  timed = time_layer_shape(tokens[:1].contiguous(), w0, library_layer(w0),
                           gen, card)
  timed["kernel_alone_ms"] = layer_kernel_ms(tokens[:1].contiguous(), w0)
  log(f"[deploy] the forward kernel alone at (1, 17) on {card}: "
      f"{timed['kernel_alone_ms']:.4f} ms a launch (25 back to back; the "
      f"wrapper's call {timed['ms']:.4f} ms)")
  set_counts({k: 0 for k in counts})
  lat = dict(tick=percentiles(ticks), forward=percentiles(forward))
  log(f"[deploy] latency on {card}: tick (observe, wrapper, forward, "
      f"command) median {lat['tick']['median_ms']:.3f} ms, p99 "
      f"{lat['tick']['p99_ms']:.3f} ms; forward (obs to the card, pi with "
      f"the fused layer, mean back) median "
      f"{lat['forward']['median_ms']:.3f} ms, p99 "
      f"{lat['forward']['p99_ms']:.3f} ms over {len(forward)} ticks")
  return counts, dict(ticks=len(record), action_max_abs_err=act_err,
                      layer_max_abs_err=err, layer_bwd_max_abs_err=b_err,
                      latency=lat, layer_1x17=timed, run_s=run_s)


def rank_update_check(net, obs, params, mesh=None, seed=0):
  """Four PPO minibatches (fused layer on) from `net`'s state on obs (4,
  B, D), this rank's B of the global batch (world x B) under a sharded
  `mesh`: actions drawn from the policy, behaviour log-probs moved off
  it, seeded rewards, every draw the global draw's rows for the rank, as
  `fused_update_check` draws them; returns the updated state_dict."""
  import copy
  import dataclasses

  import torch
  from vision4leg_torch.algo.on_policy_base import normal_log_prob
  from vision4leg_torch.algo.ppo import PPOLearner
  from vision4leg_torch.collector.rollout import Transition
  from vision4leg_torch.starter import common
  from vision4leg_torch.parallel.mesh import ONE
  mesh = ONE if mesh is None else mesh
  T, B = obs.shape[:2]
  world, rank = mesh.world, mesh.rank
  dev = obs.device
  cfg = dataclasses.replace(common.ppo_config(params), batch_size=B * world,
                            epoch_frames=T * B * world, opt_epochs=1,
                            shuffle=False)
  gen = torch.Generator(device=dev).manual_seed(seed)
  cols = slice(rank * B, (rank + 1) * B)
  rnd = lambda *s: torch.randn(T, B * world, *s, generator=gen,
                               device=dev)[:, cols]
  with torch.no_grad():
    (mean, std, _), value = net.pi_v(obs.reshape(T * B, -1), fused=True)
  split = lambda x: x.reshape(T, B, -1)
  mean, std, value = split(mean), split(std), split(value)
  acts = mean + std * rnd(mean.shape[-1])
  logp = normal_log_prob(mean, std, acts) + 0.3 * (2 * torch.rand(
      T, B * world, 1, generator=gen, device=dev)[:, cols] - 1)
  no = torch.zeros(T, B, 1, dtype=torch.bool, device=dev)
  traj = Transition(obs=obs, acts=acts, log_probs=logp, values=value,
                    rewards=0.1 * rnd(1), terminals=no, time_limits=no,
                    means=mean, stds=std)
  m = copy.deepcopy(net).train()
  learner = PPOLearner(cfg, lambda mm, x: mm.pi(x, fused=True),
                       lambda mm, x: mm.v(x, fused=True), m, mesh)
  learner.update_per_epoch(learner.init_state(m), traj,
                           torch.zeros(B, device=dev),
                           perms=[list(range(T))])
  return {k: v.detach().cpu() for k, v in m.state_dict().items()}


def thin_goal_agent(dev, num_envs, mesh=None, logger=None, save_dir=None):
  """A PPOAgent of thin-goal from the starter's pieces at num_envs envs,
  fused layer on in collection and update, seed 0; under `mesh` its
  rank's share."""
  from vision4leg_torch.algo.agent import PPOAgent
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  env, meta, params = build_env(CONFIG, dev)
  agent = PPOAgent(
      env=env, ac_module=starter.build_module(env, params),
      cfg=common.ppo_config(params, num_epochs=1), num_envs=num_envs,
      seed=0, logger=logger, save_dir=save_dir, eval_interval=1,
      num_eval_envs=common.num_eval_envs(params),
      obs_norm=meta["obs_norm"], env_time_limit=meta["horizon"],
      reward_scale=meta["reward_scale"], fused_attention=True,
      fused_update=True, mesh=mesh, device=dev)
  return agent, params


TRAJ_FIELDS = ("acts", "log_probs", "values", "rewards", "means", "stds",
               "terminals", "time_limits")


def gated_epoch(agent):
  """One train_epoch with episodes capped at RANK_MAX_EP, from episode
  counters staggered over the global env index (env i of E at
  floor(RANK_MAX_EP frac(4 (i / E)^2)); a rank sets its rows), so that
  at each step envs of every rank reach the cap, in unequal numbers on
  each: the epoch's partial resets cut the global reset draw at uneven,
  nonzero offsets.
  Returns (metrics, the trajectory's digest on the host: its fields, the
  proprio observations, each image's mean, for each step the raw
  observations of the envs its partial reset made (`reset_from`'s, in
  env order), and the normalizer (mean, var, count) that the rollout's
  first step makes (merged over the ranks); the steps at which some env
  of the agent reached the cap, each of which bootstraps its value with
  one more `v`)."""
  import torch
  from vision4leg_torch.data import normalizer as norm
  cs, env = agent.collector_state, agent.env
  E, p = agent.num_envs, env.cfg.proprio_dim
  i = torch.arange(E, device=cs.ep_steps.device)[agent.mesh.env_slice(E)]
  ep = (RANK_MAX_EP * (4 * (i.double() / E) ** 2).frac()).floor().to(
      torch.int32)
  agent.collector_state = cs.replace(ep_steps=ep)
  kept, made, rollout, reset_from = {}, [], agent.rollout, env.reset_from
  merged, update = [], norm.update

  def keep(*a):
    kept["out"] = out = rollout(*a)
    return out

  def record(n, draws):
    out = reset_from(n, draws)
    made.append(out[1].cpu())
    return out

  def record_update(*a):
    merged.append(update(*a))
    return merged[-1]

  agent.rollout, env.reset_from, norm.update = keep, record, record_update
  try:
    metrics = agent.train_epoch(RANK_MAX_EP)
  finally:
    agent.rollout, env.reset_from, norm.update = rollout, reset_from, update
  traj = kept["out"][1]
  digest = {k: getattr(traj, k).cpu() for k in TRAJ_FIELDS}
  digest["proprio_obs"] = traj.obs[..., :p].cpu()
  digest["image_obs_mean"] = traj.obs[..., p:].double().mean(-1).cpu()
  capped, ep, reset_obs = 0, ep.cpu(), []
  for t in range(traj.terminals.shape[0]):
    ep = ep + 1
    capped += bool((ep >= RANK_MAX_EP).any())
    ends = digest["terminals"][t, :, 0]
    # reset_from runs at a step where some env of this agent ended
    reset_obs.append(made.pop(0) if bool(ends.any())
                     else torch.zeros(0, traj.obs.shape[-1]))
    ep = torch.where(ends, 0, ep)
  digest["reset_obs"] = reset_obs
  digest["normalizer1"] = [x.cpu() for x in (merged[0].mean, merged[0].var,
                                             merged[0].count)]
  return metrics, digest, capped


def epoch_on_rank(mesh, save_dir):
  """A rank of phase 37's 2 x RANK_ENVS run on the shared card: one
  thin-goal `gated_epoch` with the counts at 0 just before and read just
  after, then `rank_update_check` on its share of the initial
  observations."""
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  pk.build_library()
  att.build_library()
  agent, params = thin_goal_agent(mesh.device, NUM_ENVS, mesh,
                                  save_dir=save_dir)
  cs = agent.collector_state
  obs0 = first_obs(agent)
  init = {k: v.clone() for k, v in agent.module.state_dict().items()}
  zero_counts()
  torch.cuda.synchronize()
  t = time.perf_counter()
  metrics, traj, capped = gated_epoch(agent)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t
  counts = read_counts()
  after = {k: v.cpu() for k, v in agent.module.state_dict().items()}
  agent.module.load_state_dict(init)
  checked = rank_update_check(agent.module, obs0.expand(4, *obs0.shape),
                              params, mesh)
  return dict(counts=counts, seconds=seconds, phases=agent.phase_seconds,
              metrics={k: float(v) for k, v in metrics.items()},
              params=after, raw_obs0=cs.raw_obs.cpu(),
              update_check=checked, traj=traj, capped=capped)


def first_obs(agent):
  """The initial collector's observations under the initial normalizer
  (the same elementwise map on every rank and on one)."""
  from vision4leg_torch.data import normalizer as norm
  cs = agent.collector_state
  return norm.filt_with_img_tail(cs.normalizer, cs.raw_obs,
                                 agent.env.cfg.proprio_dim)


def max_diff(a, b):
  return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def phase_ranks(card, dev):
  """Env-axis data parallelism on the card (parallel/mesh.py): (a) a
  world-1 NCCL thin-goal epoch against the unranked agent's from the
  same seed, bit for bit (cuDNN held deterministic for both); (b) two
  gloo ranks sharing the card at 2 x RANK_ENVS envs (`epoch_on_rank`,
  started before (a), which runs while they reach the card, so that
  their epochs share the card with it too), held against the unranked
  agent by `check_ranks_against_one`.  Every epoch is a `gated_epoch`
  (partial resets at unequal counts a rank)."""
  import torch
  from vision4leg_torch.algo.agent import _flatten
  from vision4leg_torch.parallel import mesh as mesh_lib
  det = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
      # the two ranks start (~15 s to reach the card) while (a) runs
      t = time.perf_counter()
      pending = mesh_lib.start_ranks(epoch_on_rank, 2, (tmp,),
                                     backend="gloo", device=str(dev),
                                     timeout_s=400)
      mesh = mesh_lib.init_rank(0, 1, mesh_lib.free_port(), "nccl", dev)
      try:
        ranked, params = thin_goal_agent(dev, NUM_ENVS, mesh, save_dir=tmp)
        zero_counts()
        t1 = time.perf_counter()
        gated_epoch(ranked)
        torch.cuda.synchronize()
        world1_s = time.perf_counter() - t1
        world1_counts = read_counts()
        ranked.save_checkpoint(0)
      finally:
        mesh_lib.shutdown()
      plain, _ = thin_goal_agent(dev, NUM_ENVS, save_dir=tmp)
      init = {k: v.clone() for k, v in plain.module.state_dict().items()}
      obs0 = first_obs(plain)
      raw0 = plain.collector_state.raw_obs.cpu()
      _, plain_traj, _ = gated_epoch(plain)
      torch.cuda.synchronize()
      a = {f"module.{k}": v for k, v in ranked.module.state_dict().items()}
      a.update(_flatten(ranked.collector_state, "cs", {}))
      b = {f"module.{k}": v for k, v in plain.module.state_dict().items()}
      b.update(_flatten(plain.collector_state, "cs", {}))
      differ = [k for k in a if not torch.equal(a[k], b[k])]
      log(f"[ranks] world-1 NCCL thin-goal epoch at {NUM_ENVS} envs on "
          f"{card}: {world1_s:.2f}s, launches {world1_counts}; against the "
          f"unranked agent's epoch: {len(a) - len(differ)} of {len(a)} "
          f"tensors (parameters, collector) the same bits"
          + (f"; differing {differ[:6]} by up to "
             f"{max_diff({k: a[k] for k in differ}, b):.3e}"
             if differ else ""))
      if differ:
        raise AssertionError(f"[ranks] the world-1 NCCL epoch parts from "
                             f"the unranked one: {differ[:6]}")
      plain_after = {k: v.cpu() for k, v in plain.module.state_dict().items()}
      del ranked, a, b
      torch.cuda.empty_cache()
      ranks = mesh_lib.join_ranks(pending)
      ranks_s = time.perf_counter() - t
    plain.module.load_state_dict(init)
    single = rank_update_check(plain.module, obs0.expand(4, *obs0.shape),
                               params)
  finally:
    torch.backends.cudnn.deterministic = det
  checked = check_ranks_against_one(ranks, plain, raw0, single,
                                    plain_after, plain_traj, "gloo", card)
  log(f"[ranks] the ranks started and joined in {ranks_s:.2f}s")
  by_path = {"world-1 NCCL thin-goal epoch": world1_counts}
  by_path.update({f"2-rank gloo thin-goal epoch, rank {r}": o["counts"]
                  for r, o in enumerate(ranks)})
  return by_path, dict(world1_epoch_s=world1_s, ranks_wall_s=ranks_s,
                       **checked)


def check_ranks_against_one(ranks, plain, raw0, single, plain_after,
                            plain_traj, backend, card):
  """`epoch_on_rank`'s results of W ranks against one unranked agent at
  NUM_ENVS envs (`plain`, after its `gated_epoch`; `raw0` its initial
  observations, `plain_traj` its trajectory's digest, `single` its
  `rank_update_check`): each rank's launches exact, the ranks' initial
  observations the unranked ones within RANK_OBS_TOL; their trajectory
  (concatenated over the env axis in rank order) the unranked one's:
  terminals and time limits the same, partial resets made, the raw
  observations of the envs each reset made within RANK_OBS_TOL (the
  reset draws' offsets), the first step's merged normalizer within
  RANK_NORM_TOL (its count exact), the log-probs (the action draws) and RANK_GATED_FIELDS of the
  first RANK_GATED_STEPS steps (the forward on the merged normalizer; the
  camera's step draws) within RANK_TRAJ_TOL; their parameters the same
  bits, their four fused minibatches within FUSED_UPDATE_BAND of the
  unranked ones; the other fields, the later steps and the whole epoch's
  parameter difference printed, not gated.  Returns the numbers."""
  import torch
  from vision4leg_torch.algo.on_policy_base import minibatches
  W = len(ranks)
  rows, n_batches = minibatches(plain.cfg, plain.horizon, NUM_ENVS)
  n_mb = plain.cfg.opt_epochs * n_batches
  # pi_v (4 layers) a step, v (2) at the end and at every step at which
  # some env of the rank reached the episode cap; 4 a minibatch
  want = [{"physics_window": plain.horizon,
           "transformer_layer": (4 * plain.horizon + 2 + 2 * r["capped"]
                                 + 4 * n_mb),
           "transformer_layer_bwd": 4 * n_mb} for r in ranks]
  r0 = ranks[0]
  # the draws, the first normalizer and the first steps are gated; later
  # steps are printed: the trajectories part by float32 rounding that the
  # contacts and the normalizer's 1 / std amplify (on the card at 2 x 512
  # envs ~1e-3 at the first step, ~1 by the fifth)
  apart = ("reset_obs", "normalizer1")
  traj = {k: torch.cat([r["traj"][k] for r in ranks], dim=1)
          for k in plain_traj if k not in apart}
  flags_same = all(torch.equal(traj[k], plain_traj[k])
                   for k in ("terminals", "time_limits"))
  rel_err = lambda a, b: ((a.double() - b.double()).abs()
                          / (1 + b.double().abs()))
  rel = {k: rel_err(traj[k], v).flatten(1).amax(dim=1)
         for k, v in plain_traj.items()
         if k not in apart and v.is_floating_point()}
  early = {k: float(v[:RANK_GATED_STEPS].max()) for k, v in rel.items()}
  gated = max(early[k] for k in RANK_GATED_FIELDS)
  (m, v, c), (pm, pv, pc) = r0["traj"]["normalizer1"], \
      plain_traj["normalizer1"]
  nrm_err = float(max(rel_err(m, pm).max(), rel_err(v, pv).max()))
  nrm_same_count = bool(torch.equal(c, pc)) and all(
      torch.equal(r["traj"]["normalizer1"][2], c) for r in ranks)
  by_step = [max(float(v[t]) for v in rel.values())
             for t in range(plain.horizon)]
  logp_err = float(rel["log_probs"].max())
  resets = plain_traj["terminals"][..., 0].sum(dim=1)
  per_rank = torch.stack([r["traj"]["terminals"][..., 0].sum(dim=1)
                          for r in ranks])
  reset_err = 0.0
  if flags_same:
    reset_err = max(float((torch.cat([r["traj"]["reset_obs"][t]
                                      for r in ranks])
                           - plain_traj["reset_obs"][t]).abs().max())
                    for t in range(plain.horizon) if resets[t])
  raw_err = float((torch.cat([r["raw_obs0"] for r in ranks])
                   - raw0).abs().max())
  same_params = all(torch.equal(r0["params"][k], r["params"][k])
                    for r in ranks[1:] for k in r0["params"])
  check_diff = max_diff(r0["update_check"], single)
  check_ranks = max(max_diff(r0["update_check"], r["update_check"])
                    for r in ranks[1:])
  epoch_diff = max_diff(r0["params"], plain_after)
  for r, out in enumerate(ranks):
    log(f"[ranks] {backend} rank {r} of {W} on {card}: "
        f"{NUM_ENVS // W} envs, epoch {out['seconds']:.2f}s (collection "
        f"{out['phases']['Explore_Time']:.2f}s, update "
        f"{out['phases']['Update_Time']:.2f}s), launches {out['counts']}, "
        f"expected {want[r]}; policy_loss "
        f"{out['metrics']['Training/policy_loss']:.5f}")
  log(f"[ranks] {W} x {NUM_ENVS // W} against 1 x {NUM_ENVS}, the "
      f"{plain.horizon}-step trajectory (episodes capped at {RANK_MAX_EP}): "
      f"{int(resets.sum())} partial resets, at steps "
      f"{[int(x) for x in torch.nonzero(resets)[:, 0]]}, a rank's counts "
      f"{per_rank[:, resets > 0].tolist()}; terminals and time limits the "
      f"same: {flags_same}; the reset envs' raw observations max abs diff "
      f"{reset_err:.3e} (gate {RANK_OBS_TOL:g}); |diff| / (1 + |ref|): "
      f"the first step's normalizer {nrm_err:.3e} (gate {RANK_NORM_TOL:g}; "
      f"counts the same: {nrm_same_count}), log-probs (the action draws) "
      f"{logp_err:.3e}, "
      f"the first {RANK_GATED_STEPS} steps by field "
      + ", ".join(f"{k} {v:.3e}" for k, v in early.items())
      + f" (gate {RANK_TRAJ_TOL:g} on {', '.join(RANK_GATED_FIELDS)}); "
      f"each step's largest (ungated) "
      + ", ".join(f"{x:.1e}" for x in by_step))
  log(f"[ranks] {W} x {NUM_ENVS // W} against 1 x {NUM_ENVS}: initial "
      f"observations max abs diff {raw_err:.3e}; ranks' parameters the "
      f"same bits: {same_params}; four fused minibatches from one state "
      f"{check_diff:.3e} (band {FUSED_UPDATE_BAND:g}; the other ranks "
      f"against rank 0 {check_ranks:.3e}); the whole epoch's parameters "
      f"{epoch_diff:.3e} (ungated: 48 minibatches on trajectories that "
      f"part by the merged normalizer's float32 rounding)")
  if [out["counts"] for out in ranks] != want:
    raise AssertionError(f"[ranks] per-rank launches "
                         f"{[o['counts'] for o in ranks]} != {want}")
  traj_ok = (flags_same and int(resets.sum()) > 0
             and reset_err <= RANK_OBS_TOL and logp_err <= RANK_TRAJ_TOL
             and gated <= RANK_TRAJ_TOL and nrm_err <= RANK_NORM_TOL
             and nrm_same_count)
  if not (raw_err <= RANK_OBS_TOL and same_params and check_ranks == 0.0
          and check_diff <= FUSED_UPDATE_BAND and traj_ok):
    raise AssertionError(f"[ranks] {W} ranks part from 1: initial obs "
                         f"{raw_err}, same params {same_params}, update "
                         f"{check_diff} (ranks {check_ranks}), terminals "
                         f"the same {flags_same}, partial resets "
                         f"{int(resets.sum())} (raw obs {reset_err}), "
                         f"normalizer {nrm_err} (count {nrm_same_count}), "
                         f"log-probs {logp_err}, first steps {early}")
  return dict(rank_epoch_s=[o["seconds"] for o in ranks],
              rank_update_s=[o["phases"]["Update_Time"] for o in ranks],
              initial_obs_max_abs_diff=raw_err, update_check_diff=check_diff,
              first_steps_rel_diff=early, log_prob_rel_diff=logp_err,
              first_normalizer_rel_diff=nrm_err,
              reset_obs_max_abs_diff=reset_err,
              partial_resets=int(resets.sum()), step_rel_diff=by_step,
              epoch_param_diff=epoch_diff)


LONG_CONFIG = "config/rl/moving/frame_extract4_random_delay/thin-goal.json"
LONG_EPOCHS = 10


def phase_long_run(card, dev):
  """The LocoTransformer starter's `run_experiment`, as a long run starts
  it, for LONG_EPOCHS epochs of LONG_CONFIG at NUM_ENVS envs with the
  fused layer everywhere (its log in a temporary directory, its epoch
  table in a file there); the launch counts set to 0 just before and
  held to the path's: per epoch the window 16 and the layer 4 x 16 + 2
  + 4 x 48, its backward 4 x 48 (no episode reaches the cap of 999 in
  160 steps: no other bootstrap); the eval at epoch 9 the window and 2
  layers a step; the updates' layer kernels counted from a device trace
  (`UpdateKernels`).  Checks log.csv and the best snapshot.  Returns the
  launches and the phase's numbers."""
  import contextlib
  import csv

  import torch
  from vision4leg_torch.algo.on_policy_base import minibatches
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import common
  from vision4leg_torch.starter import ppo_locotransformer as starter
  from vision4leg_torch.utils.logger import PPO_COLUMNS
  with open(LONG_CONFIG) as f:
    params = json.load(f)
  cfg = common.ppo_config(params)
  horizon = cfg.epoch_frames // NUM_ENVS
  eval_every = params["general_setting"]["eval_interval"]
  evals = LONG_EPOCHS // eval_every
  eval_steps = cfg.max_episode_frames
  _, n_batches = minibatches(cfg, horizon, NUM_ENVS)
  n_mb = cfg.opt_epochs * n_batches
  want = {"physics_window": LONG_EPOCHS * horizon + evals * eval_steps,
          "transformer_layer": LONG_EPOCHS * (4 * horizon + 2 + 4 * n_mb)
          + evals * 2 * eval_steps,
          "transformer_layer_bwd": LONG_EPOCHS * 4 * n_mb}
  flags = {"V4L_FUSED_ATTN": "1", "V4L_FUSED_UPDATE": "1", "V4L_MESH": "0"}
  saved_env = {k: os.environ.get(k) for k in flags}
  saved_argv = sys.argv
  with tempfile.TemporaryDirectory(prefix="chip_smoke_long_") as tmp:
    os.environ.update(flags)
    sys.argv = ["ppo_locotransformer", "--config", LONG_CONFIG, "--seed",
                "0", "--num_envs", str(NUM_ENVS), "--num_epochs",
                str(LONG_EPOCHS), "--log_dir", tmp, "--id", "long"]
    table = os.path.join(tmp, "epochs.txt")
    try:
      pk.robot_window.launches = 0
      att.fused_transformer_layer.launches = 0
      att.fused_transformer_layer_bwd.launches = 0
      t = time.perf_counter()
      with open(table, "w") as out, contextlib.redirect_stdout(out), \
          UpdateKernels() as updates:
        agent = common.run_experiment(starter.build_module)
        torch.cuda.synchronize()
      dt = time.perf_counter() - t
      if agent.logger.tf_writer is not None:
        agent.logger.tf_writer.close()    # before its directory goes
    finally:
      sys.argv = saved_argv
      for k, v in saved_env.items():
        if v is None:
          os.environ.pop(k, None)
        else:
          os.environ[k] = v
    layer, layer_bwd = updates.launches(layer_wrapper_counts())
    launches = {"physics_window": pk.robot_window.launches,
                "transformer_layer": layer,
                "transformer_layer_bwd": layer_bwd}
    log(f"[long run] the starter's run_experiment, {LONG_EPOCHS} epochs of "
        f"{LONG_CONFIG} at {NUM_ENVS} envs, fused layer everywhere, an "
        f"eval of {eval_steps} steps x {common.num_eval_envs(params)} at "
        f"epoch {eval_every - 1}, on {card}: {dt:.2f}s; launches "
        f"{launches}, expected {want}; the updates' layer kernels "
        f"{tuple(updates.kernels)} from the device trace, their wrapper "
        f"calls {tuple(updates.calls)}")
    if launches != want:
      raise AssertionError(f"[long run] launch counts {launches} != {want}")
    work = os.path.join(tmp, "long", params["env_name"], "0")
    with open(os.path.join(work, "log.csv"), newline="") as f:
      reader = csv.DictReader(f)
      rows = list(reader)
      header = reader.fieldnames
    if list(header[:len(PPO_COLUMNS)]) != list(PPO_COLUMNS):
      raise AssertionError(f"[long run] log.csv header {header}")
    epochs = [int(float(r["EPOCH"])) for r in rows]
    if epochs != list(range(LONG_EPOCHS)):
      raise AssertionError(f"[long run] log.csv epochs {epochs}")
    for r in rows:
      vals = {k: float(v) for k, v in r.items() if v not in ("", None)}
      bad = [k for k, v in vals.items() if not math.isfinite(v)]
      if (bad or vals["diagnostics/nonfinite_obs"]
          or vals["diagnostics/nonfinite_reward"]):
        raise AssertionError(f"[long run] epoch {r['EPOCH']}: non-finite "
                             f"{bad} or counts")
    last = {k: float(v) for k, v in rows[-1].items() if v not in ("", None)}
    if "Eval_Rewards_Average" not in last:
      raise AssertionError("[long run] no eval at the last epoch")
    best = os.path.join(work, "model", "model_pf_best.pt")
    if not os.path.exists(best):
      raise AssertionError("[long run] model_pf_best.pt not written")
    train_s = sorted(float(r["Train___Time"]) for r in rows)
    numbers = dict(
        seconds=dt, epochs=LONG_EPOCHS,
        train_s_median=train_s[len(train_s) // 2], train_s_max=train_s[-1],
        eval_s=last["Eval____Time"],
        eval_return=last["Eval_Rewards_Average"],
        cuda_max_memory_gib=last.get("diagnostics/cuda_max_memory_gib",
                                     math.nan))
    log(f"[long run] log.csv: epochs 0-{LONG_EPOCHS - 1} once each, the JAX "
        f"log's columns first, entries finite; epoch (collection + update) "
        f"median {numbers['train_s_median']:.3f}s, max "
        f"{numbers['train_s_max']:.3f}s; eval {numbers['eval_s']:.2f}s, "
        f"return {numbers['eval_return']:.3f}; peak memory "
        f"{numbers['cuda_max_memory_gib']:.3f} GiB; model_pf_best.pt "
        f"written")
  return launches, numbers


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
    return 2

  from vision4leg_torch.collector import rollout as rollout_lib
  from vision4leg_torch.models.actor_critic import \
      VisionOnlyTransformerActorCritic
  from vision4leg_torch.ops import attention as att
  from vision4leg_torch.ops import nvcc
  from vision4leg_torch.ops import physics_kernel as pk
  from vision4leg_torch.starter import ppo_locotransformer as starter
  from vision4leg_torch.starter import \
      ppo_locotransformer_vision_only as vo_starter
  from vision4leg_torch.starter import ppo_nature_cnn as nature_starter
  from vision4leg_torch.starter import \
      ppo_nature_cnn_vision_only as visual_starter
  from vision4leg_torch.starter import ppo_state as state_starter
  from vision4leg_torch.starter.common import locotransformer_kwargs

  # outputs below are compared against references: no TF32 anywhere
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda")

  # --- 1. the card -------------------------------------------------------
  card = card_name()
  print(card, flush=True)
  log(f"torch {torch.__version__} cuda {torch.version.cuda} "
      f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
  log("TF32 off for matmul and cuDNN (outputs are compared)")

  # --- 2. build the kernels, one nvcc each, started together -------------
  t = time.perf_counter()
  for name, info in nvcc.build(["physics_window",
                                "transformer_layer"]).items():
    log(f"built {name} in {info['seconds']:.2f}s (cached={info['cached']}): "
        f"ptxas {json.dumps(nvcc.ptxas_counts(info['log']))}")
  log(f"both kernels built in {time.perf_counter() - t:.2f}s")
  pk.build_library()
  att.build_library()

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

  act12 = env._expand_action(
      low + (high - low) * torch.rand(num_envs, 6, generator=gen, device=dev))
  cases = {"rollout": rollout_window_inputs(env, states, act12)}
  (_, rs, cmd, dyn, _, _, _, _, n_sub) = cases["rollout"]
  cases["contact"] = contact_case(env.model, env.settled_template(),
                                  rs.phys.pos[:, :2], cmd, dyn, n_sub)
  cases["sphere test case"] = sphere_case(dev)

  max_err = 0.0
  for name, args in cases.items():
    counts = {}
    pk.window_plain(*args, counts=counts)
    ok, rep = pk.compare_with_plain(args)
    torch.cuda.synchronize()
    log_window_report(name, args, rep, counts)
    if not ok:
      raise AssertionError(f"physics_window disagrees with plain on {name}")
    max_err = max(max_err, rep["max_abs_err"])

  args = cases["rollout"]
  check_repeatable("rollout", args)
  counts = {}
  pk.window_plain(*args, counts=counts)
  window, window_ms = time_window("rollout", args, card, counts)

  # --- 4. the collection path --------------------------------------------
  rollout = make_rollout(env, meta, net, params)
  t = time.perf_counter()
  cs = rollout_lib.init_collector(env, num_envs, gen)
  torch.cuda.synchronize()
  log(f"init_collector at {num_envs} envs: {time.perf_counter() - t:.2f}s")
  pk.robot_window.launches = 0
  att.fused_transformer_layer.launches = 0
  att.fused_transformer_layer_bwd.launches = 0
  t = time.perf_counter()
  cs, traj, last_v = rollout(cs)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t
  launches = pk.robot_window.launches
  log(f"rollout: {horizon} steps x {num_envs} envs in {dt:.3f}s = "
      f"{horizon * num_envs / dt:.1f} env-steps/s on {card} "
      f"(first rollout of the process); physics_window launches "
      f"{launches}, transformer_layer launches "
      f"{att.fused_transformer_layer.launches} (fused layer off)")
  if (launches != horizon or att.fused_transformer_layer.launches != 0
      or att.fused_transformer_layer_bwd.launches != 0):
    raise AssertionError(
        f"a {horizon}-step rollout launched physics_window {launches} "
        f"times and transformer_layer "
        f"{att.fused_transformer_layer.launches} times")
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

  # --- 5. the transformer-layer kernels against their plain versions -----
  vision_net = VisionOnlyTransformerActorCritic(**locotransformer_kwargs(
      env, params), generator=torch.Generator().manual_seed(0)).to(dev)
  layer, layer_bwd, layer_extra = phase_layer(net, vision_net, traj.obs[0],
                                              card)

  # --- 29. the layer kernels at 33 tokens (16-channel LocoTransformer) ----
  t33, t33_launches = phase_layer_33(traj.obs[0], card, dev)
  torch.cuda.empty_cache()
  tf32_obs = traj.obs[0].clone()
  update_obs = traj.obs[:4].clone()
  del cs, traj, last_v, vision_net
  torch.cuda.empty_cache()

  # --- 6. the training path ------------------------------------------------
  paths = {"thin-goal training": phase_training(
      "thin-goal", env, meta, params, starter.build_module, TRAIN_EPOCHS,
      EVAL_HORIZON, card)}
  torch.cuda.empty_cache()

  # --- 11. the fused PPO update against the unfused one (B = 1024) -------
  fused_update = [phase_fused_update("thin-goal", net, update_obs, params,
                                     card)]
  del update_obs

  # --- 7. the starter's TF32 convolutions -----------------------------------
  tf32 = phase_tf32(net, tf32_obs)
  del tf32_obs

  # --- 8. the window kernel's hybrid mode ----------------------------------
  mpc_env, _, _, _ = build_mpc_path(dev)
  hybrid, hybrid_ms = phase_hybrid(mpc_env, env, card)
  del mpc_env
  torch.cuda.empty_cache()

  # --- 9. MPC collection ----------------------------------------------------
  (mpc_launches, mpc_rate, mpc_settles, mpc_net, mpc_obs,
   mpc_params, mpc_env, mpc_states) = phase_mpc_collection(card, dev)
  torch.cuda.empty_cache()

  # --- 24. the cold solver and the native core, on phase 9's states ---------
  cold = phase_cold_solver(card, mpc_env, mpc_states)
  del mpc_env, mpc_states
  torch.cuda.empty_cache()

  # --- 11. the fused PPO update against the unfused one (B = 512) --------
  fused_update.append(phase_fused_update("MPC", mpc_net, mpc_obs,
                                         mpc_params, card))
  del mpc_net, mpc_obs
  torch.cuda.empty_cache()

  # --- 10. the MPC controller walks ----------------------------------------
  walk_dx = phase_walk(card, dev)

  # --- 12. MPC training, proprio and vision-only ----------------------------
  mpc_env, mpc_meta, _ = build_env(MPC_CONFIG, dev)
  paths["MPC training"] = phase_training(
      "MPC", mpc_env, mpc_meta, mpc_params, starter.build_module,
      MPC_EPOCHS, MPC_EVAL_HORIZON, card)
  del mpc_env
  torch.cuda.empty_cache()
  vo_env, vo_meta, vo_params = build_env(VISION_CONFIG, dev)
  paths["vision-only MPC training"] = phase_training(
      "vision-only MPC", vo_env, vo_meta, vo_params,
      vo_starter.build_module, VISION_EPOCHS, MPC_EVAL_HORIZON, card)
  del vo_env
  torch.cuda.empty_cache()

  # --- 13. MMDR on moving obstacles, LocoTransformer ------------------------
  mm_env, mm_meta, mm_params = build_env(MMDR_CONFIG, dev)
  paths["MMDR moving training"] = phase_training(
      "MMDR moving", mm_env, mm_meta, mm_params, starter.build_module, 1,
      EVAL_HORIZON, card,
      check=lambda a: check_mmdr_step(
          mm_env, a.collector_state.env_states, "MMDR moving"))
  del mm_env
  torch.cuda.empty_cache()

  # --- 14. Nature-CNN on moving thin-wide, and the moving window case -------
  nm_env, nm_meta, nm_params = build_env(NATURE_MOVING_CONFIG, dev)
  paths["Nature-CNN moving thin-wide training"] = phase_training(
      "Nature-CNN moving thin-wide", nm_env, nm_meta, nm_params,
      nature_starter.build_module, 1, EVAL_HORIZON, card, fused=False,
      check=lambda a: phase_moving_window(
          nm_env, a.collector_state.env_states, card))
  moving_err, moving_numbers, moving_ms = \
      paths["Nature-CNN moving thin-wide training"]["checked"]
  max_err = max(max_err, moving_err)
  del nm_env
  torch.cuda.empty_cache()

  # --- 15. interpolation, fixed delay, and the MPC vision-only baseline -----
  collections = {}
  for label, config, check in (
      ("interpolation collection", INTERP_CONFIG, check_interpolation),
      ("fixed-delay collection", FIXED_DELAY_CONFIG, check_fixed_delay)):
    collections[label] = phase_collection(
        label, config, nature_starter.build_module, horizon, card, dev,
        check)
    torch.cuda.empty_cache()
  collections["vision-only MPC baseline collection"] = phase_collection(
      "vision-only MPC baseline", VISUAL_MPC_CONFIG,
      visual_starter.build_module, MPC_BASELINE_HORIZON, card, dev)
  torch.cuda.empty_cache()

  # --- 16. the mountain, LocoTransformer, on the per-env engine -------------
  mt_env, mt_meta, mt_params = build_env(MOUNTAIN_CONFIG, dev)
  paths["mountain training"] = phase_training(
      "mountain", mt_env, mt_meta, mt_params, starter.build_module, 1,
      EVAL_HORIZON, card,
      check=lambda a: check_nonflat(mt_env, a.collector_state.env_states,
                                    "mountain"))
  del mt_env
  torch.cuda.empty_cache()

  # --- 17. the heightfield corridor (Nature-CNN) and the state-only model ---
  collections["thin-heightfield Nature-CNN collection"] = phase_collection(
      "thin-heightfield Nature-CNN", HEIGHTFIELD_CONFIG,
      nature_starter.build_module, horizon, card, dev,
      lambda env, cs, traj: time_nonflat_step(
          env, cs.env_states, "thin-heightfield Nature-CNN"))
  torch.cuda.empty_cache()
  collections["state-only collection"] = phase_collection(
      "state-only", STATE_CONFIG, state_starter.build_module, horizon, card,
      dev, lambda env, cs, traj: time_nonflat_step(env, cs.env_states,
                                                   "state-only"))
  torch.cuda.empty_cache()

  # --- 18. stairs and chair_desk on the window, the stairs window case ------
  collections["stairs collection"] = phase_collection(
      "stairs", STAIRS_CONFIG, starter.build_module, horizon, card, dev,
      lambda env, cs, traj: phase_stairs_window(env, cs.env_states, card))
  stairs_err, stairs_numbers, stairs_ms = \
      collections["stairs collection"][0]["checked"]
  max_err = max(max_err, stairs_err)
  torch.cuda.empty_cache()
  collections["chair_desk collection"] = phase_collection(
      "chair_desk", CHAIR_DESK_CONFIG, starter.build_module, horizon, card,
      dev)
  torch.cuda.empty_cache()
  nonflat_split = {
      "mountain": paths["mountain training"]["checked"],
      "thin-heightfield": collections[
          "thin-heightfield Nature-CNN collection"][0]["checked"],
      "state-only": collections["state-only collection"][0]["checked"]}
  if paths["mountain training"]["physics_window"] != 0:
    raise AssertionError("the mountain path launched physics_window")

  # --- 19. MPC on the heightfield, on the per-env engine --------------------
  mpc_hf_launches, mpc_hf = phase_mpc_heightfield(card, dev)
  torch.cuda.empty_cache()

  # --- 20. thin-random-shape on the window, RL and MPC ----------------------
  collections.update(phase_random_shape(horizon, card, dev))
  torch.cuda.empty_cache()

  # --- 21. sim2sim: training, and eval on the transfer env ------------------
  paths["sim2sim training"] = phase_sim2sim(card, dev)
  torch.cuda.empty_cache()

  # --- 22. bf16 collection and the action filter ----------------------------
  bf16 = phase_bf16(env, meta, params, card)
  torch.cuda.empty_cache()
  collections["action-filter collection"] = phase_collection(
      "action filter", CONFIG, starter.build_module, horizon, card, dev,
      check_action_filter, overrides={"enable_action_filter": True})
  torch.cuda.empty_cache()

  # --- 23. the locomotion-controller demo on row 1h -------------------------
  demo_launches, demo = phase_demo(card, dev)
  torch.cuda.empty_cache()

  # --- 25. the sphere terrain on the window ---------------------------------
  (sphere_launches, sphere_numbers, sphere_ms,
   sphere_err) = phase_spheres(card, dev)
  max_err = max(max_err, sphere_err)
  torch.cuda.empty_cache()

  # --- 26. random_dir and rotate_sensor -------------------------------------
  collections["random_dir + rotate_sensor collection"] = phase_random_dir(
      horizon, card, dev)
  torch.cuda.empty_cache()

  # --- 27. a policy the JAX package trained, on the port ------------------
  jax_run, jax_run_launches, jax_run_errs, run_tmp = phase_jax_run(card,
                                                                   dev)
  torch.cuda.empty_cache()

  # --- 28. the viewers on its copy, the env viewer ------------------------
  viewers = phase_viewers(run_tmp, card, dev)
  shutil.rmtree(run_tmp)
  torch.cuda.empty_cache()

  # --- 30. random_hill, multi_stairs and random_blocks ---------------------
  terrains = phase_terrains(card, dev)
  torch.cuda.empty_cache()

  # --- 31. the trajectory-generator wrapper --------------------------------
  tg_launches, tg_rate = phase_trajectory_generator(card, dev)
  torch.cuda.empty_cache()

  # --- 32. the on-policy family: A2C, REINFORCE, V-MPO, TRPO --------------
  new_paths = {}
  paths_32, on_policy = phase_on_policy_family(env, meta, params, card, dev)
  new_paths.update(paths_32)
  torch.cuda.empty_cache()

  # --- 33. PPO-aux on the Impala backbone ---------------------------------
  paths_33, ppo_aux_run = phase_ppo_aux(env, meta, params, card, dev)
  new_paths.update(paths_33)
  torch.cuda.empty_cache()

  # --- 34. the off-policy family on the device replay ---------------------
  paths_34, off_policy = phase_off_policy(card, dev)
  new_paths.update(paths_34)
  torch.cuda.empty_cache()

  # --- 35. the hierarchical collector -------------------------------------
  paths_35, hier = phase_hierarchical(card, dev)
  new_paths.update(paths_35)
  torch.cuda.empty_cache()

  # --- 36. the deploy stack on the card: the layer kernel at B = 1 -------
  deploy_launches, deploy = phase_deploy(card, dev)
  torch.cuda.empty_cache()

  # --- 37. env-axis data parallelism over ranks ---------------------------
  rank_paths, ranks = phase_ranks(card, dev)
  torch.cuda.empty_cache()

  # --- 38. the long training path, as a user starts it -------------------
  long_launches, long_run = phase_long_run(card, dev)
  torch.cuda.empty_cache()

  # --- 39. results ----------------------------------------------------------
  # launches: the sum over the paths that run a kernel, each read just
  # after it was driven with the counts at 0 (by path beside it)
  by_path = {k: {n: v[n] for n in ("physics_window", "physics_window_settle",
                                   "transformer_layer",
                                   "transformer_layer_bwd")}
             for k, v in paths.items()}
  by_path["MPC collection"] = {"physics_window": mpc_launches,
                               "physics_window_settle": mpc_settles}
  by_path["MPC heightfield collection + eval"] = mpc_hf_launches
  by_path["MPC demo (locomotion controller, 1 env)"] = demo_launches
  by_path["spheres collection"] = {
      n: sphere_launches[n] for n in ("physics_window", "transformer_layer")}
  by_path.update({f"{k} collection": {n: v[n] for n in (
      "physics_window", "transformer_layer")} for k, v in bf16.items()})
  by_path.update({k: {n: v[n] for n in v if n.startswith("physics_window")}
                  for k, (v, _) in collections.items()})
  by_path[f"JAX-trained {JAX_RUN_ID} eval ({JAX_EVAL_ENVS} x "
          f"{JAX_EVAL_STEPS})"] = jax_run_launches
  by_path.update({f"{k} ({JAX_RUN_ID})" if k == "viewer" else k: {
      n: v[n] for n in ("physics_window", "transformer_layer")}
      for k, v in viewers.items()})
  by_path.update({k: {n: v[n] for n in ("physics_window",
                                        "transformer_layer")}
                  for k, (v, _) in terrains.items()})
  by_path["trajectory-generator collection"] = {
      n: tg_launches[n] for n in ("physics_window", "transformer_layer")}
  by_path["16-channel LocoTransformer pi_v (T 33)"] = dict(
      physics_window=0, **t33_launches)
  by_path.update({k: {n: v[n] for n in ("physics_window", "transformer_layer",
                                        "transformer_layer_bwd")}
                  for k, v in new_paths.items()})
  by_path["deploy (fake robot, B 1)"] = deploy_launches
  by_path.update(rank_paths)
  by_path[f"MMDR moving starter, {LONG_EPOCHS} epochs"] = long_launches
  total = lambda name: sum(v.get(name, 0) for v in by_path.values())
  row1_paths = {k: v["physics_window"] for k, v in by_path.items()
                if "MPC" not in k}
  row1_paths.update({k: v["physics_window_settle"]
                     for k, v in by_path.items() if "MPC" in k})
  row1h_paths = {k: v["physics_window"] for k, v in by_path.items()
                 if "MPC" in k}
  layer_paths = lambda name: {k: v[name] for k, v in by_path.items()
                              if name in v}
  minibatch = {k: v["minibatch"] for k, v in paths.items()}
  layer["max_abs_err"] = max(layer["max_abs_err"], jax_run_errs[0],
                             t33["max_abs_err"], deploy["layer_max_abs_err"])
  layer_bwd["max_abs_err"] = max(layer_bwd["max_abs_err"], jax_run_errs[1],
                                 t33["bwd_max_abs_err"],
                                 deploy["layer_bwd_max_abs_err"])
  kernels = [dict(
      name="physics_window", route="cuda",
      source="vision4leg_torch/ops/csrc/physics_window.cu",
      replaces="vision4leg_tpu/ops/physics_kernel.py:122",
      launches=sum(row1_paths.values()), launches_by_path=row1_paths,
      shapes="16 substeps at 1024 envs (thin-goal, moving thin-goal and "
             "thin-wide, interpolation and fixed-delay, stairs and "
             "chair_desk, thin-random-shape, sim2sim, float32 and bf16, "
             "action-filter, sphere-terrain (8 of 50 spheres an env), "
             "random_dir + rotate_sensor, multi_stairs, random_blocks, "
             "trajectory-generator, on-policy family, PPO-aux (Impala) and "
             "hierarchical collections; the off-policy agents' pretrain "
             "and epoch steps on state-only with random_blocks_sparse_with_"
             "subgoal), 32 (the JAX-trained "
             f"{JAX_RUN_ID} eval), 2 (its viewer), 1 (the env viewer) and "
             "8 (eval, the sim2sim transfer env's among them); the MPC "
             "resets' settles "
             "of settle_steps substeps at 1024 envs, the partial resets' "
             "envs, 8 (eval) and 1 (the demo's 300); never on a "
             "heightfield terrain (mountain, hill, thin-heightfield, "
             "state-only, MPC heightfield: 0)",
      max_abs_err=max_err, **window), dict(
      name="transformer_layer", route="cuda",
      source="vision4leg_torch/ops/csrc/transformer_layer.cu",
      replaces="vision4leg_tpu/ops/attention.py:116",
      launches=total("transformer_layer"),
      launches_by_path=layer_paths("transformer_layer"),
      launches_note="bf16 collection: 0 launches by design: its forward "
                    "runs the unfused layer, as the JAX layer routes a "
                    "non-float32 input (vision4leg_tpu/models/base.py:"
                    "233-238); the float32 collection beside it launches",
      shapes=f"(B, T, 64), F 256: T 17 at B 1024, 8 (eval), 32 (the "
             f"JAX-trained eval), the update's minibatch {minibatch} and the "
             f"A2C, REINFORCE and V-MPO updates' 1024 (V-MPO's policy on "
             f"its top half, 512), 512 (the 2-rank epoch's ranks) and 1 "
             f"(deploy, twice a tick); T "
             f"16 (vision-only) at the same; T 33 (the 16-channel "
             f"LocoTransformer, the large instantiation) at B 1024; checked "
             f"also at B 1000, 512 and 3 (T 17), 512 (T 16), 8 (T 33)",
      at_33_tokens=t33["shapes"], deploy_1x17=deploy["layer_1x17"],
      **layer), dict(
      name="transformer_layer_bwd", route="cuda",
      source="vision4leg_torch/ops/csrc/transformer_layer.cu",
      replaces="vision4leg_tpu/ops/attention.py:149 (_ad_bwd :178)",
      launches=total("transformer_layer_bwd"),
      launches_by_path=layer_paths("transformer_layer_bwd"),
      shapes=f"the update's minibatch {minibatch} at T 17 and 16, the "
             f"A2C, REINFORCE and V-MPO updates' 1024 (V-MPO's policy 512) "
             f"at T 17; checked "
             f"also at B 1000, 512 and 8, and at T 33 at B 1024 and 8",
      at_33_tokens={k: {n: v[n] for n in ("ad_ms", "plain_ad_ms",
                                          "library_ad_ms", "ad_bound_ms")}
                    for k, v in t33["shapes"].items()},
      **layer_bwd), dict(
      name="physics_window_hybrid", route="cuda",
      source="vision4leg_torch/ops/csrc/physics_window.cu",
      replaces="vision4leg_tpu/ops/physics_kernel.py:122 (hybrid mode, "
               ":125-136)",
      launches=sum(row1h_paths.values()), launches_by_path=row1h_paths,
      shapes="5 substeps at 1024 envs (collection: LocoTransformer, "
             "vision-only, the vision-only Nature-CNN baseline and the "
             "thin-random-shape Nature-CNN baseline), 8 (eval) and 1 (the "
             "locomotion-controller demo, one launch a tick); never on "
             "the MPC heightfield (0: the per-env engine)",
      **hybrid)]
  print(json.dumps({"kernels": kernels, "card": card,
                    "window_ms": {"rollout": window_ms,
                                  "hybrid": hybrid_ms,
                                  "moving": moving_ms,
                                  "stairs": stairs_ms,
                                  "spheres": sphere_ms},
                    "moving_window": dict(max_abs_err=moving_err,
                                          **moving_numbers),
                    "stairs_window": dict(max_abs_err=stairs_err,
                                          **stairs_numbers),
                    "sphere_window": sphere_numbers,
                    "sphere_collection": sphere_launches,
                    "locomotion_demo": demo,
                    "cold_solver": cold,
                    "nonflat_step_ms": nonflat_split,
                    "mpc_heightfield": mpc_hf,
                    "bf16_collection": bf16,
                    "action_filter_range": collections[
                        "action-filter collection"][0]["checked"],
                    "collection_memory_gib": {
                        k: {"peak": v["max_memory_gib"],
                            "above_start": v["added_memory_gib"]}
                        for k, (v, _) in collections.items()},
                    "collections_env_steps_per_s": {
                        k: rate for k, (_, rate) in collections.items()},
                    "collection_env_steps_per_s": horizon * num_envs / dt,
                    "training": {k: v["epochs"] for k, v in paths.items()},
                    "checkpoint_mib": {k: v["checkpoint_mib"]
                                       for k, v in paths.items()},
                    "mpc_collection_env_steps_per_s": mpc_rate,
                    "mpc_walk_min_progress_m": walk_dx,
                    "fused_update": fused_update,
                    "tf32_pi_v_max_abs_diff": tf32,
                    "transformer_layer": layer_extra,
                    "layer_33_tokens": t33,
                    "jax_trained_eval": jax_run,
                    "viewers": viewers,
                    "terrain_collections": {
                        k: dict(v, env_steps_per_s=r)
                        for k, (v, r) in terrains.items()},
                    "trajectory_generator_collection": dict(
                        tg_launches, env_steps_per_s=tg_rate),
                    "new_paths_seconds": {k: v["seconds"]
                                          for k, v in new_paths.items()},
                    "on_policy_family": on_policy,
                    "ppo_aux": ppo_aux_run,
                    "off_policy": off_policy,
                    "hierarchical": hier,
                    "deploy": deploy,
                    "ranks": ranks,
                    "long_run": long_run}),
        flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
