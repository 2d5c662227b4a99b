#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: a CUDA card is required (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the SPD-solve kernels (csrc/spd_solve.cu, the register
   kernel, and csrc/spd_solve_general.cu, the general kernel) from source,
   all started together, and prints registers and spills of each padded
   size or type they are built for (the general kernel's ten instances by
   route: ``reg_kernel`` at each of ``GENERAL_PADDED_SIZES``, ``tile`` and
   ``inplace`` in both types); fails if one is missing or spills;
3. kernel check: the register kernel against its plain PyTorch version and
   against
   float64 ``torch.linalg.solve`` on random SPD batches (every padded size
   and its ends, n = 1; every batch the later phases launch at, whole
   blocks, a ragged last block and a misaligned view) and on M, M + h D and
   Newton H from hand23 rollouts at each of those batches; times, at
   the main path's shape [4096, 23], the kernel, the plain version and
   ``torch.linalg.solve_ex`` (the one PyTorch call that computes the same
   x, timed only) over 50 eager calls, and the kernel as 50 launches
   captured in a CUDA graph, so that the host's launch cost drops out,
   at [4096, 23] and for one block alone, [8, 23]
   (``solve_ex`` cannot be captured: it fails with
   cudaErrorStreamCaptureUnsupported). Then the general kernel (float64 at
   any n, float32 with n > 64) against the plain version and a float64
   ``torch.linalg.solve`` at ``GENERAL_F64_SIZES`` and
   ``GENERAL_F32_SIZES`` through the dispatch and at
   ``GENERAL_F32_DIRECT_SIZES`` through ``spd_solve_general_cuda`` (both
   ends of each padded size and route switch, both sides of its
   shared-memory limit), at ``GENERAL_BATCHES``, with and without the
   factor (the float64 solve at the batches of up to 16 systems, and at
   every batch for n <= 72); on misaligned views; on the clamp cases
   (``_clamp_systems``: the NaN and infinity pattern of x equal, finite
   entries within the bound of each system's scale); timed as the
   register kernel at [4096, 23] float64 and [4096, 72] float32. Last, the
   register kernel (NP 64) and the general kernel's float32 route on the
   same [4096, 35] and [4096, 50] systems, each held against the plain
   version and timed as 50 launches in a CUDA graph, in turns;
4. main path: ``PoseEnv`` on the synthetic hand23 scene with the
   myoHandPoseFixed-v0 task, ``BatchedEnv`` of 4096 envs, ``init`` and 105
   control steps, so every env crosses horizon 100 once; checks finite
   outputs, the autoreset, the kernel launch count and the precision pin;
5. card against CPU: 5 control steps of the same 16 envs on the card
   (float32, kernel) and on the CPU (float64, plain version);
6. train: ``NPG.train`` on hand23 at the zoo run's width (512 trajectories
   x horizon 100, ``NPGConfig`` defaults otherwise), one iteration with a
   32-env eval after it and a ``MetricsWriter``; then one ``PPO``
   iteration at ``PPOConfig`` defaults (128 envs x 50 steps, 32 minibatches,
   8 epochs). Prints env-steps/s and physics-steps/s per iteration, the
   seconds of rollout, GAE, natural-gradient step and value fit (CUDA syncs
   around each, here and not in the learner), the realized mean KL of each
   step beside ``step_size``, the SPD-kernel launches of each part and of
   the inits (timed apart) and the metrics. Iteration 0's natural-gradient
   step, and the start of its value fit, are replayed in float64 on the
   CPU from the same state, batch and permutation. Fails on a non-finite
   metric, a realized KL off ``step_size`` by more than ``KL_BAND``, a
   replay off by more than ``NPG_UPDATE_BOUND``, unchanged parameters, no
   kernel launch, a lost precision pin or a jsonl with the wrong number of
   records;
7. policy: the zoo's myoHandPoseFixed-v0 policy drives 4096 hand23 envs for
   5 control steps on the card; at B = 16 its float32 actions on the card
   match the float64 policy on the CPU for the same observations (at reset
   and after 5 steps), and the CPU float64 env driven by the card's actions
   stays within phase 5's state bounds;
8. SAC: ``SAC.train`` on hand23 at the proof recipe's width (32 envs x 8
   updates per step, ``SACConfig`` defaults otherwise: buffer 131,072,
   batch 256, hidden (256, 256)) with learning_starts cut from 5000 to 64,
   for 12 iterations. Prints per iteration the seconds of collection,
   insert and update (syncs around each, here and not in the learner),
   env-steps/s, physics-steps/s, SPD-kernel launches and the metrics.
   Iteration 3's 8 gradient steps are replayed in float64 (and float32) on
   the CPU from the card's state, minibatch indices and draws. Fails on a
   non-finite metric, nets, target, alpha or Adam states that move before
   learning_starts, nets or alpha that do not move after it, a replay off
   by more than ``SAC_REPLAY_BOUND``, or a wrong buffer cursor or fill;
9. conditions: fatigue (random reset), sarcopenia, obs_noise 0.01 and a
   ``PoseEnv`` whose ``reset_overlay`` randomizes all six
   ``RandomizeSpec`` fields, each for 5 autoreset steps of 16 envs on the
   card (float32) and on the CPU (float64 and float32) with the same draws
   (see ``FLOAT32_MARGIN`` for the bounds); then the nominal, overlay and
   obs_noise envs at B = 4096 in turns (nominal, overlay, obs_noise,
   obs_noise, overlay, nominal), ``PHASE9_STEPS`` control steps each with
   staggered
   episode clocks, physics-steps/s beside phase 4's; fails if an env that
   did not reset lost its overlay or one that did kept it.

10. CLI: ``python -m myosuite_mjx_tpu_torch.train.cli`` in process on
   ``hand23ReachRandom-v0``: (a) one NPG iteration of the zoo run's 512
   trajectories, the horizon cut to ``CLI_NPG_HORIZON`` (phase 6 runs the
   whole 512 x 100), with a checkpoint; (b) SAC at the proof recipe's width (32
   envs x 8 updates; learning_starts 64 as in phase 8, the two set as
   ``SACConfig`` defaults since the CLI has no flags for them), 6
   iterations straight, and 3 with a checkpoint then ``--resume`` to 6
   from the same seed. Prints env-steps/s, seconds per iteration and SPD
   launches of each run. Fails unless the metrics are finite, the
   checkpoints exist, the resumed run starts at iteration 4 with env_steps
   continuing, and its nets equal the straight run's within
   ``SAC_REPLAY_BOUND`` of each net's change (the card's index_add is not
   deterministic, so bit equality is not expected);
11. ``prove_sac`` on ``hand23ReachRandom-v0`` at its width (learning_starts
   64), 256 env steps and one deterministic eval of 32 episodes x 100
   steps, its JSON written to a temporary ``--out`` and printed; prints
   eval_success, eval_score and the seconds (no success level is a pass
   condition at this length);
12. ball, free and mocap: ``engine.api.Physics`` on the ``free10`` fixture
   (a hinge-ball chain, a free body landing on a plane and a bar, the bar
   on a mocap body): 16 envs for 50 substeps on the card (float32) against
   the CPU (float64; the CPU float32 figure printed beside the bound),
   then B = 4096 for 400 substeps, timed after the first 10; prints
   physics-steps/s and the active contacts; fails unless the free bodies
   come to rest on their contacts;
13. contact geometry and the hand-object tasks: (a) every ported pair type
   (the plane, sphere, capsule, ellipsoid, cylinder and box pairs and the
   convex MPR path) at B = 4096 on seeded poses and sizes, separated,
   shallow, deep and with coincident centres, the card's float32 against
   the port's float64 on the CPU (median lane within ``PAIR_MEDIAN_BOUND``,
   branch flips no more often than in float32 on the CPU, see
   ``PAIR_FLIP``); (b) the ``prims36`` fixture (free bodies of every
   primitive type, all 20 pair types) through ``Physics``: 16 envs for 50
   substeps against the CPU, then B = 4096 for ``PRIMS_WINDOW`` substeps,
   failing unless
   the bodies rest and none is below the plane; (c) ``hand23KeyTurnRandom``,
   ``ObjHoldRandom``, ``PenTwirlRandom`` and ``DieReorientP1`` through
   ``envs.make``: 16 envs for 5 control steps against the CPU with the same
   draws (phase 9's bounds), then B = 4096 for ``MANIP_STEPS`` control
   steps with every
   episode clock crossing its horizon, printing physics-steps/s, SPD
   launches, active contacts, the share of envs whose object touches the
   hand and the contacts the top-k cull dropped, failing on a non-finite
   output, an object below the plane, no hand-object contact, or an env
   that did not autoreset; (d) ``train.cli`` SAC on
   ``hand23ObjHoldRandom-v0`` at the proof recipe's width for 6
   iterations, failing unless the metrics are finite and the nets move.

14. heightfield contacts, sensors and the leg tasks: (a) the hfield-sphere
   and hfield-capsule pairs at B = 4096 over a seeded 100 x 100 field,
   separated, shallow, deep and on a cell corner, the card's float32
   against the port's float64 on the CPU (13a's bounds; a lane on a cell
   boundary may take the neighbouring cell in float32, and flips are held
   to the CPU float32's share); (b) the plate scene of the sensor tests
   through ``Physics``: at rest its force sensor carries the plate's and
   the ball's weight within 1%; (c) ``legs80StandRandom``, ``Walk``,
   ``RoughTerrainWalk``, ``StairTerrainWalk`` and ``ChaseTagP2`` through
   ``envs.make``: 16 envs for 5 control steps against the CPU with the
   same draws; (d) each at B = 4096 for ``LEG_STEPS`` control steps with every
   episode clock crossing its horizon, printing physics-steps/s, the
   ratio to phase 4, ms per control step, SPD launches, active contacts,
   the share of envs with a foot on the ground, the contacts the top-k
   cull dropped and the four foot sensors' force against the body weight
   on the median env, failing on a non-finite output, a pelvis below the
   floor or the terrain, no foot contact, or an env that did not
   autoreset; (e) ``tools/profile_step.py`` on ``legs80Walk-v0``, once.

15. mesh hulls and the rest of the hand and arm tasks: (a) the four mesh
   pairs (a plane, sphere, capsule or ellipsoid against the hulls scene's
   convex hull) at B = 4096 on seeded poses, separated, shallow, deep and
   inside the hull, the card's float32 against the port's float64 on the
   CPU (13a's bounds and flip rule); (b) the ``hulls`` fixture (free
   bodies dropping onto a convex mesh slab that lies on a plane) through
   ``Physics``: 16 envs for 50 substeps against the CPU, then B = 4096 for
   120 substeps, failing unless every mesh pair touches and the bodies
   rest; (c) ``hand23BaodingP2-v1``, ``arm27RelocateP2-v0``,
   ``arm27Bimanual-v0`` and ``hand23Reorient100-v0`` through ``envs.make``:
   16 envs for 5 control steps against the CPU (14c's rule); (d) each at
   B = 4096 for ``HAND_ARM_STEPS`` control steps with every episode clock
   crossing its
   horizon, printing physics-steps/s, the ratio to phase 4, ms per control
   step, SPD launches, active contacts and the contacts the cull dropped,
   failing on a non-finite output, a baoding ball that starts below
   ``drop_th``, a SAR env without exactly one active object geom sized
   from its table, a bimanual run in which no env reports a touching
   class, a task that ends every env at its first step, or an env that did
   not autoreset; (e) ``tools/profile_step.py`` on ``arm27RelocateP2-v0``,
   once (its stages name each narrowphase group, the mesh ones too).

16. the OSL RunTrack and MyoDM tracking tasks: (a) the OSL machine
   (``envs/osl.py``) on the card in float32 against the port in float64
   on the CPU, 4,096 seeded sensor vectors and states: every state equal,
   torques within ``OSL_TORQUE_BOUND``; (b) ``osl54OslRunFixed-v0``,
   ``osl54OslRunRandom-v0`` and ``track29CubesmallFixed``, ``Random`` and
   ``Lift-v0`` through ``envs.make``: 16 envs for 5 control steps against
   the CPU (14c's rule); (c) both OSL ids and the Random and Lift tracking
   ids at B = 4096 for ``OSL_TRACK_STEPS`` control steps with every
   episode clock crossing
   its horizon, printing physics-steps/s, the ratio to phase 4, ms per
   control step, SPD launches per control step, active contacts per env
   and step, the contacts the cull dropped, the OSL states over the
   env-steps and the envs whose machine left early stance, and the
   tracking tasks' lift-bonus count, failing on a non-finite output, an
   OSL machine that never leaves early stance, or an env that did not
   autoreset.

17. the general kernel's paths: (a) hand23's PoseFixed env in float64 on
   the card, 16 envs for 5 control steps, against the CPU port in float64
   (``F64_CARD_CPU_BOUND`` on the median env; contact-branch flips in at
   most ``F64_FLIP_ENVS`` envs, phase 13's ill-lane rule); (b) the
   ``chain72`` fixture (nv 72) through ``Physics``: float32 and float64 at
   B = 16 for ``CHAIN_STEPS`` substeps against the CPU in float64
   (``CHAIN_CPU_BOUND``), then float32 at B = 4096 for ``CHAIN_STEPS``
   substeps, printing physics-steps/s and the general kernel's launches;
   (c) inverse kinematics (``utils/ik.py``) of hand23's IFtip to 4,096
   targets from feasible poses, in float32 and float64: success share,
   mean steps, reach error and seconds; at B = 16 in float64 against the
   CPU port; (d) one short call of each examine command (``examine_sim`` on
   chain72, ``examine_env`` on track29CubesmallFixed-v0, ``examine_logs``
   record then playback on the pose task, which
   must reproduce the log exactly, ``examine_reference`` on
   track29CubesmallLift-v0) through its ``main(argv)``.

18. the rest of the port: (a) ``reflex_update`` (``agents/reflex.py``) on
   the card in float32 against the port on the CPU in float64, on 4,096
   seeded float32 sensor dicts, phase states and gain vectors: every flag
   equal, stimulations within ``REFLEX_STIM_BOUND``; (b)
   ``ReflexWalker.rollout`` on legs80_reflex, 512 walkers (each its own
   gains) for 20 control ticks, printing pelvis height, x, footsteps,
   physics-steps/s and SPD launches a tick, then 4 walkers for 5 ticks
   against the CPU in float64 (phase 5's qpos and qvel bounds; their
   launches are not counted as the path's); (c)
   ``tools/tune_reflex.py`` for 2 generations of 128 walkers x 10 ticks
   into a temporary directory, failing unless its fitness is finite and
   the best never falls; (d) ``gym_make`` on hand23's pose id, one env for
   5 steps and 4096 for 3, and the ``flax_cnn`` encoder on 64 frames of
   84 x 84, card float32 against CPU float64 (``CNN_BOUND``); (e) the CLI's
   ``--mesh data`` at world size 1 on NCCL (one group for both), one NPG
   and one PPO iteration of 32 envs (the horizon cut to 5; PPO 2 epochs of
   2 minibatches), each failing unless it launched the SPD kernel, and
   each state against the unsharded learner's from the same seed, run
   outside the counted window (``MESH_BOUND``); (f)
   ``tools/train_zoo_baseline.py`` for one PPO iteration into a temporary
   zoo, its snapshot loaded and acting on the card, and
   ``tools/convergence_study.py`` on the hold scene at B = 512 for 5
   substeps.

Every (dtype, B, n) at which phases 4-18 launch a kernel must be among
those phase 3 checked. Phases 9's and 13-18's CPU runs are computed in
one worker process (``cpu_references_conditions``, then
``cpu_references``), started after phase 2 and joined at phases 9 and 13,
while the card runs the phases before them.

The line before the last is the kernels' JSON record (both kernels); the
last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import io
import json
import multiprocessing
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

DEVICE = "cuda"
B_MAIN = 4096
STEPS = 105
WARMUP = 2
HAND23 = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets", "hand23.npz")
FREE10 = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets", "free10.npz")
# the kernel is built for these padded sizes: cover each and its ends, and
# n = 1; 10 is free10's nv (phase 12), 24 and 29 the hand-object scenes'
# and 36 prims36's (phase 13), 22 the legs' and 7 the plate's (phase 14),
# 25 the OSL scene's and 35 the tracking scene's (phase 16)
PADDED_SIZES = (8, 16, 24, 32, 64)
SIZES = (1, 4, 7, 8, 10, 11, 16, 17, 22, 23, 24, 25, 29, 32, 33, 35, 36,
         50, 64)
# the batches the paths launch the kernel at: the card side of phases 5 and
# 7, the NPG eval, the PPO rollout, the NPG rollout and the main path
PATH_BATCHES = (16, 32, 128, 512, B_MAIN)
# those, one system (NPG's init reset), phase 18b's four walkers against
# the CPU, whole blocks (bulk-copy load) and a ragged last block (plain
# load)
BATCHES = (1, 4, *PATH_BATCHES, 1000, 4097)
# kernel vs plain, float32 both: relative to the largest |x|. Random SPD
# batches have eigenvalues >= 1, so a few ulps of float32 suffice.
RANDOM_BOUND = 2e-5
# rollout matrices can be ill-conditioned (stiff contact rows): both
# solvers must be backward stable, |A x - b| <= bound * |A| |x| (inf-norms)
BACKWARD_BOUND = 1e-5
# card float32 vs CPU float64 after 5 control steps (50 contact-rich
# substeps). Float32 against float64 on the CPU gave 3.6e-6 (qpos),
# 8.4e-4 (qvel, of 6.8 peak) and 1.3e-7 (act); the bounds leave 25-80x.
CARD_CPU_BOUND = {"qpos": 1e-4, "qvel": 7e-2, "act": 1e-5}
# phase 6: the zoo NPG run's width (train_artifacts/myoHandPoseFixed_npg:
# 51,200 env steps per iteration), one iteration (two until phase 13 came
# and the command neared the time limit on a slow host)
NPG_ENVS = 512
NPG_ITERS = 1
TRAIN_SEED = 0
# the realized mean KL of a natural-gradient step within this share of
# step_size (the PR 3 prediction; measured 0.0987 to 0.0996 for 0.1)
KL_BAND = 0.2
# iteration 0's update against a float64 replay on the CPU from the same
# state, batch and permutation: the natural-gradient step (the policy's
# largest difference over its largest change, and alpha, relative), and the
# first 100 minibatches of the value fit replayed on the card (likewise).
# Float32 against float64 on the CPU, hand23 batches of 1,600 and 51,200
# samples: policy 3.9e-7 to 3.8e-6, alpha 5.7e-7 to 1.1e-6, value 1.7e-6
# after 100 minibatches and at most 5.4e-6 up to the 1,050th; the bounds
# leave 20x and more. Past that, a ReLU unit that switches sign in one
# precision and not the other took the whole fit (1,600 minibatches) to
# 7.8e-2 apart, so the whole fit cannot be held to a bound.
VF_REPLAY_MINIBATCHES = 100
NPG_UPDATE_BOUND = {"policy": 1e-4, "alpha": 1e-4, "value": 1e-4}
# phase 7: card float32 vs CPU float64 policy on the same observations.
# Float32 against float64 on the CPU gave 4.5e-7; the bound leaves 20x.
POLICY_BOUND = 1e-5
POLICY_STEPS = 5
# phase 8: SAC at the proof recipe's width (tools/prove_sac.py:29-30,
# train_artifacts/sac_proof: 32 envs x 8 updates per step, SACConfig
# defaults otherwise), learning_starts cut from 5000 to 64 so that updates
# begin at the third iteration; SAC_ITERS iterations, and iteration
# SAC_REPLAY_ITER's 8 gradient steps replayed on the CPU in float64 from the
# card's state, minibatch indices and draws
SAC_CFG = dict(num_envs=32, updates_per_step=8, learning_starts=64)
SAC_ITERS = 12
SAC_REPLAY_ITER = 3
SAC_NETS = ("actor", "q", "q_target", "log_alpha")
# each net's largest difference from the float64 replay over its largest
# change there. CPU float32 against float64 (this phase on the CPU, hand23
# at this width) gave 2.6e-4 (actor), 1.7e-5 (q), 4.5e-4 (q_target: its
# change is tau times the critic's) and 8.7e-8 (log_alpha); the bounds
# leave 20x and more. The run prints the CPU float32 figure for its own
# state beside the card's.
SAC_REPLAY_BOUND = {"actor": 6e-3, "q": 4e-4, "q_target": 1e-2,
                    "log_alpha": 2e-6}
# phase 9: the conditions, observation noise and model overlay, at B = 16
# on the card against the CPU in float64; then the nominal, overlay and
# obs_noise envs at B_MAIN in turns (PHASE9_ORDER, so that each pair is
# compared inside one call), PHASE9_STEPS control steps each with the
# episode clocks staggered, so that envs autoreset in every step of the
# window. At B = 16 the median env is held to phase
# 5's bounds, and the worst env to the larger of those and FLOAT32_MARGIN
# times the worst env of a CPU float32 run of the same variant: randomized
# physics puts some envs where contacts amplify rounding (CPU float32
# against float64, worst of 16 envs, qpos: 3.6e-6 without the overlay,
# 1.7e-4 to 1.1e-3 with it over seeds 0-3; the median env 1.4e-7 in both)
CONDITIONS = {"fatigue": dict(muscle_condition="fatigue",
                              fatigue_reset_random=True),
              "sarcopenia": dict(muscle_condition="sarcopenia"),
              "obs_noise": dict(obs_noise=0.01),
              "overlay": {}}
OVERLAY_SPEC = dict(body_mass=(0.8, 1.2), body_pos=(-0.002, 0.002),
                    geom_size=(0.9, 1.1), geom_friction=(0.5, 1.5),
                    dof_damping=(0.5, 2.0), actuator_gain=(0.8, 1.2))
PHASE9_ORDER = ("nominal", "overlay", "obs_noise", "obs_noise", "overlay",
                "nominal")
# (5 keeps the whole command under 1,000 s with phase 17)
PHASE9_STEPS = 5
FLOAT32_MARGIN = 20
# phase 10: the CLI on this task; SAC at the proof recipe's width, run
# straight for CLI_SAC_ITERS iterations and in two legs split at
# CLI_SAC_SPLIT
CLI_ENV = "hand23ReachRandom-v0"
# (a) NPG at the zoo run's 512 trajectories, the horizon cut from 100 (PR
# 13: the whole command neared its time limit on a slow host; phase 6
# runs the whole horizon)
CLI_NPG_HORIZON = 50
CLI_SAC_ITERS = 6
CLI_SAC_SPLIT = 3
# phase 11: prove_sac's length (8 iterations and one eval; 12 until PR 9,
# cut to keep the whole command under 1,000 s with phase 15)
PROOF_STEPS = 256
# phase 12: free10 at B = 16 for FREE_STEPS substeps, card float32 against
# CPU float64. CPU float32 against float64 gave 3.1e-6 (qpos) and 8.1e-4
# (qvel, of 9.3 peak); the bounds leave 25-30x. Then B_MAIN envs for
# FREE_WINDOW substeps: by then the median env's free body moves slower
# than FREE_REST (CPU float32, 16 envs: 0.0075 after 400 substeps)
FREE_STEPS = 50
FREE_CPU_BOUND = {"qpos": 1e-4, "qvel": 2e-2}
FREE_WINDOW = 400
FREE_REST = 0.05
BAR_POS = (0.0, 0.0, 0.015)
# phase 13: contact geometry and the hand-object tasks.
# 13a: every ported pair type at B_MAIN on seeded poses and sizes (a
# quarter each separated, shallow, deep and with coincident centres), the
# card's float32 against the port's float64 on the CPU, with the CPU's
# float32 beside it. Where the answer turns on a comparison of nearly equal
# values (the normal of a zero offset, the nearest face of a deep point, a
# box face or a cylinder rim, MPR's portal choices), float32 can take
# another branch than float64: up to 24% of the lanes on the CPU (a lane
# "flips" when dist, pos or normal is off by more than PAIR_FLIP). The
# phase holds the card's median lane within PAIR_MEDIAN_BOUND (CPU float32
# medians over the 20 types: at most 8.1e-9 dist, 4.7e-8 pos, 3.9e-6
# normal; the bounds leave 20x and more) and its share of flipped lanes
# within PAIR_FLIP_SLACK of the CPU float32's
PAIR_FLIP = {"dist": 1e-5, "pos": 1e-4, "normal": 1e-3}
PAIR_MEDIAN_BOUND = {"dist": 2e-7, "pos": 1e-6, "normal": 1e-4}
PAIR_FLIP_SLACK = 0.02
# 13b: prims36 (every pair type in dynamics) at B = 16 for PRIMS_STEPS
# substeps, card float32 against CPU float64 within free10's
# FREE_CPU_BOUND (CPU float32 against float64 gave 5.5e-7 qpos and 1.4e-5
# qvel, the card 5.5e-7 and 1.5e-5); then B_MAIN envs for PRIMS_WINDOW
# substeps (90, cut from 120 for the command's time): by then every body
# rests (CPU float32, 32 envs: each body's median speed at most 0.009
# after 150 substeps, in m/s or rad/s; the median env's fastest body 0.021
# after 90, 0.013 after 100) and none is below the plane
PRIMS36 = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets",
                       "prims36.npz")
PRIMS_STEPS = 50
PRIMS_WINDOW = 90
PRIMS_REST = 0.05
# 13c: each task at B = 16 for 5 control steps on the card and the CPU
# with the same draws (phase 9's bounds), then B_MAIN envs for MANIP_STEPS
# control steps, timed after WARMUP, every episode clock set to cross its
# horizon inside the window
MANIP_TASKS = ("hand23KeyTurnRandom-v0", "hand23ObjHoldRandom-v0",
               "hand23PenTwirlRandom-v0", "hand23DieReorientP1-v0")
MANIP_OBJECT = {"hand23KeyTurnRandom-v0": "key",
                "hand23ObjHoldRandom-v0": "object",
                "hand23PenTwirlRandom-v0": "Object",
                "hand23DieReorientP1-v0": "die"}
# (5 keeps the whole command under 1,000 s with phases 17 and 18)
MANIP_STEPS = 5
# 13d: the CLI's SAC at the proof recipe's width on the hold task
MANIP_TRAIN_ENV = "hand23ObjHoldRandom-v0"
MANIP_SAC_ITERS = 6
# phase 14: heightfield contacts, sensors and the leg tasks.
# 14a: the hfield-sphere and hfield-capsule pairs at B_MAIN over a seeded
# HFIELD_GRID field (rubble: heights up to 5 cm over 2 cm cells of a 2 m x
# 2 m field, near the origin as 13a's poses are), sizes 1-4 cm,
# a quarter each separated, shallow, deep and centred on a cell corner;
# the card's float32 against the port's float64 on the CPU with 13a's
# median bounds and flip rule: on a cell boundary float32 can take the
# neighbouring cell, whose slope sets another normal
HFIELD_GRID = (100, 100)
HFIELD_SIZE = (1.0, 1.0, 0.05)
# 14b: the plate scene's force sensor at rest after PLATE_STEPS substeps
# carries the plate's and the ball's weight within PLATE_BOUND (750, cut
# from 1,500 for the command's time: the scene rests within a few hundred
# substeps)
PLATE = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets", "plate.npz")
PLATE_STEPS = 750
PLATE_BOUND = 0.01
PLATE_REST = 1e-2
PLATE_WEIGHT = (0.5 + 0.2) * 9.81
# 14c-d: the leg tasks on legs80 (80 muscles, MyoLeg's width), each at
# B = 16 for 5 control steps on the card and the CPU with the same draws,
# then B_MAIN envs for LEG_STEPS control steps with every episode clock
# set to cross its horizon inside the window. 14c holds the median env to
# the larger of phase 5's bound and FLOAT32_MARGIN times the CPU float32
# run's median env (feet on rubble amplify float32 rounding: that median
# alone reaches 1.4e-4 in qpos on the rough terrain, against phase 5's
# 1e-4). An env past that bound "flips", as a lane does in 13a: a foot on
# a cell boundary or a stair edge can take another cell in float32, and
# the standing legs' contacts then part ways (worst envs 1.5e-4 to 4.9e-2
# in qpos over calls, CPU float32 1.5e-4 to 3.2e-2). The card may flip
# no more envs than the CPU float32 run plus LEG_FLIP_SLACK (two of 16)
LEG_TASKS = ("legs80StandRandom-v0", "legs80Walk-v0",
             "legs80RoughTerrainWalk-v0", "legs80StairTerrainWalk-v0",
             "legs80ChaseTagP2-v0")
# (5 keeps the whole command under 1,000 s with phase 17)
LEG_STEPS = 5
LEG_FLIP_SLACK = 0.125
LEG_SENSORS = ("r_foot", "r_toes", "l_foot", "l_toes")
# 14e: tools/profile_step.py on this task, once
PROFILE_ENV = "legs80Walk-v0"

# phase 15: mesh hulls and the rest of the hand and arm tasks. 15a runs the
# four mesh pairs on seeded poses against the hulls scene's hull with 13a's
# bounds and flip rule; 15b the hulls scene through Physics (free bodies
# dropping onto a convex mesh slab), 16 x HULLS_STEPS against the CPU, then
# B_MAIN x HULLS_WINDOW, failing unless the bodies rest; 15c-d the tasks
# below, 16 x 5 steps against the CPU (14c's rule), then B_MAIN x
# HAND_ARM_STEPS control steps; 15e profile_step on PROFILE_ARM_ENV.
HULLS = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets", "hulls.npz")
HULLS_STEPS = 50
HULLS_WINDOW = 120
HULLS_REST = 0.05
HAND_ARM_TASKS = ("hand23BaodingP2-v1", "arm27RelocateP2-v0",
                  "arm27Bimanual-v0", "hand23Reorient100-v0")
# (5 keeps the whole command under 1,000 s with phases 17 and 18)
HAND_ARM_STEPS = 5
PROFILE_ARM_ENV = "arm27RelocateP2-v0"
# phase 16: the OSL RunTrack and MyoDM tracking tasks. 16a holds the OSL
# machine on the card (float32) against the port's float64 on the CPU on
# OSL_SAMPLES seeded sensor vectors: the states equal, the torques within
# OSL_TORQUE_BOUND (N m; float32 rounding of torques up to 168 N m); 16b
# runs the tasks below 16 x 5 steps against the CPU (14c's rule); 16c
# B_MAIN envs for OSL_TRACK_STEPS control steps with every episode clock
# crossing its horizon inside the window.
OSL_SAMPLES = 4096
OSL_TORQUE_BOUND = 1e-3
OSL_TRACK_TASKS = ("osl54OslRunFixed-v0", "osl54OslRunRandom-v0",
                   "track29CubesmallFixed-v0", "track29CubesmallRandom-v0",
                   "track29CubesmallLift-v0")
# 16c's tasks: both OSL ids and two of the tracking ids (Fixed ends every
# episode at its first step, as the reference's does: its object starts
# 0.57 m from its target)
OSL_TRACK_RATE_TASKS = ("osl54OslRunFixed-v0", "osl54OslRunRandom-v0",
                        "track29CubesmallRandom-v0", "track29CubesmallLift-v0")
# (5 keeps the whole command under 1,000 s with phase 17)
OSL_TRACK_STEPS = 5
# the general kernel (csrc/spd_solve_general.cu): float64 with n <= 64 in
# registers at these padded sizes (route (a)), float32 at any n and float64
# above 64 in a shared-memory tile (route (b)) up to its limit (n 168 in
# float64, 240 in float32 on an H100), in place in L above it (route (c)).
# Phase 3 holds it at both ends of every padded size and on both sides of
# each route switch, at one system, phase 17's B = 16, B_MAIN and a ragged
# batch, which covers every size phase 17 launches (23, 72); float32 below
# 65 only through spd_solve_general_cuda itself (the dispatch sends it to
# the register kernel)
GENERAL_PADDED_SIZES = (8, 16, 24, 32, 48, 64)
GENERAL_F64_SIZES = (1, 8, 9, 16, 17, 23, 24, 25, 32, 33, 48, 49, 64, 65, 72,
                     128, 168, 169, 200)
GENERAL_F32_SIZES = (65, 72, 128, 239, 240, 241, 256)
GENERAL_F32_DIRECT_SIZES = (1, 23, 35, 50, 64)
GENERAL_BATCHES = (1, 16, B_MAIN, B_MAIN + 1)
# the clamp cases (``_clamp_systems``) at the ends of each route
GENERAL_CLAMP_SIZES = {torch.float64: (1, 2, 23, 64, 65, 72, 169),
                       torch.float32: (2, 35, 65, 72, 241)}
# the float32 n = 33-64 question: the register kernel (NP 64) against the
# general kernel's float32 route, on the same systems
F32_COMPARE_SIZES = (35, 50)
# above n = 72 the float64 reference solve of a large batch takes seconds:
# there the kernel is held against the plain version only
GENERAL_REF_N = 72
# relative to the largest |x|: a few ulps of each type
GENERAL_BOUND = {torch.float64: 1e-12, torch.float32: RANDOM_BOUND}
# phase 17: (a) the card's float64 against the CPU's, 5 control steps of
# 16 envs; other operation order only, so far below phase 5's float32
# bounds; an env whose contact takes another branch is a flip (phase 13's
# ill-lane rule), allowed in at most F64_FLIP_ENVS envs
F64_STEPS = 5
F64_CARD_CPU_BOUND = {"qpos": 1e-8, "qvel": 1e-6, "act": 1e-9}
F64_FLIP_ENVS = 2
# (b) chain72: B = 16 against the CPU in float64 after CHAIN_STEPS
# substeps; float32 at phase 12's bounds, float64 at 1e-8 / 1e-6
CHAIN72 = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets",
                       "chain72.npz")
CHAIN_STEPS = 20
CHAIN_CPU_BOUND = {torch.float32: FREE_CPU_BOUND,
                   torch.float64: {"qpos": 1e-8, "qvel": 1e-6}}
# (c) IK to a micrometre in at most 100 iterations, in both types; the
# card's float64 IK at B = 16 against the CPU's: the same success and steps,
# and qpos within IK_QPOS_BOUND (IFtip's chain has seven joints for three
# coordinates: the iteration amplifies rounding along its null space, far
# above float64's ulp but far below this bound)
IK_SITE = "IFtip"
IK_TOL = 1e-6
IK_MAX_STEPS = 100
IK_QPOS_BOUND = 1e-6
# (d) the examine commands' tasks: examine_logs records and replays 5
# control steps of the pose task; examine_env rolls out to each episode's
# first done, which track29's Fixed id reaches at its first step
EXAMINE_ENV = "hand23PoseFixed-v0"
EXAMINE_ROLLOUT_ENV = "track29CubesmallFixed-v0"
EXAMINE_TRACK = "track29CubesmallLift-v0"

# phase 18: the reflex walker, its tuner, the gym adapter, the CNN
# encoder, the data-parallel learners and the tools. (a) reflex_update on
# seeded float32 inputs, card float32 against CPU float64 (the same
# inputs and control parameters): the flags equal, the stimulations in
# [0.01, 1] within a few float32 ulps
REFLEX_SAMPLES = 4096
REFLEX_STIM_BOUND = 1e-5
# (b) walkers at B = 512 for REFLEX_TICKS control ticks (5 substeps each);
# 4 walkers, each its own gains, for REFLEX_CPU_TICKS against the CPU
# (float64, in the worker) within phase 5's bounds on qpos and qvel
REFLEX_WALKERS = 512
REFLEX_TICKS = 20
REFLEX_CPU_WALKERS = 4
REFLEX_CPU_TICKS = 5
# (c) the CEM tuner: 2 generations of 128 walkers, 10 ticks each
TUNE_ARGS = ["--generations", "2", "--pop", "128", "--elite", "16",
             "--ticks", "10"]
# (d) the gym surface on hand23's pose id: one env for 5 steps, 4096 for
# 3; the CNN encoder on 64 frames of 84 x 84, card float32 against CPU
# float64 (relative to the largest feature)
GYM_ENV = "hand23PoseFixed-v0"
GYM_STEPS = 5
GYM_VEC_STEPS = 3
CNN_FRAMES = 64
CNN_BOUND = 1e-5
# (e) the CLI's --mesh data at world size 1 on NCCL: NPG and PPO, one
# iteration each at 32 envs, the pose task's horizon cut to MESH_HORIZON
# (and PPO's unroll with it; 2 epochs of 2 minibatches, so the minibatch
# moments and the gradient all-reduce run 4 times); the sharded state
# against the unsharded learner's from the same seed, the largest
# parameter difference over the largest parameter change. One process
# reduces its share with the plain learner's own calls, so the two are
# one computation: the bound leaves room only for a kernel whose sum
# order varies from run to run
MESH_ENVS = 32
MESH_HORIZON = 5
MESH_PPO = dict(unroll_length=MESH_HORIZON, num_minibatches=2,
                update_epochs=2)
MESH_BOUND = 1e-6
# (f) train_zoo_baseline: one PPO iteration of 16 envs x 5 steps;
# convergence_study on the hold scene
ZOO_ARGS = ["--env", GYM_ENV, "--algo", "ppo", "--total-steps", "80",
            "--eval-every", "0", "--config",
            '{"num_envs": 16, "unroll_length": 5, "data_groups": 1, '
            '"num_minibatches": 4}']
CONVERGENCE_ARGS = ["--env", "hand23ObjHoldRandom-v0", "--batch", "512",
                    "--steps", "5"]
# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s, and FLOP/s
# outside the tensor cores in float32 and in float64, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12


def _say(*args):
  print(*args, flush=True)


def phase_device() -> str:
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device visible; this run needs one")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]
  _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
       f"devices {torch.cuda.device_count()}")
  return smi


def _ptxas_report(log: str) -> dict:
  """Registers and spill bytes per padded size from ``ptxas -v`` output."""
  out, size = {}, None
  for ln in log.splitlines():
    m = re.search(r"spd_solve_kernelILi(\d+)ELi(\d+)ELi(\d+)E", ln)
    if "Compiling entry function" in ln and m:
      size = int(m.group(1))
      out[size] = {"lanes": int(m.group(2)), "systems": int(m.group(3))}
    elif size is not None:
      if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        ln):
        out[size]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
      if m := re.search(r"Used (\d+) registers", ln):
        out[size]["registers"] = int(m.group(1))
  return out


def _ptxas_general(log: str) -> dict:
  """Registers and spill bytes of each instance of the general kernel, by
  route and padded size or type: ``reg NP=24 float64 (G 8, SB 8)``,
  ``tile float32``, ``inplace float64``. Only an entry's own "Function
  properties" block counts (ptxas prints one for each subroutine too)."""
  types = {"f": "float32", "d": "float64"}
  out, kind, entry = {}, None, None
  for ln in log.splitlines():
    if "Compiling entry function" in ln:
      kind = None
      entry = re.search(r"'([^']+)'", ln).group(1)
      if m := re.search(r"reg_kernelILi(\d+)ELi(\d+)ELi(\d+)E", ln):
        kind = (f"reg NP={m.group(1)} float64 (G {m.group(2)}, SB "
                f"{m.group(3)})")
      elif m := re.search(r"(tile|inplace)_kernelI([fd])E", ln):
        kind = f"{m.group(1)} {types[m.group(2)]}"
      if kind is not None:
        out[kind] = {}
      own = True
    elif "Function properties for" in ln:
      own = ln.rstrip().endswith(entry)
    elif kind is not None:
      m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
      if m and own:
        out[kind]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
      if m := re.search(r"Used (\d+) registers", ln):
        out[kind]["registers"] = int(m.group(1))
  return out


def phase_build():
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  # one nvcc per source, started together
  with concurrent.futures.ThreadPoolExecutor(2) as ex:
    builds = [ex.submit(cuda_linalg.build, source=src)
              for src in (cuda_linalg.SOURCE, cuda_linalg.GENERAL_SOURCE)]
    (path, seconds, log), (gpath, gseconds, glog) = [b.result()
                                                     for b in builds]
  for p, sec in ((path, seconds), (gpath, gseconds)):
    _say(f"build: {sec:.2f} s -> {os.path.relpath(p, ROOT)}"
         f"{'' if sec else ' (already built)'}")
  general = _ptxas_general(glog)
  expected = ([f"reg NP={np_} float64" for np_ in GENERAL_PADDED_SIZES]
              + [f"{r} {t}" for r in ("tile", "inplace")
                 for t in ("float32", "float64")])
  found = [k.split(" (")[0] for k in general]
  if sorted(found) != sorted(expected):
    raise AssertionError(f"ptxas reported general kernel instances "
                         f"{sorted(general)}, expected {sorted(expected)}")
  for kind, rep in general.items():
    _say(f"build: general kernel, {kind}: {rep.get('registers')} registers, "
         f"{rep.get('spill_bytes')} bytes spilled")
  spilled = [k for k, rep in general.items() if rep.get("spill_bytes") != 0]
  if spilled:
    raise AssertionError(f"the general kernel spills in {spilled} (or no "
                         f"report)")
  report = _ptxas_report(log)
  if sorted(report) != list(PADDED_SIZES):
    raise AssertionError(f"ptxas reported sizes {sorted(report)}, expected "
                         f"{PADDED_SIZES}")
  for size, rep in sorted(report.items()):
    _say(f"build: NP={size}, {rep['lanes']} lanes per system, "
         f"{rep['systems']} systems per block: {rep.get('registers')} "
         f"registers, {rep.get('spill_bytes')} bytes spilled")
    if rep.get("spill_bytes") != 0:
      raise AssertionError(f"NP={size} spills registers (or no report)")
  return general


def _time_ms(fn, reps: int = 50) -> float:
  """ms per eager call: CUDA events around ``reps`` calls."""
  for _ in range(5):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 50, replays: int = 10) -> float:
  """ms per launch: ``reps`` calls captured in one CUDA graph, replayed
  ``replays`` times between two events. Inputs stay warm in L2, as on the
  main path, where A is written just before the solve."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(reps):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(replays):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (reps * replays)


def _bound_ms(a: torch.Tensor, b: torch.Tensor, factor: bool = False):
  """Least time for the solve: A, b read and x (and L) written once over HBM
  rate, against 2n^3/3 + 2n^2 flops per system over the peak of a's type."""
  batch, n = b.shape
  nbytes = (2 * a.numel() if factor else a.numel()) + 2 * b.numel()
  t_bytes = nbytes * a.element_size() / HBM_BYTES_PER_S
  peak = FP64_FLOPS if a.dtype == torch.float64 else FP32_FLOPS
  t_ops = batch * (2 * n ** 3 / 3 + 2 * n ** 2) / peak
  return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _rollout_systems(batch: int):
  """M, M + h D and Newton H (active contacts) from a hand23 rollout."""
  from myosuite_mjx_tpu_torch.engine import collision, constraint
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  env = PoseEnv(HAND23, **HAND_POSE_FIXED)
  benv = BatchedEnv(env, batch, DEVICE, seed=1)
  st = benv.init()
  g = torch.Generator(device=DEVICE).manual_seed(1)
  for _ in range(3):
    st = benv.step(st, torch.rand((batch, env.action_dim), generator=g,
                                  device=DEVICE))
  d, m = st.data, env.device_model(DEVICE)
  blocks, info = collision.contacts(m, d)
  J, aref, D, is_eq, _, _ = constraint.make_efc(m, d, blocks)
  jar = (J @ d.qacc[..., None])[..., 0] - aref
  w = D * (is_eq | (jar < 0))
  if not bool((w > 0).any()):
    raise AssertionError("no active constraint row in the rollout state")
  H = d.qM + (J.transpose(-1, -2) * w[:, None, :]) @ J
  mhd = d.qM + m.opt.timestep * torch.diag(m.dof_damping)
  return {"M": d.qM, "M+hD": mhd, "H": H}, d.qfrc_smooth


def _random_spd(n: int, batch: int, g: torch.Generator):
  r = torch.randn(batch, n, n, generator=g, dtype=torch.float64,
                  device=DEVICE)
  eye = torch.eye(n, dtype=torch.float64, device=DEVICE)
  b = torch.randn(batch, n, generator=g, dtype=torch.float64, device=DEVICE)
  return r @ r.transpose(1, 2) / n + eye, b


def _random_errors(a64, b64, a=None):
  """Kernel vs plain (x, factor) and vs float64 solve, each relative to the
  largest entry; also the largest absolute difference of x from plain."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
  a = a64.float() if a is None else a
  b = b64.float()
  x, L = cuda_linalg.spd_solve_cuda(a, b, factor=True)
  xp, Lp = linalg.spd_solve_plain(a, b, factor=True)
  ref = torch.linalg.solve(a64, b64)
  torch.cuda.synchronize()
  diff = float((x - xp).abs().max())
  return (diff / float(xp.abs().max()),
          float((L - Lp).abs().max()) / float(Lp.abs().max()),
          float((x.double() - ref).abs().max()) / float(ref.abs().max()),
          diff)


def phase_kernel_check() -> dict:
  from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
  g = torch.Generator(device=DEVICE).manual_seed(0)
  worst_main = 0.0
  for n in SIZES:
    worst = [0.0, 0.0, 0.0]
    for batch in BATCHES:
      errs = _random_errors(*_random_spd(n, batch, g))
      worst = [max(w, e) for w, e in zip(worst, errs)]
      if max(errs[:3]) > RANDOM_BOUND:
        raise AssertionError(f"kernel disagrees at n={n} B={batch}: {errs}")
      if (n, batch) == (23, 4096):
        worst_main = max(worst_main, errs[3])
    _say(f"kernel n={n} B={BATCHES}: rel err vs plain {worst[0]:.3e}, "
         f"factor {worst[1]:.3e}, vs float64 solve {worst[2]:.3e} "
         f"(bound {RANDOM_BOUND:g}) ok")
  # a contiguous view 4 bytes past a 16-byte boundary: the plain load
  a64, b64 = _random_spd(23, B_MAIN, g)
  big = torch.empty(a64.numel() + 1, device=DEVICE)
  view = big[1:].view(a64.shape)
  view.copy_(a64)
  if view.data_ptr() % 16 != 4:
    raise AssertionError("the misaligned view is not misaligned")
  errs = _random_errors(a64, b64, view)
  if max(errs[:3]) > RANDOM_BOUND:
    raise AssertionError(f"kernel disagrees on the misaligned view: {errs}")
  worst_main = max(worst_main, errs[3])
  _say(f"kernel n=23 B={B_MAIN} misaligned view: rel err vs plain "
       f"{errs[0]:.3e}, factor {errs[1]:.3e}, vs float64 solve {errs[2]:.3e}"
       f" ok")

  for batch in PATH_BATCHES:
    systems, rhs = _rollout_systems(batch)
    for name, a in systems.items():
      a = a.contiguous()
      x = cuda_linalg.spd_solve_cuda(a, rhs)
      xp = linalg.spd_solve_plain(a, rhs)
      ref = torch.linalg.solve(a.double(), rhs.double())
      torch.cuda.synchronize()

      def backward_err(sol):
        res = (a.double() @ sol.double()[..., None])[..., 0] - rhs.double()
        an = a.double().abs().sum(-1).amax(-1)
        return float((res.abs().amax(-1) / (an * sol.double().abs().amax(-1)
                                            + 1e-300)).max())

      be, bp = backward_err(x), backward_err(xp)
      cond = float(torch.linalg.cond(a.double()).max())
      e_ref = float(((x.double() - ref).abs().amax(-1)
                     / ref.abs().amax(-1).clamp_min(1e-300)).max())
      ok = max(be, bp) <= BACKWARD_BOUND
      _say(f"kernel on hand23 {name} [{a.shape[0]}, {a.shape[1]}]: backward "
           f"err kernel {be:.3e}, plain {bp:.3e} (bound {BACKWARD_BOUND:g}); "
           f"max cond {cond:.3e}; fwd rel err vs float64 {e_ref:.3e} "
           f"{'ok' if ok else 'FAIL'}")
      if not ok:
        raise AssertionError(f"kernel not backward stable on {name} at "
                             f"B={batch}")
      if batch == B_MAIN:
        worst_main = max(worst_main, float((x - xp).abs().max()))

  a64, b64 = _random_spd(23, B_MAIN, g)
  a, b = a64.float(), b64.float()
  fns = {"plain": lambda: linalg.spd_solve_plain(a, b),
         "kernel": lambda: cuda_linalg.spd_solve_cuda(a, b),
         "library": lambda: torch.linalg.solve_ex(a, b),
         "kernel+factor": lambda: cuda_linalg.spd_solve_cuda(a, b, True)}
  times = {"plain": [], "kernel": [], "library": []}
  for which in ("plain", "kernel", "library", "library", "kernel", "plain"):
    times[which].append(_time_ms(fns[which]))
  # one block of 8 systems alone on the card: the latency of one system,
  # below which no batch can go
  a8, b8 = a[:8].contiguous(), b[:8].contiguous()
  fns["one block"] = lambda: cuda_linalg.spd_solve_cuda(a8, b8)
  graph = {"kernel": [], "kernel+factor": [], "one block": []}
  for which in ("kernel", "kernel+factor", "one block", "one block",
                "kernel+factor", "kernel"):
    graph[which].append(_graph_ms(fns[which]))
  bound_ms, bound_by = _bound_ms(a, b)
  bound_factor_ms, _ = _bound_ms(a, b, factor=True)
  out = {"max_abs_err": worst_main,
         "ms": float(np.mean(times["kernel"])),
         "plain_ms": float(np.mean(times["plain"])),
         "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": float(np.mean(times["library"])),
         "graph_ms": float(np.mean(graph["kernel"]))}
  _say(f"spd_solve [4096, 23] float32, eager (CUDA events, 50 calls): kernel "
       f"{times['kernel']} ms, plain {times['plain']} ms, "
       f"torch.linalg.solve_ex {times['library']} ms")
  _say(f"spd_solve [4096, 23] float32, CUDA graph of 50 launches: kernel "
       f"{graph['kernel']} ms, kernel with factor {graph['kernel+factor']} ms; "
       f"one block alone [8, 23]: {graph['one block']} ms")
  _say(f"spd_solve [4096, 23] bound {bound_ms:.6f} ms by {bound_by} "
       f"({bound_factor_ms:.6f} ms with the factor); kernel at "
       f"{bound_ms / out['graph_ms']:.3f} of it, with the factor at "
       f"{bound_factor_ms / float(np.mean(graph['kernel+factor'])):.3f}")
  return out


def _general_errors(a64, b64, dtype, with_ref: bool, a=None, fn=None):
  """General kernel vs plain (x, factor) and, ``with_ref``, vs a float64
  solve (else 0), each relative to the largest entry, on ``dtype`` copies
  of a float64 system (``a``: a view holding them); also the largest
  absolute difference of x from plain. ``fn`` is the wrapper called: the
  dispatch (by default), or ``spd_solve_general_cuda`` itself."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
  fn = fn or cuda_linalg.spd_solve_cuda
  a = a64.to(dtype) if a is None else a
  b = b64.to(dtype)
  x, L = fn(a, b, factor=True)
  x_only = fn(a, b)
  xp, Lp = linalg.spd_solve_plain(a, b, factor=True)
  ref_err = 0.0
  if with_ref:
    ref = torch.linalg.solve(a64, b64)
    ref_err = float((x.double() - ref).abs().max()) / float(ref.abs().max())
  torch.cuda.synchronize()
  if not torch.equal(x, x_only):
    raise AssertionError("the general kernel's x differs with the factor")
  diff = float((x - xp).abs().max())
  return (diff / float(xp.abs().max()),
          float((L - Lp).abs().max()) / float(Lp.abs().max()), ref_err, diff)


def _clamp_systems(n: int, dtype):
  """Systems whose factor meets the clamp: each an SPD background with a
  decoupled block at position p (first, middle, last) that is (0) a zero row
  and column, a pivot of exactly 0; (1) the same with a diagonal of -2^-20,
  a pivot below tiny; (2) [[4, 2], [2, 1]], a pivot that reaches 0; (3)
  [[4, 2], [2, 1 - 2^-20]], a pivot that reaches -2^-20. Every operation on
  the blocks is exact, so both versions meet the same pivots; x is finite
  in (1) and (3), NaN or infinite in (0) and (2)."""
  g = torch.Generator(device=DEVICE).manual_seed(n)
  blocks = ([[0.0]], [[-2.0 ** -20]], [[4.0, 2.0], [2.0, 1.0]],
            [[4.0, 2.0], [2.0, 1.0 - 2.0 ** -20]])
  mats = []
  for blk in blocks:
    size = len(blk)
    for p in sorted({0, (n - size) // 2, n - size}) if n >= size else ():
      r = torch.randn(n, n, generator=g, dtype=torch.float64, device=DEVICE)
      a = r @ r.T / n + torch.eye(n, dtype=torch.float64, device=DEVICE)
      a[p:p + size, :] = 0.0
      a[:, p:p + size] = 0.0
      a[p:p + size, p:p + size] = torch.tensor(blk, dtype=torch.float64)
      mats.append(a)
  a = torch.stack(mats)
  b = torch.randn(a.shape[:2], generator=g, dtype=torch.float64,
                  device=DEVICE)
  return a.to(dtype), b.to(dtype)


def _clamp_errors(a, b) -> tuple:
  """The general kernel against the plain version on ``_clamp_systems``:
  the same NaN and signed-infinity pattern in x; on the finite entries the
  largest difference of x and of L relative to its system's largest entry.
  Returns (x error, L error, finite entries of x, non-finite)."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
  x, L = cuda_linalg.spd_solve_general_cuda(a, b, factor=True)
  x_only = cuda_linalg.spd_solve_general_cuda(a, b)
  xp, Lp = linalg.spd_solve_plain(a, b, factor=True)
  torch.cuda.synchronize()
  if not torch.equal(x.nan_to_num(), x_only.nan_to_num()):
    raise AssertionError("the general kernel's x differs with the factor")
  for what, k, p in (("x", x, xp), ("L", L, Lp)):
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
      if not torch.equal(test(k), test(p)):
        raise AssertionError(f"clamp case: {what} has another "
                             f"{test.__name__[2:]} pattern than the plain "
                             f"version")

  def rel(k, p):
    fin = torch.isfinite(p)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    scale = torch.where(fin, p.abs(), zero).flatten(1).amax(1)
    diff = torch.where(fin, (k - p).abs(), zero).flatten(1).amax(1)
    return float((diff / scale.clamp_min(torch.finfo(p.dtype).tiny)).max())

  fin = int(torch.isfinite(xp).sum())
  return rel(x, xp), rel(L, Lp), fin, xp.numel() - fin


def _general_route(dtype, n: int, limit: int) -> str:
  if dtype == torch.float64 and n <= 64:
    return f"registers, NP {min(p for p in GENERAL_PADDED_SIZES if p >= n)}"
  return "shared tile" if n <= limit else "in place"


def phase_general_check() -> dict:
  """Phase 3, second half: the general kernel at every size and batch of
  GENERAL_*, on misaligned views and on the clamp cases, then its times at
  [4096, 23] float64 and [4096, 72] float32."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
  g = torch.Generator(device=DEVICE).manual_seed(1)
  limits = {dt: cuda_linalg.general_max_shared_n(dt)
            for dt in (torch.float64, torch.float32)}
  _say(f"general kernel: float64 in registers up to n = 64; systems staged "
       f"in shared memory up to n = {limits[torch.float64]} (float64), "
       f"{limits[torch.float32]} (float32); in place in L above")
  n0 = cuda_linalg.spd_solve_general_cuda.launches
  r0 = cuda_linalg.spd_solve_cuda.launches
  worst_abs = {}
  cases = [(torch.float64, n, cuda_linalg.spd_solve_cuda)
           for n in GENERAL_F64_SIZES]
  cases += [(torch.float32, n, cuda_linalg.spd_solve_cuda)
            for n in GENERAL_F32_SIZES]
  cases += [(torch.float32, n, cuda_linalg.spd_solve_general_cuda)
            for n in GENERAL_F32_DIRECT_SIZES]
  for dtype, n, fn in cases:
    bound = GENERAL_BOUND[dtype]
    worst = [0.0, 0.0, 0.0]
    t0 = time.perf_counter()
    for batch in GENERAL_BATCHES:
      errs = _general_errors(*_random_spd(n, batch, g), dtype,
                             batch <= 16 or n <= GENERAL_REF_N, fn=fn)
      worst = [max(w, e) for w, e in zip(worst, errs)]
      # against the float64 solve a float32 result keeps float32's
      # rounding times the condition (random batches: eigenvalues >= 1)
      if max(errs[:2]) > bound or errs[2] > max(bound, RANDOM_BOUND):
        raise AssertionError(f"general kernel disagrees at {dtype} n={n} "
                             f"B={batch}: {errs}")
      if batch == B_MAIN:
        worst_abs[dtype, n] = errs[3]
    _say(f"general kernel {str(dtype)[6:]} n={n} "
         f"({_general_route(dtype, n, limits[dtype])}, {fn.__name__}) "
         f"B={GENERAL_BATCHES}: rel err vs plain {worst[0]:.3e}, factor "
         f"{worst[1]:.3e}, vs float64 solve {worst[2]:.3e} (bound {bound:g})"
         f" ok, {time.perf_counter() - t0:.1f} s")
  # contiguous views one element past a 16-byte boundary: the plain loads
  for dtype, n in ((torch.float64, 23), (torch.float64, 24),
                   (torch.float64, 64), (torch.float32, 72)):
    a64, b64 = _random_spd(n, B_MAIN, g)
    big = torch.empty(a64.numel() + 1, dtype=dtype, device=DEVICE)
    view = big[1:].view(a64.shape)
    view.copy_(a64)
    if view.data_ptr() % 16 == 0:
      raise AssertionError("the misaligned view is aligned")
    errs = _general_errors(a64, b64, dtype, True, view)
    if max(errs[:2]) > GENERAL_BOUND[dtype] or errs[2] > RANDOM_BOUND:
      raise AssertionError(f"general kernel disagrees on the misaligned "
                           f"view {dtype} n={n}: {errs}")
    _say(f"general kernel {str(dtype)[6:]} n={n} B={B_MAIN} misaligned view: "
         f"rel err vs plain {errs[0]:.3e}, factor {errs[1]:.3e}, vs float64 "
         f"solve {errs[2]:.3e} ok")
  clamp_launches = 0
  for dtype, sizes in GENERAL_CLAMP_SIZES.items():
    bound = GENERAL_BOUND[dtype]
    for n in sizes:
      a, b = _clamp_systems(n, dtype)
      ex, el, fin, nonfin = _clamp_errors(a, b)
      clamp_launches += 2
      _say(f"general kernel clamp cases {str(dtype)[6:]} n={n} "
           f"({_general_route(dtype, n, limits[dtype])}) B={a.shape[0]}: "
           f"NaN and inf patterns equal ({nonfin} entries of x non-finite, "
           f"{fin} finite); rel err per system vs plain x {ex:.3e}, factor "
           f"{el:.3e} (bound {bound:g}) {'ok' if max(ex, el) <= bound else 'FAIL'}")
      if max(ex, el) > bound:
        raise AssertionError(f"general kernel disagrees on the clamp cases "
                             f"at {dtype} n={n}")
  checked = cuda_linalg.spd_solve_general_cuda.launches - n0
  expected = 2 * (len(cases) * len(GENERAL_BATCHES) + 4) + clamp_launches
  if checked != expected or cuda_linalg.spd_solve_cuda.launches != r0:
    raise AssertionError(f"general kernel launches {checked} (expected "
                         f"{expected}); register kernel launches "
                         f"{cuda_linalg.spd_solve_cuda.launches - r0} "
                         f"(expected 0)")

  out = {}
  for dtype, n in ((torch.float64, 23), (torch.float32, 72)):
    a64, b64 = _random_spd(n, B_MAIN, g)
    a, b = a64.to(dtype), b64.to(dtype)
    fns = {"plain": lambda: linalg.spd_solve_plain(a, b),
           "kernel": lambda: cuda_linalg.spd_solve_general_cuda(a, b),
           "library": lambda: torch.linalg.solve_ex(a, b),
           "kernel+factor": lambda: cuda_linalg.spd_solve_general_cuda(
               a, b, True)}
    times = {"plain": [], "kernel": [], "library": []}
    for which in ("plain", "kernel", "library", "library", "kernel",
                  "plain"):
      times[which].append(_time_ms(fns[which],
                                   reps=10 if which == "plain" else 50))
    graph = {"kernel": [], "kernel+factor": []}
    for which in ("kernel", "kernel+factor", "kernel+factor", "kernel"):
      graph[which].append(_graph_ms(fns[which]))
    bound_ms, bound_by = _bound_ms(a, b)
    bound_factor_ms, _ = _bound_ms(a, b, factor=True)
    name = f"{str(dtype)[6:]} [{B_MAIN}, {n}]"
    _say(f"spd_solve_general {name}, eager (CUDA events): kernel "
         f"{times['kernel']} ms, plain {times['plain']} ms, "
         f"torch.linalg.solve_ex {times['library']} ms")
    _say(f"spd_solve_general {name}, CUDA graph of 50 launches: kernel "
         f"{graph['kernel']} ms, with factor {graph['kernel+factor']} ms; "
         f"bound {bound_ms:.6f} ms by {bound_by} ({bound_factor_ms:.6f} ms "
         f"with the factor); kernel at "
         f"{bound_ms / float(np.mean(graph['kernel'])):.3f} of it")
    out[str(dtype)[6:]] = {
        "ms": float(np.mean(times["kernel"])),
        "plain_ms": float(np.mean(times["plain"])),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": float(np.mean(times["library"])),
        "graph_ms": float(np.mean(graph["kernel"])),
        "max_abs_err": worst_abs[dtype, n]}
  # the line's numbers: the main shape of the general kernel's own path,
  # [4096, 23] float64 (phase 17's env and IK); [4096, 72] float32 beside
  main = dict(out["float64"])
  main["float32_n72"] = out["float32"]
  return main


def phase_f32_compare() -> dict:
  """Phase 3, last: the register kernel (padded to NP 64) against the
  general kernel's float32 route on the same [B_MAIN, n] systems, n in
  F32_COMPARE_SIZES, each held against the plain version and timed as 50
  launches in a CUDA graph, in turns."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
  g = torch.Generator(device=DEVICE).manual_seed(2)
  out = {}
  for n in F32_COMPARE_SIZES:
    a64, b64 = _random_spd(n, B_MAIN, g)
    a, b = a64.float(), b64.float()
    fns = {"register": lambda: cuda_linalg.spd_solve_cuda(a, b),
           "general": lambda: cuda_linalg.spd_solve_general_cuda(a, b)}
    xp = linalg.spd_solve_plain(a, b)
    for which, fn in fns.items():
      err = float((fn() - xp).abs().max()) / float(xp.abs().max())
      if err > RANDOM_BOUND:
        raise AssertionError(f"{which} kernel disagrees at [{B_MAIN}, {n}]: "
                             f"{err}")
    graph = {"register": [], "general": []}
    for which in ("register", "general", "general", "register"):
      graph[which].append(_graph_ms(fns[which]))
    bound_ms, bound_by = _bound_ms(a, b)
    _say(f"float32 [{B_MAIN}, {n}], CUDA graph of 50 launches: register "
         f"kernel (NP 64) {graph['register']} ms, general kernel (shared "
         f"tile) {graph['general']} ms; bound {bound_ms:.6f} ms by "
         f"{bound_by}")
    out[str(n)] = {"register_graph_ms": float(np.mean(graph["register"])),
                   "general_graph_ms": float(np.mean(graph["general"])),
                   "bound_ms": bound_ms}
  return out


def phase_kernels() -> dict:
  """Phase 3: the register kernel, the general kernel, then the two on
  float32 systems with 33 <= n <= 64."""
  out = {}
  for name, fn in (("spd_solve", phase_kernel_check),
                   ("spd_solve_general", phase_general_check),
                   ("f32_compare", phase_f32_compare)):
    t0 = time.perf_counter()
    out[name] = fn()
    _say(f"phase 3, {name}: {time.perf_counter() - t0:.1f} s")
  return out


def phase_main_path() -> dict:
  from myosuite_mjx_tpu_torch.engine import solver
  from myosuite_mjx_tpu_torch.envs import base
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  env = PoseEnv(HAND23, **HAND_POSE_FIXED)
  if not base.precision_pinned():
    raise AssertionError("float32 matmul precision is not pinned")
  g = torch.Generator(device=DEVICE).manual_seed(0)
  torch.cuda.synchronize()

  cuda_linalg.spd_solve_cuda.launches = 0
  solver.newton_host_syncs.count = 0
  benv = base.BatchedEnv(env, B_MAIN, DEVICE, seed=0)
  state = benv.init()
  restarted = torch.zeros(B_MAIN, dtype=torch.bool, device=DEVICE)
  restarts = torch.zeros((), dtype=torch.int64, device=DEVICE)
  t0 = None
  for i in range(STEPS):
    if i == WARMUP:
      torch.cuda.synchronize()
      syncs0 = solver.newton_host_syncs.count
      t0 = time.perf_counter()
    action = torch.rand((B_MAIN, env.action_dim), generator=g, device=DEVICE)
    state = benv.step(state, action)
    ended = state.info["terminated"] | state.info["truncated"]
    restarted |= ended
    restarts += ended.sum()
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = cuda_linalg.spd_solve_cuda.launches
  syncs = solver.newton_host_syncs.count - syncs0

  for name, x in (("obs", state.obs), ("reward", state.reward),
                  ("qpos", state.data.qpos)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"non-finite {name} after the rollout")
  restarts = int(restarts)
  if not bool(restarted.all()):
    raise AssertionError(f"{int((~restarted).sum())} envs never reset")
  if launches <= 0:
    raise AssertionError("the main path never launched the kernel")
  if not base.precision_pinned():
    raise AssertionError("float32 matmul precision lost its pin")
  timed = STEPS - WARMUP
  ctrl_rate = timed * B_MAIN / seconds
  _say(f"main path: hand23 PoseEnv B={B_MAIN}, {STEPS} control steps "
       f"(frame_skip {env.frame_skip}), autoreset {restarts} envs, "
       f"ne_active mean {float(state.data.ne_active.float().mean()):.2f}, "
       f"reward mean {float(state.reward.mean()):.4f}")
  _say(f"main path: spd_solve launches {launches}; Newton host syncs "
       f"{syncs / timed:.2f} per control step; {timed} timed steps in "
       f"{seconds:.3f} s: {ctrl_rate * env.frame_skip:.1f} physics-steps/s, "
       f"{ctrl_rate:.1f} control-steps/s")
  return {"launches": launches,
          "physics_steps_per_s": ctrl_rate * env.frame_skip}


def phase_card_vs_cpu():
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  B = 16
  actions = np.random.default_rng(0).uniform(0.0, 1.0, (5, B, 39))
  out = {}
  for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float64)):
    benv = BatchedEnv(PoseEnv(HAND23, dtype=dtype, **HAND_POSE_FIXED), B,
                      device)
    st = benv.init()
    for a in actions:
      st = benv.step(st, torch.as_tensor(a, dtype=dtype, device=device))
    out[dtype] = st.data
  for f, bound in CARD_CPU_BOUND.items():
    card = getattr(out[torch.float32], f).double().cpu()
    cpu = getattr(out[torch.float64], f)
    err = float((card - cpu).abs().max())
    ok = err <= bound
    _say(f"card float32 vs cpu float64, {f}: max abs err {err:.3e} "
         f"(bound {bound:g}, peak |{f}| {float(cpu.abs().max()):.3f}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"card and CPU disagree on {f}")


NPG_PARTS = ("rollout", "gae", "natural_gradient", "fit_value")
PPO_PARTS = ("rollout", "normalize", "gae", "update")


def _timed(cls, names: tuple):
  """``cls`` with CUDA syncs at the edges of ``init`` and of each method in
  ``names``, and the seconds and SPD-kernel launches of each: those of
  ``init`` in ``self.init_part``, the others in ``self.parts[-1]``, the
  record that each call of ``names[0]`` opens for its iteration."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg

  class Timed(cls):
    def __init__(self, *args, **kwargs):
      super().__init__(*args, **kwargs)
      self.init_part: dict = {}
      self.parts: list[dict] = []

  def wrap(name):
    def timed(self, *args, **kwargs):
      if name == names[0]:
        self.parts.append({})
      rec = self.init_part if name == "init" else self.parts[-1]
      torch.cuda.synchronize()
      n0, t0 = cuda_linalg.spd_solve_cuda.launches, time.perf_counter()
      out = getattr(super(Timed, self), name)(*args, **kwargs)
      torch.cuda.synchronize()
      rec[name] = time.perf_counter() - t0
      rec[f"{name}_launches"] = cuda_linalg.spd_solve_cuda.launches - n0
      return out
    return timed

  for name in ("init", *names):
    setattr(Timed, name, wrap(name))
  return Timed


def _state_copy(module) -> dict:
  return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _flat_params(module) -> torch.Tensor:
  return torch.nn.utils.parameters_to_vector(module.parameters()).detach()


def _checked_npg():
  """``NPG`` timed by part. It also measures the realized mean KL of each
  natural-gradient step, and keeps in ``replay`` the state, batch and
  permutations that iteration 0's step and value fit start from, and the
  policy and alpha of its step."""
  from myosuite_mjx_tpu_torch.train.npg import NPG

  class CheckedNPG(_timed(NPG, (*NPG_PARTS, "eval_step"))):
    replay: dict | None = None

    def natural_gradient(self, ts, batch):
      with torch.no_grad():
        mean0, log_std0 = ts.params(batch["obs"])
      first = self.replay is None
      if first:
        self.replay = dict(
            policy=_state_copy(ts.params), vf=_state_copy(ts.vf_params),
            opt=copy.deepcopy(ts.vf_opt.state_dict()),
            batch={k: v.detach().clone() for k, v in batch.items()})
      out = super().natural_gradient(ts, batch)
      with torch.no_grad():
        kl = self.mean_kl(ts.params, batch, mean0, log_std0)
      self.parts[-1]["kl"] = float(kl)
      if first:
        self.replay.update(policy_after=_flat_params(ts.params).clone(),
                           alpha=float(out["kl_step_alpha"]))
      return out

    def fit_value(self, ts, batch, perms):
      self.replay.setdefault("perms", perms.clone())
      return super().fit_value(ts, batch, perms)

  return CheckedNPG


def _replay_npg_update(cfg, replay: dict, device, dtype) -> dict:
  """Iteration 0's natural-gradient step, and the first
  ``VF_REPLAY_MINIBATCHES`` minibatches of its value fit, again from the
  state, batch and permutation the card used, on ``device`` in ``dtype``."""
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  from myosuite_mjx_tpu_torch.train.npg import NPG, NPGState
  from myosuite_mjx_tpu_torch.train.common import adam
  from myosuite_mjx_tpu_torch.train.ppo import RunningNorm
  npg = NPG(PoseEnv(HAND23, dtype=dtype, **HAND_POSE_FIXED), cfg, device)
  obs_dim = replay["batch"]["obs"].shape[-1]
  policy, vf = npg.make_nets(obs_dim, torch.Generator(device=device))
  policy.load_state_dict(replay["policy"])
  vf.load_state_dict(replay["vf"])
  opt = adam(vf, cfg.vf_learning_rate)
  # a copy: in the same dtype the loaded moments would alias the snapshot's
  opt.load_state_dict(copy.deepcopy(replay["opt"]))
  # the batch holds normalized obs: neither part reads obs_norm
  ts = NPGState(params=policy, vf_params=vf, vf_opt=opt,
                steps=torch.zeros((), dtype=torch.int64, device=device),
                obs_norm=RunningNorm.create(obs_dim, dtype, device))
  batch = {k: v.to(device, dtype) for k, v in replay["batch"].items()}
  out = dict(policy_before=_flat_params(policy).clone(),
             vf_before=_flat_params(vf).clone())
  step = npg.natural_gradient(ts, batch)
  out.update(policy_after=_flat_params(policy).clone(),
             alpha=float(step["kl_step_alpha"]))
  perm = replay["perms"][:1, :VF_REPLAY_MINIBATCHES * cfg.vf_batch_size]
  npg.fit_value(ts, batch, perm.to(device))
  out["vf_after"] = _flat_params(vf).clone()
  return out


def _npg_update_errors(cfg, replay: dict) -> dict:
  """Iteration 0's update on the card in float32 against its replay on the
  CPU in float64: the natural-gradient step the card took in training, and
  the start of the value fit replayed on both. Each is the largest
  parameter difference over the largest parameter change on the CPU; alpha
  relative."""
  cpu = _replay_npg_update(cfg, replay, "cpu", torch.float64)
  card = _replay_npg_update(cfg, replay, DEVICE, torch.float32)

  def rel(after, ref_before, ref_after):
    return float((after.double().cpu() - ref_after).abs().max()
                 / (ref_after - ref_before).abs().max())

  return {"policy": rel(replay["policy_after"], cpu["policy_before"],
                        cpu["policy_after"]),
          "alpha": abs(replay["alpha"] - cpu["alpha"]) / cpu["alpha"],
          "value": rel(card["vf_after"], cpu["vf_before"], cpu["vf_after"])}


def _moved(before: dict, module) -> bool:
  """Parameters changed from ``before`` and all finite."""
  after = module.state_dict()
  return (any(not torch.equal(before[k], v) for k, v in after.items())
          and all(bool(torch.isfinite(v).all()) for v in after.values()))


def phase_train() -> dict:
  from myosuite_mjx_tpu_torch.envs import base
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  from myosuite_mjx_tpu_torch.train import metrics
  from myosuite_mjx_tpu_torch.train.npg import NPGConfig
  from myosuite_mjx_tpu_torch.train.ppo import PPO, PPOConfig
  env = PoseEnv(HAND23, **HAND_POSE_FIXED)
  npg = _checked_npg()(env, NPGConfig(num_envs=NPG_ENVS), DEVICE)
  cfg, per_iter = npg.cfg, NPG_ENVS * npg.horizon
  torch.cuda.synchronize()

  cuda_linalg.spd_solve_cuda.launches = 0
  with tempfile.TemporaryDirectory() as logdir:
    with metrics.MetricsWriter(logdir) as writer:
      ts, history = npg.train(NPG_ITERS * per_iter, seed=TRAIN_SEED,
                              eval_every=NPG_ITERS, writer=writer)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
      records = [json.loads(ln) for ln in f]
  npg_launches = cuda_linalg.spd_solve_cuda.launches
  _say(f"train NPG init: {npg.init_part['init']:.3f} s, spd_solve launches "
       f"{npg.init_part['init_launches']}")
  for it, (rec, parts) in enumerate(zip(history, npg.parts)):
    step_s = sum(parts[k] for k in NPG_PARTS)
    rate = per_iter / step_s
    _say(f"train NPG iter {it}: {NPG_ENVS} x {npg.horizon} = {per_iter} env "
         f"steps; train step {step_s:.3f} s: {rate:.1f} env-steps/s, "
         f"{rate * env.frame_skip:.1f} physics-steps/s; rollout spd_solve "
         f"launches {parts['rollout_launches']}")
    _say(f"train NPG iter {it} parts (s): rollout {parts['rollout']:.3f}, "
         f"gae {parts['gae']:.4f}, natural_gradient "
         f"{parts['natural_gradient']:.4f}, fit_value {parts['fit_value']:.3f}")
    if "eval_step" in parts:
      _say(f"train NPG iter {it} eval: 32 envs x {npg.horizon} steps in "
           f"{parts['eval_step']:.3f} s, spd_solve launches "
           f"{parts['eval_step_launches']}")
    _say(f"train NPG iter {it}: realized mean KL {parts['kl']:.5f} beside "
         f"step_size {cfg.step_size} (bound +-{KL_BAND:.0%}; kl_step_alpha "
         f"{rec['kl_step_alpha']:.5f})")
    _say(f"train NPG iter {it} metrics: " + json.dumps(
        {k: v for k, v in rec.items() if k != "wall"}))
  _say(f"train NPG: spd_solve launches {npg_launches} (init, rollouts, eval)")

  t0 = time.perf_counter()
  errs = _npg_update_errors(cfg, npg.replay)
  for what, err in errs.items():
    _say(f"train NPG iter 0 card float32 vs cpu float64, same state, batch "
         f"and permutations, {what}: rel err {err:.3e} (bound "
         f"{NPG_UPDATE_BOUND[what]:g}) "
         f"{'ok' if err <= NPG_UPDATE_BOUND[what] else 'FAIL'}")
  _say(f"train NPG: the replays took {time.perf_counter() - t0:.3f} s")

  class CheckedPPO(_timed(PPO, PPO_PARTS)):
    def init(self, *args, **kwargs):
      ts = super().init(*args, **kwargs)
      self.before = _state_copy(ts.params)
      return ts

  ppo = CheckedPPO(env, PPOConfig(), DEVICE)
  ppo_cfg = ppo.cfg
  ppo_iter = ppo_cfg.num_envs * ppo_cfg.unroll_length
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  pts, ppo_history = ppo.train(ppo_iter, seed=TRAIN_SEED)
  ppo_launches = cuda_linalg.spd_solve_cuda.launches
  parts = ppo.parts[0]
  ppo_s = sum(parts[k] for k in PPO_PARTS)
  rate = ppo_iter / ppo_s
  _say(f"train PPO init: {ppo.init_part['init']:.3f} s, spd_solve launches "
       f"{ppo.init_part['init_launches']}")
  _say(f"train PPO: {ppo_cfg.num_envs} x {ppo_cfg.unroll_length} = "
       f"{ppo_iter} env steps, {ppo_cfg.num_minibatches} minibatches x "
       f"{ppo_cfg.update_epochs} epochs; train step {ppo_s:.3f} s: "
       f"{rate:.1f} env-steps/s, {rate * env.frame_skip:.1f} "
       f"physics-steps/s; rollout spd_solve launches "
       f"{parts['rollout_launches']}, {ppo_launches} with the init")
  _say(f"train PPO parts (s): rollout {parts['rollout']:.3f}, normalize "
       f"{parts['normalize']:.4f}, gae {parts['gae']:.4f}, update "
       f"{parts['update']:.3f}")
  _say("train PPO metrics: " + json.dumps(
      {k: v for k, v in ppo_history[0].items() if k != "wall"}))

  if len(history) != NPG_ITERS or len(records) != NPG_ITERS:
    raise AssertionError(f"{len(history)} NPG iterations, {len(records)} "
                         f"jsonl records; expected {NPG_ITERS}")
  if "eval_success" not in history[-1]:
    raise AssertionError("the NPG eval did not run")
  for rec in history + ppo_history + records:
    metrics.check_finite(rec, where="chip_smoke phase 6")
  for it, parts in enumerate(npg.parts):
    if not abs(parts["kl"] - cfg.step_size) <= KL_BAND * cfg.step_size:
      raise AssertionError(f"NPG iter {it}: realized mean KL {parts['kl']} "
                           f"is not within {KL_BAND:.0%} of {cfg.step_size}")
  for what, err in errs.items():
    if not err <= NPG_UPDATE_BOUND[what]:
      raise AssertionError(f"NPG update on the card and the CPU disagree "
                           f"({what}: {err})")
  for name, before, net in (
      ("NPG policy", npg.replay["policy"], ts.params),
      ("NPG value", npg.replay["vf"], ts.vf_params),
      ("PPO actor-critic", ppo.before, pts.params)):
    if not _moved(before, net):
      raise AssertionError(f"{name} parameters unchanged or non-finite")
  if int(ts.steps) != NPG_ITERS * per_iter or int(pts.steps) != ppo_iter:
    raise AssertionError("env step counts are wrong")
  if npg_launches <= 0 or ppo_launches <= 0:
    raise AssertionError("training never launched the SPD kernel")
  if not base.precision_pinned():
    raise AssertionError("float32 matmul precision lost its pin")
  return {"train_launches": npg_launches + ppo_launches}


def phase_policy():
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  from myosuite_mjx_tpu_torch.train import zoo
  policy = zoo.load_baseline("myoHandPoseFixed-v0", device=DEVICE)
  benv = BatchedEnv(PoseEnv(HAND23, **HAND_POSE_FIXED), B_MAIN, DEVICE)
  st = benv.init()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(POLICY_STEPS):
    action = policy(st.obs)
    st = benv.step(st, action)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  for name, x in (("action", action), ("obs", st.obs),
                  ("qpos", st.data.qpos)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"non-finite {name} under the zoo policy")
  _say(f"policy: zoo myoHandPoseFixed-v0 (policy-mlp-v1, 108-32-32-39) on "
       f"{B_MAIN} hand23 envs, {POLICY_STEPS} control steps in "
       f"{seconds:.3f} s; reward mean {float(st.reward.mean()):.4f}, "
       f"solved {float(st.info['solved'].float().mean()):.4f}")

  B = 16
  cpu_policy = zoo.load_baseline("myoHandPoseFixed-v0", device="cpu",
                                 dtype=torch.float64)
  card = BatchedEnv(PoseEnv(HAND23, **HAND_POSE_FIXED), B, DEVICE)
  cpu = BatchedEnv(PoseEnv(HAND23, dtype=torch.float64, **HAND_POSE_FIXED),
                   B, "cpu")
  sc, sp = card.init(), cpu.init()
  worst = {}
  for t in range(POLICY_STEPS + 1):
    action = policy(sc.obs)
    ref = cpu_policy(sc.obs.double().cpu())
    worst["reset" if t == 0 else "after 5 steps"] = float(
        (action.double().cpu() - ref).abs().max())
    if t < POLICY_STEPS:
      sc = card.step(sc, action)
      sp = cpu.step(sp, action.double().cpu())
  for what, err in worst.items():
    ok = err <= POLICY_BOUND
    _say(f"policy card float32 vs cpu float64, same obs, {what}: max abs "
         f"action err {err:.3e} (bound {POLICY_BOUND:g}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"card and CPU policies disagree ({what})")
  for f, bound in CARD_CPU_BOUND.items():
    err = float((getattr(sc.data, f).double().cpu()
                 - getattr(sp.data, f)).abs().max())
    ok = err <= bound
    _say(f"policy rollout card vs cpu float64 env, same actions, {f}: max "
         f"abs err {err:.3e} (bound {bound:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"card and CPU rollouts disagree on {f}")


def _sac_snapshot(ts) -> dict:
  """Copies of what the update gate holds: the nets, the target, alpha and
  the three Adam states."""
  opt = {}
  for name, o in (("actor_opt", ts.actor_opt), ("q_opt", ts.q_opt),
                  ("alpha_opt", ts.alpha_opt)):
    for i, st in o.state_dict()["state"].items():
      for k, v in st.items():
        if torch.is_tensor(v):
          opt[f"{name}.{i}.{k}"] = v.detach().clone()
  return {"actor": _flat_params(ts.actor_params).clone(),
          "q": _flat_params(ts.q_params).clone(),
          "q_target": _flat_params(ts.q_target).clone(),
          "log_alpha": ts.log_alpha.detach().clone().reshape(1), **opt}


def _checked_sac():
  """``SAC`` timed by part (collect, insert, update). Every update records
  whether each net and Adam state moved, and iteration SAC_REPLAY_ITER's
  keeps in ``replay`` the state, buffer rows and draws it starts from and
  the nets after it."""
  from myosuite_mjx_tpu_torch.train.sac import SAC

  class CheckedSAC(_timed(SAC, ("collect", "insert", "update"))):
    replay: dict | None = None

    def update(self, ts, mb_idx, eps_next, eps_pi):
      it = len(self.parts) - 1
      before = _sac_snapshot(ts)
      if it == SAC_REPLAY_ITER:
        size = self.cursor(ts)[2]
        self.replay = dict(
            steps=ts.steps, actor=_state_copy(ts.actor_params),
            q=_state_copy(ts.q_params), q_target=_state_copy(ts.q_target),
            log_alpha=float(ts.log_alpha.detach()),
            opts={k: copy.deepcopy(getattr(ts, k).state_dict())
                  for k in ("actor_opt", "q_opt", "alpha_opt")},
            buffer={k: v[:size].clone() for k, v in ts.buffer.items()},
            mb_idx=mb_idx.clone(), eps_next=eps_next.clone(),
            eps_pi=eps_pi.clone())
      out = super().update(ts, mb_idx, eps_next, eps_pi)
      after = _sac_snapshot(ts)
      self.parts[-1]["moved"] = {k: not torch.equal(before[k], after[k])
                                 for k in before}
      if it == SAC_REPLAY_ITER:
        self.replay["after"] = {k: after[k] for k in SAC_NETS}
      return out

  return CheckedSAC


def _replay_sac_update(replay: dict, device, dtype) -> dict:
  """One iteration's gradient steps again, from the state, buffer rows and
  draws the card used, on ``device`` in ``dtype``; the nets before and
  after."""
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  from myosuite_mjx_tpu_torch.train.common import adam
  from myosuite_mjx_tpu_torch.train.sac import SAC, SACConfig, SACState
  sac = SAC(PoseEnv(HAND23, dtype=dtype, **HAND_POSE_FIXED),
            SACConfig(**SAC_CFG), device)
  obs_dim = replay["buffer"]["obs"].shape[-1]
  actor, q, q_target = sac.make_nets(obs_dim, torch.Generator(device=device))
  for net, key in ((actor, "actor"), (q, "q"), (q_target, "q_target")):
    net.load_state_dict(replay[key])
  log_alpha = torch.tensor(replay["log_alpha"], dtype=dtype, device=device,
                           requires_grad=True)
  lr = sac.cfg.learning_rate
  opts = {"actor_opt": adam(actor, lr), "q_opt": adam(q, lr),
          "alpha_opt": adam([log_alpha], lr)}
  for k, opt in opts.items():
    opt.load_state_dict(copy.deepcopy(replay["opts"][k]))
  ts = SACState(actor_params=actor, q_params=q, q_target=q_target,
                log_alpha=log_alpha, buffer={
                    k: v.to(device, dtype) for k, v in replay["buffer"].items()},
                buf_pos=0, buf_full=False, env_state=None,
                steps=replay["steps"], **opts)
  before = _sac_snapshot(ts)
  sac.update(ts, replay["mb_idx"].to(device),
             replay["eps_next"].to(device, dtype),
             replay["eps_pi"].to(device, dtype))
  after = _sac_snapshot(ts)
  return {k: (before[k].double().cpu(), after[k].double().cpu())
          for k in SAC_NETS}


def _sac_replay_errors(replay: dict) -> tuple[dict, dict]:
  """The card's float32 update, and a CPU float32 replay, against the CPU
  float64 replay: each net's largest parameter difference over its largest
  change on the CPU."""
  ref = _replay_sac_update(replay, "cpu", torch.float64)
  f32 = _replay_sac_update(replay, "cpu", torch.float32)

  def rel(after, k):
    before64, after64 = ref[k]
    return float((after.double().cpu() - after64).abs().max()
                 / (after64 - before64).abs().max())

  return ({k: rel(replay["after"][k], k) for k in SAC_NETS},
          {k: rel(f32[k][1], k) for k in SAC_NETS})


def phase_sac() -> dict:
  from myosuite_mjx_tpu_torch.envs import base
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  from myosuite_mjx_tpu_torch.train import metrics
  from myosuite_mjx_tpu_torch.train.sac import SACConfig
  env = PoseEnv(HAND23, **HAND_POSE_FIXED)
  sac = _checked_sac()(env, SACConfig(**SAC_CFG), DEVICE)
  cfg, N = sac.cfg, sac.cfg.num_envs
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  history = []
  ts, _ = sac.train(SAC_ITERS * N, seed=TRAIN_SEED,
                    progress=lambda it, m: history.append(m))
  launches = cuda_linalg.spd_solve_cuda.launches
  buf_mb = sum(v.numel() * v.element_size() for v in ts.buffer.values()) / 1e6
  _say(f"train SAC on hand23: {N} envs x {cfg.updates_per_step} updates per "
       f"step, batch {cfg.batch_size}, hidden {cfg.hidden}, buffer "
       f"{cfg.buffer_size} ({buf_mb:.1f} MB on the card), learning_starts "
       f"{cfg.learning_starts} (the proof recipe's 5000 cut to 64), "
       f"{SAC_ITERS} iterations; init {sac.init_part['init']:.3f} s, "
       f"spd_solve launches {sac.init_part['init_launches']}")
  for it, (rec, parts) in enumerate(zip(history, sac.parts)):
    step_s = parts["collect"] + parts["insert"] + parts["update"]
    rate = N / step_s
    _say(f"train SAC iter {it}: collect {parts['collect']:.4f} s, insert "
         f"{parts['insert']:.4f} s, update {parts['update']:.4f} s; "
         f"{rate:.2f} env-steps/s, {rate * env.frame_skip:.1f} "
         f"physics-steps/s; spd_solve launches {parts['collect_launches']}"
         f" (update {parts['update_launches']})")
    _say(f"train SAC iter {it} metrics: " + json.dumps(
        {k: v for k, v in rec.items() if k != "wall"}))
  _say(f"train SAC: spd_solve launches {launches} (init and "
       f"{SAC_ITERS} collections)")

  t0 = time.perf_counter()
  errs, f32 = _sac_replay_errors(sac.replay)
  for k in SAC_NETS:
    _say(f"train SAC iter {SAC_REPLAY_ITER} update, card float32 vs cpu "
         f"float64, same state, minibatches and draws, {k}: rel err "
         f"{errs[k]:.3e} (cpu float32 vs float64 {f32[k]:.3e}; bound "
         f"{SAC_REPLAY_BOUND[k]:g}) "
         f"{'ok' if errs[k] <= SAC_REPLAY_BOUND[k] else 'FAIL'}")
  _say(f"train SAC: the replays took {time.perf_counter() - t0:.3f} s")

  for rec in history:
    metrics.check_finite(rec, where="chip_smoke phase 8")
  if len(history) != SAC_ITERS:
    raise AssertionError(f"{len(history)} SAC iterations, not {SAC_ITERS}")
  for it, parts in enumerate(sac.parts):
    moved = parts["moved"]
    if it * N < cfg.learning_starts:
      if any(moved.values()):
        raise AssertionError(f"SAC iter {it} (before learning_starts) moved "
                             f"{sorted(k for k, v in moved.items() if v)}")
    elif not all(moved[k] for k in SAC_NETS):
      raise AssertionError(f"SAC iter {it}: the nets or alpha did not move")
  for k in SAC_NETS:
    if not errs[k] <= SAC_REPLAY_BOUND[k]:
      raise AssertionError(f"SAC update on the card and the CPU disagree "
                           f"({k}: {errs[k]})")
  pos = SAC_ITERS * N
  filled = ts.buffer["obs"].abs().sum(-1) > 0
  if ((ts.buf_pos, ts.buf_full, ts.steps) != (pos, False, pos)
      or not bool(filled[:pos].all()) or bool(filled[pos:].any())):
    raise AssertionError(f"SAC buffer cursor {ts.buf_pos} (full "
                         f"{ts.buf_full}, steps {ts.steps}), expected {pos}")
  if launches <= 0:
    raise AssertionError("SAC never launched the SPD kernel")
  if not base.precision_pinned():
    raise AssertionError("float32 matmul precision lost its pin")
  return {"sac_launches": launches}


def _condition_env(name: str, dtype=torch.float32):
  """hand23 PoseEnv under one of CONDITIONS; the overlay variant draws all
  six RandomizeSpec fields per env at every reset."""
  from myosuite_mjx_tpu_torch.envs import randomize
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv

  class OverlayPoseEnv(PoseEnv):
    def reset_overlay(self, batch, device, aux, generator):
      return randomize.sample_overlay(
          self.model, randomize.RandomizeSpec(**OVERLAY_SPEC), batch,
          generator, device, self.dtype)

  cls = OverlayPoseEnv if name == "overlay" else PoseEnv
  return cls(HAND23, dtype=dtype, **HAND_POSE_FIXED,
             **CONDITIONS.get(name, {}))


def _condition_b16(name: str, device, dtype) -> dict:
  """16 envs of a phase 9 condition, 5 autoreset steps of seeded actions,
  every draw from one CPU generator (the same draws on the card): the
  state fields of CARD_CPU_BOUND and obs, as float64 on the host."""
  actions = np.random.default_rng(0).uniform(0.0, 1.0, (5, 16, 39))
  env = _condition_env(name, dtype)
  g = torch.Generator().manual_seed(0)
  st = env.reset(16, device, g)
  for a in actions:
    st = env.autoreset_step(
        st, torch.as_tensor(a, dtype=dtype, device=device), g)
  out = {f: getattr(st.data, f).double().cpu() for f in CARD_CPU_BOUND}
  out["obs"] = st.obs.double().cpu()
  return out


def cpu_references_conditions() -> dict:
  """Phase 9's CPU side (float64 and float32 of each condition); ``main``
  computes it in the worker process, ahead of ``cpu_references``."""
  torch.set_num_threads(2)
  return {(name, dtype): _condition_b16(name, "cpu", dtype)
          for name in CONDITIONS for dtype in (torch.float64, torch.float32)}


def phase_conditions(phase4_rate: float, cpu_refs=None) -> dict:
  """Phase 9; ``phase4_rate`` is phase 4's physics-steps/s in this call,
  ``cpu_refs`` a future of ``cpu_references_conditions()`` (computed here
  without it)."""
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  t0 = time.perf_counter()
  refs = (cpu_refs.result() if cpu_refs is not None
          else cpu_references_conditions())
  _say(f"phase 9: waited {time.perf_counter() - t0:.1f} s for the CPU "
       f"references")
  for name in CONDITIONS:
    card = _condition_b16(name, DEVICE, torch.float32)
    ref, cpu32 = refs[name, torch.float64], refs[name, torch.float32]
    for f, bound in CARD_CPU_BOUND.items():
      err = (card[f] - ref[f]).abs().amax(-1)
      err32 = float((cpu32[f] - ref[f]).abs().max())
      worst_bound = max(bound, FLOAT32_MARGIN * err32)
      worst, median = float(err.max()), float(err.median())
      ok = worst <= worst_bound and median <= bound
      _say(f"conditions {name}: card float32 vs cpu float64 after 5 steps, "
           f"{f}: max abs err worst env {worst:.3e} (bound "
           f"{worst_bound:.3g}; cpu float32 {err32:.3e}), median env "
           f"{median:.3e} (bound {bound:g}) {'ok' if ok else 'FAIL'}")
      if not ok:
        raise AssertionError(f"{name}: card and CPU disagree on {f}")
    obs_err = float((card["obs"] - ref["obs"]).abs().max())
    _say(f"conditions {name}: obs max abs err {obs_err:.3e}")

  rates: dict = {}
  for name in PHASE9_ORDER:
    env = _condition_env(name)
    benv = BatchedEnv(env, B_MAIN, DEVICE, seed=0)
    st = benv.init()
    g = torch.Generator(device=DEVICE).manual_seed(0)
    st = st.replace(steps=torch.randint(0, env.horizon, (B_MAIN,),
                                        generator=g, device=DEVICE,
                                        dtype=torch.int32))
    first = ({k: v.clone() for k, v in st.data.overlay.items()}
             if name == "overlay" else None)
    restarted = torch.zeros(B_MAIN, dtype=torch.bool, device=DEVICE)
    t0 = None
    for i in range(PHASE9_STEPS):
      if i == WARMUP:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
      action = torch.rand((B_MAIN, env.action_dim), generator=g,
                          device=DEVICE)
      st = benv.step(st, action)
      restarted |= st.info["terminated"] | st.info["truncated"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rate = (PHASE9_STEPS - WARMUP) * B_MAIN / seconds
    for what, x in (("obs", st.obs), ("reward", st.reward),
                    ("qpos", st.data.qpos)):
      if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: non-finite {what} at B={B_MAIN}")
    n_reset = int(restarted.sum())
    if not 0 < n_reset < B_MAIN:
      raise AssertionError(f"{name}: {n_reset} of {B_MAIN} envs reset")
    if first is not None:
      for k, v in st.data.overlay.items():
        kept = (v == first[k]).reshape(B_MAIN, -1).all(-1)
        if not bool(torch.equal(kept, ~restarted)):
          raise AssertionError(f"overlay {k}: kept where an env reset, or "
                               f"replaced where none did")
    rates.setdefault(name, []).append(rate * env.frame_skip)
    _say(f"conditions {name} B={B_MAIN}: {PHASE9_STEPS} control steps, "
         f"{n_reset} envs autoreset; {PHASE9_STEPS - WARMUP} timed steps in "
         f"{seconds:.3f} s: {rate * env.frame_skip:.1f} physics-steps/s, "
         f"{rate:.1f} control-steps/s")
  mean = {k: float(np.mean(v)) for k, v in rates.items()}
  _say(f"conditions B={B_MAIN}, physics-steps/s over the turns "
       f"{PHASE9_ORDER}: " + ", ".join(
           f"{k} {v:.1f} ({v / mean['nominal']:.3f} of nominal)"
           for k, v in mean.items())
       + f"; phase 4 of this call {phase4_rate:.1f}")
  launches = cuda_linalg.spd_solve_cuda.launches
  _say(f"conditions: spd_solve launches {launches}")
  if launches <= 0:
    raise AssertionError("phase 9 never launched the SPD kernel")
  return {"conditions_launches": launches}


def _zeroed(fn, *args):
  """``fn(*args)`` and the register kernel's launches in it: the count is
  set to 0 just before the call and read just after it."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  out = fn(*args)
  torch.cuda.synchronize()
  return out, cuda_linalg.spd_solve_cuda.launches


@contextlib.contextmanager
def _env_horizon(horizon: int):
  """``envs.make`` with the task's horizon cut to ``horizon`` (the CLI
  has no flag for it)."""
  from myosuite_mjx_tpu_torch import envs
  make = envs.make
  envs.make = functools.partial(make, horizon=horizon)
  try:
    yield
  finally:
    envs.make = make


def _cli(argv: list) -> dict:
  """``train.cli.main(argv)``; its JSON records, the returned state, the
  seconds and the SPD launches of the call."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  from myosuite_mjx_tpu_torch.train import cli
  torch.cuda.synchronize()
  n0, t0 = cuda_linalg.spd_solve_cuda.launches, time.perf_counter()
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    state = cli.main(argv)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  lines = out.getvalue().splitlines()
  for ln in lines:
    _say(f"  cli: {ln}")
  return {"state": state, "seconds": seconds,
          "records": [json.loads(ln) for ln in lines if ln.startswith("{")],
          "launches": cuda_linalg.spd_solve_cuda.launches - n0}


@contextlib.contextmanager
def _sac_defaults(**kw):
  """``SACConfig`` with other defaults, for settings the CLI has no flag
  for (the JAX package's CLI has none either)."""
  from myosuite_mjx_tpu_torch.train import sac
  cls = sac.SACConfig
  sac.SACConfig = functools.partial(cls, **kw)
  try:
    yield
  finally:
    sac.SACConfig = cls


def _sac_nets(ts) -> dict:
  return {"actor": _flat_params(ts.actor_params),
          "q": _flat_params(ts.q_params),
          "q_target": _flat_params(ts.q_target),
          "log_alpha": ts.log_alpha.detach().reshape(1)}


def phase_cli() -> dict:
  """Phase 10: the training CLI on the card."""
  from myosuite_mjx_tpu_torch import envs
  from myosuite_mjx_tpu_torch.train import metrics
  from myosuite_mjx_tpu_torch.train.sac import SAC, SACConfig
  base = ["--env", CLI_ENV, "--device", DEVICE, "--log-every", "1"]
  with tempfile.TemporaryDirectory() as tmp:
    ck = lambda name, it: os.path.join(tmp, name, f"iter_{it:07d}")
    npg_steps = NPG_ENVS * CLI_NPG_HORIZON
    with _env_horizon(CLI_NPG_HORIZON):
      npg = _cli(base + ["--algo", "npg", "--num-envs", str(NPG_ENVS),
                         "--total-steps", str(npg_steps), "--checkpoint-dir",
                         os.path.join(tmp, "npg"), "--logdir",
                         os.path.join(tmp, "npg", "log")])
    rec = npg["records"][-1]
    _say(f"cli NPG {CLI_ENV}: {NPG_ENVS} x {CLI_NPG_HORIZON} = {npg_steps} "
         f"env steps in "
         f"{rec['wall_s']:.3f} s of iteration ({npg_steps / rec['wall_s']:.1f}"
         f" env-steps/s, {10 * npg_steps / rec['wall_s']:.1f} "
         f"physics-steps/s); {npg['seconds']:.3f} s with the init and the "
         f"checkpoint; spd_solve launches {npg['launches']}")

    N = SAC_CFG["num_envs"]
    sac_kw = {k: v for k, v in SAC_CFG.items() if k != "num_envs"}
    sac_args = base + ["--algo", "sac", "--num-envs", str(N),
                       "--checkpoint-every", str(CLI_SAC_SPLIT)]
    with _sac_defaults(**sac_kw):
      straight = _cli(sac_args + [
          "--total-steps", str(CLI_SAC_ITERS * N),
          "--checkpoint-dir", os.path.join(tmp, "straight")])
      first = _cli(sac_args + [
          "--total-steps", str(CLI_SAC_SPLIT * N),
          "--checkpoint-dir", os.path.join(tmp, "split")])
      resumed = _cli(sac_args + [
          "--total-steps", str(CLI_SAC_ITERS * N),
          "--checkpoint-dir", os.path.join(tmp, "split"),
          "--resume", ck("split", CLI_SAC_SPLIT)])
      cfg = SACConfig(num_envs=N)
    files = [ck("npg", 1), ck("straight", CLI_SAC_SPLIT),
             ck("straight", CLI_SAC_ITERS), ck("split", CLI_SAC_SPLIT),
             ck("split", CLI_SAC_ITERS)]
    missing = [f for f in files if not os.path.exists(f)]
    sizes = {os.path.basename(os.path.dirname(f)) + "/" + os.path.basename(f):
             os.path.getsize(f) for f in files if os.path.exists(f)}
  _say(f"cli checkpoints (bytes): {sizes}")

  # where the straight run's nets started: the same seed's init
  env = envs.make(CLI_ENV)
  init = _sac_nets(SAC(env, cfg, DEVICE).init(
      generator=torch.Generator(device=DEVICE).manual_seed(0)))
  a, b = _sac_nets(straight["state"]), _sac_nets(resumed["state"])
  errs = {k: float((a[k] - b[k]).abs().max() / (a[k] - init[k]).abs().max())
          for k in SAC_NETS}
  for name, run in (("straight", straight), ("first leg", first),
                    ("resumed", resumed)):
    recs = run["records"]
    per = [r["wall_s"] for r in recs]
    its = [per[0]] + [y - x for x, y in zip(per, per[1:])]
    _say(f"cli SAC {name}: iterations {[r['iter'] for r in recs]}, env_steps "
         f"{[r['env_steps'] for r in recs]}; s per iteration "
         f"{[round(x, 3) for x in its]}; env-steps/s after the first "
         f"{[r['steps_per_s'] for r in recs[1:]]}; {run['seconds']:.3f} s "
         f"in all; spd_solve launches {run['launches']}")
  for k in SAC_NETS:
    _say(f"cli SAC resumed vs straight, {k}: max abs diff over the straight "
         f"run's largest change {errs[k]:.3e} (bound {SAC_REPLAY_BOUND[k]:g})"
         f" {'ok' if errs[k] <= SAC_REPLAY_BOUND[k] else 'FAIL'}")

  for run in (npg, straight, first, resumed):
    for rec in run["records"]:
      metrics.check_finite(rec, where="chip_smoke phase 10")
  if missing:
    raise AssertionError(f"checkpoints not written: {missing}")
  got = [(r["iter"], r["env_steps"]) for r in resumed["records"]]
  want = [(i, i * N) for i in range(CLI_SAC_SPLIT + 1, CLI_SAC_ITERS + 1)]
  if got != want or straight["state"].steps != CLI_SAC_ITERS * N:
    raise AssertionError(f"the resumed run logged {got}, expected {want}")
  for k in SAC_NETS:
    if not errs[k] <= SAC_REPLAY_BOUND[k]:
      raise AssertionError(f"resumed SAC differs from the straight run ({k}:"
                           f" {errs[k]})")
  launches = sum(r["launches"] for r in (npg, straight, first, resumed))
  if min(r["launches"] for r in (npg, straight, first, resumed)) <= 0:
    raise AssertionError("a CLI run never launched the SPD kernel")
  return {"cli_launches": launches}


def phase_prove_sac() -> dict:
  """Phase 11: tools/prove_sac.py on the card."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  from myosuite_mjx_tpu_torch.tools import prove_sac
  from myosuite_mjx_tpu_torch.train import metrics
  torch.cuda.synchronize()
  n0, t0 = cuda_linalg.spd_solve_cuda.launches, time.perf_counter()
  with tempfile.TemporaryDirectory() as out_dir:
    res = prove_sac.main([
        "--env", CLI_ENV, "--total-steps", str(PROOF_STEPS),
        "--eval-every-steps", str(PROOF_STEPS), "--config",
        json.dumps(SAC_CFG), "--out", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    path = os.path.join(out_dir, f"{CLI_ENV}.json")
    with open(path) as f:
      written = json.load(f)
  _say(f"prove_sac wrote {os.path.basename(path)}: {json.dumps(written)}")
  launches = cuda_linalg.spd_solve_cuda.launches - n0
  ev = res["history"][-1]
  _say(f"prove_sac {CLI_ENV}: {PROOF_STEPS} env steps ({SAC_CFG}) and one "
       f"eval of 32 episodes x 100 steps in {seconds:.3f} s ({ev['wall']} s "
       f"of training and eval at the record); eval_success "
       f"{ev['eval_success']}, eval_solved_frac {ev['eval_solved_frac']:.5f},"
       f" eval_score {ev['eval_score']:.4f}; spd_solve launches {launches}")
  if len(res["history"]) != 1 or written != json.loads(json.dumps(res)):
    raise AssertionError("prove_sac did not evaluate once and write its JSON")
  metrics.check_finite(ev, where="chip_smoke phase 11")
  if launches <= 0:
    raise AssertionError("prove_sac never launched the SPD kernel")
  return {"prove_sac_launches": launches}


def _free_start(phys, batch: int):
  """``batch`` free10 envs: the bar on the plane, the chain's swing and the
  free body's position offset per env, small random velocities."""
  rng = np.random.default_rng(0)
  d = phys.make_data(batch)
  qpos = d.qpos.double().cpu().numpy()
  qpos[:, 0] += rng.uniform(-0.3, 0.3, batch)
  qpos[:, 5:8] += rng.uniform(-0.005, 0.005, (batch, 3))
  qvel = rng.normal(scale=0.2, size=(batch, phys.model.nv))
  t = lambda x: torch.as_tensor(x, dtype=phys.dtype, device=phys.device)
  return d.replace(qpos=t(qpos), qvel=t(qvel),
                   mocap_pos=t(np.tile(BAR_POS, (batch, 1, 1))))


def phase_physics() -> dict:
  """Phase 12: ball and free joints and a mocap body through Physics."""
  from myosuite_mjx_tpu_torch.engine import api
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  out = {}
  for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float64),
                        ("cpu", torch.float32)):
    phys = api.load(FREE10, dtype, device)
    d = _free_start(phys, 16)
    for _ in range(FREE_STEPS):
      d = phys.step(d)
    out[device, dtype] = d
  card, ref = out[DEVICE, torch.float32], out["cpu", torch.float64]
  for f, bound in FREE_CPU_BOUND.items():
    err = float((getattr(card, f).double().cpu() - getattr(ref, f)).abs().max())
    err32 = float((getattr(out["cpu", torch.float32], f).double()
                   - getattr(ref, f)).abs().max())
    ok = err <= bound
    _say(f"physics free10 B=16, {FREE_STEPS} substeps, card float32 vs cpu "
         f"float64, {f}: max abs err {err:.3e} (bound {bound:g}; cpu float32 "
         f"{err32:.3e}; peak |{f}| {float(getattr(ref, f).abs().max()):.3f})"
         f" {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"free10: card and CPU disagree on {f}")

  phys = api.load(FREE10, torch.float32, DEVICE)
  d = _free_start(phys, B_MAIN)
  advance = phys.step_n(10)
  d = advance(d)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(FREE_WINDOW // 10 - 1):
    d = advance(d)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  rate = (FREE_WINDOW - 10) * B_MAIN / seconds
  rod = phys.model.name2id("body", "rod")
  free_dofs = slice(int(phys.model.body_dofadr[rod]),
                    int(phys.model.body_dofadr[rod]) + 6)
  speed = d.qvel[:, free_dofs].abs().amax(-1)
  active = (d.contact.dist < 0).sum(-1)
  touching = float((active > 0).float().mean())
  median = float(speed.median())
  _say(f"physics free10 B={B_MAIN}: {FREE_WINDOW} substeps, "
       f"{FREE_WINDOW - 10} timed in {seconds:.3f} s: {rate:.1f} "
       f"physics-steps/s; active contacts per env at the end "
       f"{float(active.float().mean()):.3f} (envs touching "
       f"{touching:.4f}), ne_active mean "
       f"{float(d.ne_active.float().mean()):.3f}; free body speed median "
       f"{median:.4f} (bound {FREE_REST}), max {float(speed.max()):.4f}; "
       f"spd_solve launches {cuda_linalg.spd_solve_cuda.launches}")
  for name, x in (("qpos", d.qpos), ("qvel", d.qvel)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"free10: non-finite {name} at B={B_MAIN}")
  if not (median <= FREE_REST and touching == 1.0):
    raise AssertionError("free10: the free bodies did not come to rest on "
                         "their contacts")
  if cuda_linalg.spd_solve_cuda.launches <= 0:
    raise AssertionError("phase 12 never launched the SPD kernel")
  return {"physics_launches": cuda_linalg.spd_solve_cuda.launches,
          "physics_steps_per_s": rate}


# ---------------------------------------------------------------------------
# phase 13: contact geometry and the hand-object tasks
# ---------------------------------------------------------------------------


def _rotations(rng, n: int) -> np.ndarray:
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=-1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                2 * (x * z + w * y)], -1),
      np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                2 * (y * z - w * x)], -1),
      np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                1 - 2 * (x * x + y * y)], -1)], -2)


def _pair_cases(t1: int, t2: int, n: int, seed: int = 0):
  """(p1, m1, s1, p2, m2, s2) as float64 numpy [n, ...]: a quarter each
  separated, shallow, deep and with coincident centres. geom2 sits along a
  random direction from geom1 (along a plane's normal) at a share of the
  summed support extents (of geom2's alone for a plane)."""
  from myosuite_mjx_tpu_torch.engine.model import GeomType as T
  rng = np.random.default_rng(seed)

  def sizes(t, k):
    s = rng.uniform(0.01, 0.04, (k, 3))
    if t == T.SPHERE:
      s[:, 1:] = 0.0
    if t in (T.CAPSULE, T.CYLINDER):
      s[:, 2] = 0.0
    return s

  def extent(t, s, mat, u):
    d = np.einsum("nji,nj->ni", mat, u)
    if t == T.SPHERE:
      return s[:, 0]
    if t == T.CAPSULE:
      return s[:, 0] + s[:, 1] * np.abs(d[:, 2])
    if t == T.ELLIPSOID:
      return np.linalg.norm(s * d, axis=-1)
    if t == T.CYLINDER:
      return (s[:, 0] * np.linalg.norm(d[:, :2], axis=-1)
              + s[:, 1] * np.abs(d[:, 2]))
    return (s * np.abs(d)).sum(-1)

  out, k = [], n // 4
  for share, plane_share in ((1.4, 1.4), (0.93, 0.93), (0.5, 0.3),
                             (0.0, -0.4)):
    m1, m2 = _rotations(rng, k), _rotations(rng, k)
    s1, s2 = sizes(t1, k), sizes(t2, k)
    p1 = rng.uniform(-0.05, 0.05, (k, 3))
    if t1 == T.PLANE:
      u = m1[:, :, 2]
      off = plane_share * extent(t2, s2, m2, -u)
    else:
      u = rng.normal(size=(k, 3))
      u /= np.linalg.norm(u, axis=-1, keepdims=True)
      off = share * (extent(t1, s1, m1, u) + extent(t2, s2, m2, -u))
    out.append((p1, m1, s1, p1 + off[:, None] * u, m2, s2))
  return tuple(np.concatenate(x) for x in zip(*out))


def _narrow(types, cases, device, dtype):
  from myosuite_mjx_tpu_torch.engine import collision
  args = [torch.as_tensor(a, dtype=dtype, device=device) for a in cases]
  dist, pos, n = collision._narrow_fn(*types)(*args)
  return [x.double().cpu().numpy()
          for x in (dist, pos, n.expand(pos.shape))]


def phase_pairs() -> dict:
  """13a: every ported pair type at B_MAIN, card float32 against CPU
  float64 (see PAIR_FLIP)."""
  from myosuite_mjx_tpu_torch.engine import collision
  from myosuite_mjx_tpu_torch.engine.model import GeomType as T
  keys = tuple(PAIR_FLIP)
  worst = {k: 0.0 for k in keys}
  for types in sorted(collision.PRIMITIVE):
    cases = _pair_cases(*types, B_MAIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = _narrow(types, cases, DEVICE, torch.float32)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ref = _narrow(types, cases, "cpu", torch.float64)
    cpu32 = _narrow(types, cases, "cpu", torch.float32)

    def lane_errs(out):
      return {k: np.abs((a - b).reshape(B_MAIN, -1)).max(-1)
              for k, a, b in zip(keys, out, ref)}

    def flipped(e):
      return float(np.any([e[k] > PAIR_FLIP[k] for k in keys], 0).mean())

    e, e32 = lane_errs(card), lane_errs(cpu32)
    med = {k: float(np.median(e[k])) for k in keys}
    flips, flips32 = flipped(e), flipped(e32)
    finite = all(np.isfinite(x).all() for x in card)
    good = (finite and flips <= flips32 + PAIR_FLIP_SLACK
            and all(med[k] <= PAIR_MEDIAN_BOUND[k] for k in keys))
    name = f"{T(types[0]).name}-{T(types[1]).name}"
    _say(f"pairs {name} B={B_MAIN} x {card[0].shape[-1]} points, card "
         f"float32 vs cpu float64: median lane " + ", ".join(
             f"{k} {med[k]:.2e}" for k in keys)
         + "; max " + ", ".join(f"{k} {float(e[k].max()):.2e}" for k in keys)
         + f"; flipped lanes {flips:.4f} (cpu float32 {flips32:.4f}); "
         f"touching lanes {int((ref[0].min(-1) < 0).sum())}; {ms:.1f} ms "
         f"{'ok' if good else 'FAIL'}")
    if not good:
      raise AssertionError(f"pair {name}: card and CPU disagree, or "
                           f"non-finite")
    worst = {k: max(worst[k], med[k]) for k in keys}
  n_types = len(collision.PRIMITIVE)
  _say(f"pairs: worst median lane over the {n_types} types "
       + ", ".join(f"{k} {v:.2e} (bound {PAIR_MEDIAN_BOUND[k]:g})"
                   for k, v in worst.items()))
  return {}


def _prims_start(phys, batch: int):
  """``batch`` prims36 envs: each body's start moved by up to 5 mm, small
  random velocities (0.02 m/s or rad/s)."""
  rng = np.random.default_rng(0)
  d = phys.make_data(batch)
  qpos = d.qpos.double().cpu().numpy()
  for b in range(phys.model.nq // 7):
    qpos[:, 7 * b:7 * b + 3] += rng.uniform(-0.005, 0.005, (batch, 3))
  qvel = rng.normal(scale=0.02, size=(batch, phys.model.nv))
  t = lambda x: torch.as_tensor(x, dtype=phys.dtype, device=phys.device)
  return d.replace(qpos=t(qpos), qvel=t(qvel))


def _prims_b16(device, dtype) -> dict:
  """prims36's 16 envs after PRIMS_STEPS substeps: qpos and qvel."""
  from myosuite_mjx_tpu_torch.engine import api
  phys = api.load(PRIMS36, dtype, device)
  d = _prims_start(phys, 16)
  for _ in range(PRIMS_STEPS):
    d = phys.step(d)
  return {f: getattr(d, f).double().cpu().numpy() for f in FREE_CPU_BOUND}


def _task_b16(task_id: str, device, dtype) -> dict:
  """16 envs of a task after 5 autoreset steps (one CPU generator, so the
  card and the CPU draw the same): qpos, qvel and act."""
  B = 16
  env = _task_env(task_id, dtype)
  actions = np.random.default_rng(0).uniform(0.0, 1.0,
                                             (5, B, env.action_dim))
  g = torch.Generator().manual_seed(0)
  st = env.reset(B, device, g)
  for a in actions:
    st = env.autoreset_step(
        st, torch.as_tensor(a, dtype=dtype, device=device), g)
  return {f: getattr(st.data, f).double().cpu().numpy()
          for f in CARD_CPU_BOUND}


def _hold_b16(task_id: str, refs: dict | None, label: str) -> None:
  """16 envs x 5 control steps of a task on the card against the CPU with
  the same draws; ``refs`` is ``cpu_references()`` (computed here without
  it). The median env within the larger of phase 5's bound and
  FLOAT32_MARGIN times the CPU float32 run's median env; no more envs
  past it than in the CPU float32 run plus LEG_FLIP_SLACK."""
  card = _task_b16(task_id, DEVICE, torch.float32)
  if refs:
    ref, cpu32 = refs[task_id, torch.float64], refs[task_id, torch.float32]
  else:
    ref = _task_b16(task_id, "cpu", torch.float64)
    cpu32 = _task_b16(task_id, "cpu", torch.float32)
  for f, bound in CARD_CPU_BOUND.items():
    err = np.abs(card[f] - ref[f]).max(-1)
    err32 = np.abs(cpu32[f] - ref[f]).max(-1)
    median_bound = max(bound, FLOAT32_MARGIN * float(np.median(err32)))
    median = float(np.median(err))
    flips, flips32 = (err > median_bound).mean(), (err32 > median_bound
                                                   ).mean()
    ok = (median <= median_bound and flips <= flips32 + LEG_FLIP_SLACK
          and np.isfinite(card[f]).all())
    _say(f"{label} {task_id} B=16: card float32 vs cpu float64 after 5 "
         f"steps, {f}: median env {median:.3e} (bound "
         f"{median_bound:.3g}; cpu float32 {float(np.median(err32)):.3e}"
         f"); envs past it {flips:.4f} (cpu float32 {flips32:.4f}, slack "
         f"{LEG_FLIP_SLACK:g}); worst env {float(err.max()):.3e} (cpu "
         f"float32 {float(err32.max()):.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"{task_id}: card and CPU disagree on {f}")


def cpu_references() -> dict:
  """Phases 13-18's CPU side (13b's and 15b's float64 runs, 13c's, 14c's,
  15c's and 16b's float64 and float32 runs, 17a's, 17b's and 18b's
  float64 runs).
  ``main`` computes it in a worker process while the card runs the
  earlier phases."""
  torch.set_num_threads(2)
  out = {"prims": _prims_b16("cpu", torch.float64),
         "hulls": _hulls_b16("cpu", torch.float64),
         "pose_f64": _pose_b16("cpu", torch.float64),
         "chain72": _chain_b16("cpu", torch.float64),
         "reflex": _reflex_b4("cpu", torch.float64)}
  for task_id in MANIP_TASKS + LEG_TASKS + HAND_ARM_TASKS + OSL_TRACK_TASKS:
    for dtype in (torch.float64, torch.float32):
      out[task_id, dtype] = _task_b16(task_id, "cpu", dtype)
  return out


def phase_prims(refs: dict | None = None) -> dict:
  """13b: every pair type in dynamics through ``Physics`` on prims36;
  ``refs`` is ``cpu_references()`` (computed here without it)."""
  from myosuite_mjx_tpu_torch.engine import api, collision
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  card = _prims_b16(DEVICE, torch.float32)
  ref = refs["prims"] if refs else _prims_b16("cpu", torch.float64)
  for f, bound in FREE_CPU_BOUND.items():
    err = np.abs(card[f] - ref[f]).max(-1)
    worst, median = float(err.max()), float(np.median(err))
    ok = worst <= bound
    _say(f"prims36 B=16, {PRIMS_STEPS} substeps, card float32 vs cpu "
         f"float64, {f}: max abs err worst env {worst:.3e}, median env "
         f"{median:.3e} (bound {bound:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"prims36: card and CPU disagree on {f}")

  phys = api.load(PRIMS36, torch.float32, DEVICE)
  m = phys.model
  d = _prims_start(phys, B_MAIN)
  advance = phys.step_n(10)
  d = advance(d)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(PRIMS_WINDOW // 10 - 1):
    d = advance(d)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  rate = (PRIMS_WINDOW - 10) * B_MAIN / seconds
  nbody = m.nq // 7
  speed = d.qvel.reshape(B_MAIN, nbody, 6).abs().amax(-1)
  height = d.qpos.reshape(B_MAIN, nbody, 7)[..., 2]
  active = (d.contact.dist < 0).sum(-1)
  types = sorted({(int(m.geom_type[p.g1]), int(m.geom_type[p.g2]))
                  for p in collision.candidate_pairs(m)})
  median = float(speed.amax(-1).median())
  lowest = float(height.min())
  _say(f"prims36 B={B_MAIN}: {len(types)} pair types, {PRIMS_WINDOW} "
       f"substeps, {PRIMS_WINDOW - 10} timed in {seconds:.3f} s: {rate:.1f}"
       f" physics-steps/s ({seconds / (PRIMS_WINDOW - 10) * 1e3:.1f} ms per "
       f"substep); active contacts per env {float(active.float().mean()):.3f}"
       f", dropped {float(d.ncon_dropped.float().mean()):.3f} per env (max "
       f"{int(d.ncon_dropped.max())}); fastest body per env, median "
       f"{median:.4f} (bound {PRIMS_REST}); lowest body centre {lowest:.4f};"
       f" spd_solve launches {cuda_linalg.spd_solve_cuda.launches}")
  for name, x in (("qpos", d.qpos), ("qvel", d.qvel)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"prims36: non-finite {name} at B={B_MAIN}")
  if len(types) != 20:
    raise AssertionError(f"prims36 runs {len(types)} pair types, not 20")
  if not (median <= PRIMS_REST and lowest > 0.0):
    raise AssertionError("prims36: the bodies did not come to rest, or one "
                         "fell through the plane")
  if cuda_linalg.spd_solve_cuda.launches <= 0:
    raise AssertionError("phase 13b never launched the SPD kernel")
  return {"launches": cuda_linalg.spd_solve_cuda.launches}


def _object_geoms(env, task_id: str):
  """The task object's geoms, the hand's geoms (neither the object's nor
  the world's) as [ngeom] masks on the card, and the object's body."""
  m = env.model
  body = m.name2id("body", MANIP_OBJECT[task_id])
  gb = np.asarray(m.geom_bodyid)
  obj = torch.as_tensor(gb == body, device=DEVICE)
  hand = torch.as_tensor((gb != body) & (gb != 0), device=DEVICE)
  return obj, hand, body


def _task_env(task_id: str, dtype=torch.float32):
  from myosuite_mjx_tpu_torch import envs
  return envs.make(task_id, cache=False, dtype=dtype)


def _drive_b_main(env, steps: int, on_step=None, on_init=None):
  """``env`` at B_MAIN envs on the card for ``steps`` random control steps,
  every episode clock set to cross its horizon once inside the window, the
  steps after WARMUP timed. ``on_init(st)`` sees the first state and
  ``on_step(i, prev, st, ended)`` each step, for a task's own counts.
  Returns the last state and the run: seconds, timed steps,
  physics-steps/s, SPD launches, contacts the cull dropped and the envs
  that restarted."""
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  benv = BatchedEnv(env, B_MAIN, DEVICE, seed=0)
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  st = benv.init()
  if on_init is not None:
    on_init(st)
  g = torch.Generator(device=DEVICE).manual_seed(0)
  st = st.replace(steps=env.horizon - torch.randint(
      1, steps + 1, (B_MAIN,), generator=g, device=DEVICE,
      dtype=torch.int32))
  restarted = torch.zeros(B_MAIN, dtype=torch.bool, device=DEVICE)
  dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
  t0 = None
  for i in range(steps):
    if i == WARMUP:
      torch.cuda.synchronize()
      t0 = time.perf_counter()
    action = torch.rand((B_MAIN, env.action_dim), generator=g,
                        device=DEVICE)
    prev, st = st, benv.step(st, action)
    ended = st.info["terminated"] | st.info["truncated"]
    restarted |= ended
    dropped += st.data.ncon_dropped.sum()
    if on_step is not None:
      on_step(i, prev, st, ended)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  timed = steps - WARMUP
  return st, {"seconds": seconds, "timed": timed,
              "rate": timed * B_MAIN * env.frame_skip / seconds,
              "launches": cuda_linalg.spd_solve_cuda.launches,
              "dropped": int(dropped), "restarted": int(restarted.sum())}


def _b_main_checks(task_id: str, env, st, run: dict) -> None:
  """Fail on a non-finite obs, reward or qpos after ``_drive_b_main``, an
  env that did not autoreset at its horizon, or no SPD launch."""
  for what, x in (("obs", st.obs), ("reward", st.reward),
                  ("qpos", st.data.qpos)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"{task_id}: non-finite {what} at B={B_MAIN}")
  if (run["restarted"] < B_MAIN
      or bool((st.steps >= env.horizon).any())):
    raise AssertionError(f"{task_id}: an env did not autoreset at its "
                         f"horizon")
  if run["launches"] <= 0:
    raise AssertionError(f"{task_id} never launched the SPD kernel")


def _profile(task_id: str) -> dict:
  """``tools/profile_step.py`` on ``task_id``, one profiled control step,
  in process; the SPD launches it made."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  from myosuite_mjx_tpu_torch.tools import profile_step
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  profile_step.main(["--env", task_id, "--steps", "1"])
  return {"launches": cuda_linalg.spd_solve_cuda.launches}


def phase_manip(phase4_rate: float, refs: dict | None = None) -> dict:
  """13c: the hand-object tasks through ``envs.make``; ``refs`` is
  ``cpu_references()`` (computed here without it)."""
  total = 0
  for task_id in MANIP_TASKS:
    card = _task_b16(task_id, DEVICE, torch.float32)
    if refs:
      ref, cpu32 = refs[task_id, torch.float64], refs[task_id, torch.float32]
    else:
      ref = _task_b16(task_id, "cpu", torch.float64)
      cpu32 = _task_b16(task_id, "cpu", torch.float32)
    for f, bound in CARD_CPU_BOUND.items():
      err = np.abs(card[f] - ref[f]).max(-1)
      err32 = float(np.abs(cpu32[f] - ref[f]).max())
      worst_bound = max(bound, FLOAT32_MARGIN * err32)
      worst, median = float(err.max()), float(np.median(err))
      ok = worst <= worst_bound and median <= bound
      _say(f"manip {task_id} B=16: card float32 vs cpu float64 after 5 "
           f"steps, {f}: max abs err worst env {worst:.3e} (bound "
           f"{worst_bound:.3g}; cpu float32 {err32:.3e}), median env "
           f"{median:.3e} (bound {bound:g}) {'ok' if ok else 'FAIL'}")
      if not ok:
        raise AssertionError(f"{task_id}: card and CPU disagree on {f}")

    env = _task_env(task_id)
    obj, hand, body = _object_geoms(env, task_id)
    touched = torch.zeros(B_MAIN, dtype=torch.bool, device=DEVICE)
    lowest = torch.full((), np.inf, device=DEVICE)

    def on_step(i, prev, st, ended):
      nonlocal lowest
      c = st.data.contact
      g1, g2 = c.geom1.long(), c.geom2.long()
      pair = (obj[g1] & hand[g2]) | (hand[g1] & obj[g2])
      touched.logical_or_(((c.dist < 0) & pair).any(-1))
      lowest = torch.minimum(lowest, st.data.xpos[:, body, 2].min())

    st, run = _drive_b_main(env, MANIP_STEPS, on_step)
    seconds, timed, launches = run["seconds"], run["timed"], run["launches"]
    total += launches
    c = st.data.contact
    active = (c.dist < 0).sum(-1).float()
    n_touch = int(((c.dist < 0) & ((obj[c.geom1.long()] & hand[c.geom2.long()])
                                   | (hand[c.geom1.long()]
                                      & obj[c.geom2.long()]))).any(-1).sum())
    lowest = float(lowest)
    _say(f"manip {task_id} B={B_MAIN} (nv {env.model.nv}, frame_skip "
         f"{env.frame_skip}, horizon {env.horizon}): {MANIP_STEPS} control "
         f"steps, {timed} timed in {seconds:.3f} s: {run['rate']:.1f} "
         f"physics-steps/s (phase 4 of this call {phase4_rate:.1f}), "
         f"{seconds / timed * 1e3:.1f} ms per control step; spd_solve "
         f"launches {launches}; active contacts per env at the end "
         f"{float(active.mean()):.3f}; envs whose object touches the hand: "
         f"{n_touch / B_MAIN:.4f} at the end, {float(touched.float().mean()):.4f}"
         f" at some step; dropped {run['dropped']} in all "
         f"({run['dropped'] / (MANIP_STEPS * B_MAIN):.4f} per env and step), "
         f"{int(st.data.ncon_dropped.max())} at most in an env at the end; "
         f"lowest object centre {lowest:.4f}; autoreset "
         f"{run['restarted']} of {B_MAIN} envs")
    _b_main_checks(task_id, env, st, run)
    if not lowest > 0.0:
      raise AssertionError(f"{task_id}: the object fell through the plane")
    if not bool(touched.any()):
      raise AssertionError(f"{task_id}: no env's object touched the hand")
  return {"launches": total}


def phase_manip_train() -> dict:
  """13d: the CLI's SAC on the hold task."""
  from myosuite_mjx_tpu_torch.train import metrics
  from myosuite_mjx_tpu_torch.train.sac import SAC, SACConfig
  N = SAC_CFG["num_envs"]
  sac_kw = {k: v for k, v in SAC_CFG.items() if k != "num_envs"}
  with tempfile.TemporaryDirectory() as tmp, _sac_defaults(**sac_kw):
    run = _cli(["--env", MANIP_TRAIN_ENV, "--device", DEVICE,
                "--log-every", "1", "--algo", "sac", "--num-envs", str(N),
                "--total-steps", str(MANIP_SAC_ITERS * N),
                "--checkpoint-dir", os.path.join(tmp, "sac")])
    cfg = SACConfig(num_envs=N)
  env = _task_env(MANIP_TRAIN_ENV)
  init = _sac_nets(SAC(env, cfg, DEVICE).init(
      generator=torch.Generator(device=DEVICE).manual_seed(0)))
  final = _sac_nets(run["state"])
  moved = {k: float((final[k] - init[k]).abs().max()) for k in SAC_NETS}
  recs = run["records"]
  _say(f"manip train SAC {MANIP_TRAIN_ENV} via the CLI: {N} envs x "
       f"{SAC_CFG['updates_per_step']} updates, {MANIP_SAC_ITERS} "
       f"iterations in {run['seconds']:.3f} s; env-steps/s after the first "
       f"{[r['steps_per_s'] for r in recs[1:]]}; largest change from the "
       f"init {moved}; spd_solve launches {run['launches']}")
  for rec in recs:
    metrics.check_finite(rec, where="chip_smoke phase 13d")
  if [r["iter"] for r in recs] != list(range(1, MANIP_SAC_ITERS + 1)):
    raise AssertionError("the CLI did not log every iteration")
  if not all(moved[k] > 0 for k in ("actor", "q", "log_alpha")):
    raise AssertionError(f"SAC's nets did not move: {moved}")
  if run["launches"] <= 0:
    raise AssertionError("phase 13d never launched the SPD kernel")
  return {"launches": run["launches"]}


def phase_contact_tasks(phase4_rate: float, cpu_refs=None) -> dict:
  """Phase 13: 13a-13d, each timed; ``cpu_refs`` is a future of
  ``cpu_references()``."""
  t0 = time.perf_counter()
  refs = cpu_refs.result() if cpu_refs is not None else None
  _say(f"phase 13: waited {time.perf_counter() - t0:.1f} s for the CPU "
       f"references")
  out = {}
  for part, fn, args in (("13a", phase_pairs, ()),
                         ("13b", phase_prims, (refs,)),
                         ("13c", phase_manip, (phase4_rate, refs)),
                         ("13d", phase_manip_train, ())):
    t0 = time.perf_counter()
    res = fn(*args)
    _say(f"phase {part}: {time.perf_counter() - t0:.1f} s")
    if "launches" in res:
      out[f"phase{part}_launches"] = res["launches"]
  return out


# ---------------------------------------------------------------------------
# phase 14: heightfield contacts, sensors and the leg tasks
# ---------------------------------------------------------------------------


def _hfield_cases(t2: int, n: int, seed: int = 0):
  """(heights [N], field pos, field frame, geom pos, frame, size) as
  float64 numpy over ``n`` lanes: a quarter each separated, shallow, deep
  and centred on a cell corner, over a seeded HFIELD_GRID field turned
  about z."""
  from myosuite_mjx_tpu_torch.engine.model import GeomType as T
  rng = np.random.default_rng(seed)
  nrow, ncol = HFIELD_GRID
  sx, sy, sz = HFIELD_SIZE
  heights = rng.uniform(0.0, 1.0, nrow * ncol)
  yaw = 0.7
  fmat = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                   [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
  fpos = np.array([0.1, -0.2, 0.05])
  k = n // 4
  lx = rng.uniform(-sx, sx, n)
  ly = rng.uniform(-sy, sy, n)
  lx[3 * k:] = -sx + rng.integers(0, ncol, n - 3 * k) * 2 * sx / (ncol - 1)
  ly[3 * k:] = -sy + rng.integers(0, nrow, n - 3 * k) * 2 * sy / (nrow - 1)
  size = np.zeros((n, 3))
  size[:, 0] = rng.uniform(0.01, 0.04, n)
  if t2 == T.CAPSULE:
    size[:, 1] = rng.uniform(0.01, 0.04, n)
  lift = np.concatenate([rng.uniform(1.2, 2.0, k), rng.uniform(0.7, 1.0, k),
                         rng.uniform(-0.5, 0.3, k),
                         rng.uniform(-0.5, 1.5, n - 3 * k)])
  # the lift is over the field's bilinear height at the geom's centre
  gx = np.clip((lx + sx) / (2 * sx) * (ncol - 1), 0, ncol - 1.001)
  gy = np.clip((ly + sy) / (2 * sy) * (nrow - 1), 0, nrow - 1.001)
  c0, r0 = np.floor(gx).astype(int), np.floor(gy).astype(int)
  fx, fy = gx - c0, gy - r0
  h = heights.reshape(nrow, ncol)
  under = ((1 - fy) * ((1 - fx) * h[r0, c0] + fx * h[r0, c0 + 1])
           + fy * ((1 - fx) * h[r0 + 1, c0] + fx * h[r0 + 1, c0 + 1])) * sz
  local = np.stack([lx, ly, under + lift * size[:, 0]], -1)
  gpos = fpos + local @ fmat.T
  return (heights, np.broadcast_to(fpos, (n, 3)),
          np.broadcast_to(fmat, (n, 3, 3)), gpos, _rotations(rng, n), size)


def _hfield_narrow(t2: int, cases, device, dtype):
  from myosuite_mjx_tpu_torch.engine import collision
  heights, *rest = [torch.as_tensor(np.array(a), dtype=dtype, device=device)
                    for a in cases]
  field = collision._HField(adr=0, nrow=HFIELD_GRID[0], ncol=HFIELD_GRID[1],
                            size=HFIELD_SIZE, heights=heights)
  fpos, fmat, gpos, gmat, size = rest
  dist, pos, n = collision._hfield_fn(t2, heights, field)(
      fpos, fmat, torch.zeros_like(size), gpos, gmat, size)
  return [x.double().cpu().numpy() for x in (dist, pos, n.expand(pos.shape))]


def phase_hfield_pairs() -> dict:
  """14a: the heightfield pairs at B_MAIN, card float32 against CPU
  float64 (13a's bounds and flip rule)."""
  from myosuite_mjx_tpu_torch.engine.model import GeomType as T
  keys = tuple(PAIR_FLIP)
  for t2 in (T.SPHERE, T.CAPSULE):
    cases = _hfield_cases(t2, B_MAIN, seed=int(t2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = _hfield_narrow(t2, cases, DEVICE, torch.float32)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ref = _hfield_narrow(t2, cases, "cpu", torch.float64)
    cpu32 = _hfield_narrow(t2, cases, "cpu", torch.float32)

    def lane_errs(out):
      return {k: np.abs((a - b).reshape(B_MAIN, -1)).max(-1)
              for k, a, b in zip(keys, out, ref)}

    def flipped(e):
      return np.any([e[k] > PAIR_FLIP[k] for k in keys], 0)

    e, e32 = lane_errs(card), lane_errs(cpu32)
    med = {k: float(np.median(e[k])) for k in keys}
    flips, flips32 = flipped(e), flipped(e32)
    corner = slice(3 * (B_MAIN // 4), None)
    finite = all(np.isfinite(x).all() for x in card)
    good = (finite and flips.mean() <= flips32.mean() + PAIR_FLIP_SLACK
            and all(med[k] <= PAIR_MEDIAN_BOUND[k] for k in keys))
    _say(f"hfield pairs HFIELD-{T(t2).name} B={B_MAIN} x "
         f"{card[0].shape[-1]} points over a {HFIELD_GRID[0]} x "
         f"{HFIELD_GRID[1]} field, card float32 vs cpu float64: median "
         "lane " + ", ".join(f"{k} {med[k]:.2e}" for k in keys)
         + "; max " + ", ".join(f"{k} {float(e[k].max()):.2e}" for k in keys)
         + f"; flipped lanes {flips.mean():.4f} (cpu float32 "
         f"{flips32.mean():.4f}; on the cell-corner quarter "
         f"{flips[corner].mean():.4f}, elsewhere "
         f"{flips[:corner.start].mean():.4f}); touching lanes "
         f"{int((ref[0].min(-1) < 0).sum())}; {ms:.1f} ms "
         f"{'ok' if good else 'FAIL'}")
    if not good:
      raise AssertionError(f"hfield pair {T(t2).name}: card and CPU "
                           f"disagree, or non-finite")
  return {}


def phase_plate() -> dict:
  """14b: the force sensor at rest on the card (the sensor tests'
  static-weight anchor)."""
  from myosuite_mjx_tpu_torch.engine import api, sensors
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  phys = api.load(PLATE, torch.float32, DEVICE)
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  t0 = time.perf_counter()
  advance = phys.step_n(10)
  d = phys.make_data(1)
  for _ in range(PLATE_STEPS // 10):
    d = advance(d)
  d = phys.forward(d)
  m = phys.model
  site = int(m.sensor_objid[m.name2id("sensor", "plate_load")])
  got = sensors.force_sensor(phys.device_model, d, site)[0].double().cpu()
  seconds = time.perf_counter() - t0
  err = abs(float(got.norm()) - PLATE_WEIGHT) / PLATE_WEIGHT
  # at rest: the plate's tilt rate and the ball's linear velocity (the
  # ball may spin in place: condim 3 has no rolling friction)
  rest = float(d.qvel[:, :4].abs().max())
  spin = float(d.qvel[:, 4:].abs().max())
  ok = (err <= PLATE_BOUND and rest < PLATE_REST
        and bool(torch.isfinite(got).all()))
  _say(f"plate force sensor after {PLATE_STEPS} substeps on the card: "
       f"{got.numpy().round(4).tolist()} N in the site frame, |F| "
       f"{float(got.norm()):.4f} against the weight {PLATE_WEIGHT:.4f} "
       f"(rel err {err:.2e}, bound {PLATE_BOUND:g}); largest tilt rate and "
       f"ball speed {rest:.2e} (bound {PLATE_REST:g}), ball spin {spin:.2e};"
       f" {seconds:.1f} s; spd_solve launches "
       f"{cuda_linalg.spd_solve_cuda.launches} {'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("the plate's force sensor misses its weight, or "
                         "the scene did not come to rest")
  return {"launches": cuda_linalg.spd_solve_cuda.launches}


def _terrain_height(env, d) -> torch.Tensor:
  """The terrain's height [B] under each pelvis (world z), from the env's
  heights (its overlay, or the model's)."""
  from myosuite_mjx_tpu_torch.engine import collision
  m = env.model
  tid = m.name2id("geom", "terrain")
  dm = env.device_model(d.qpos.device)
  field = collision._hfield(dm, int(m.geom_dataid[tid]))
  heights = d.overlay.get("hfield_data")
  heights = field.heights if heights is None else heights[
      :, field.adr:field.adr + field.nrow * field.ncol]
  gpos, gmat = d.geom_xpos[:, tid], d.geom_xmat[:, tid]
  pel = d.xpos[:, m.name2id("body", "pelvis")]
  local = collision._mtv(gmat, pel - gpos)
  h, _ = collision._hfield_height_normal(local[:, :2], heights, field.size,
                                         field.nrow, field.ncol)
  return gpos[:, 2] + h


def phase_leg_tasks(phase4_rate: float, refs: dict | None = None) -> dict:
  """14c-d: the leg tasks through ``envs.make``; ``refs`` is
  ``cpu_references()`` (computed here without it)."""
  from myosuite_mjx_tpu_torch.engine import sensors
  out = {}
  for task_id in LEG_TASKS:
    _hold_b16(task_id, refs, "legs")

    env = _task_env(task_id)
    m = env.model
    dm = env.device_model(DEVICE)
    pelvis = m.name2id("body", "pelvis")
    sites = [int(m.sensor_objid[m.name2id("sensor", n)])
             for n in LEG_SENSORS]
    # the body's weight (a mocap opponent carries none)
    weight = float(np.sum(m.body_mass[np.asarray(m.body_mocapid) < 0])
                   * -m.opt.gravity[2])
    grounded = torch.zeros(B_MAIN, dtype=torch.bool, device=DEVICE)
    margin = torch.full((), np.inf, device=DEVICE)

    def on_step(i, prev, st, ended):
      nonlocal margin
      grounded.logical_or_((st.data.contact.dist < 0).any(-1))
      pz = st.data.xpos[:, pelvis, 2]
      margin = torch.minimum(margin, torch.minimum(
          pz, pz - _terrain_height(env, st.data)).min())

    st, run = _drive_b_main(env, LEG_STEPS, on_step)
    seconds, timed, launches = run["seconds"], run["timed"], run["launches"]
    rate = run["rate"]
    c = st.data.contact
    active = (c.dist < 0).sum(-1).float()
    grf = sum(sensors.touch_sensor(dm, st.data, s) for s in sites)
    on_ground = (c.dist < 0).any(-1)
    margin = float(margin)
    _say(f"legs {task_id} B={B_MAIN} (nv {m.nv}, nu {m.nu}, frame_skip "
         f"{env.frame_skip}, horizon {env.horizon}): {LEG_STEPS} control "
         f"steps, {timed} timed in {seconds:.3f} s: {rate:.1f} "
         f"physics-steps/s, {rate / phase4_rate:.3f} of phase 4's "
         f"{phase4_rate:.1f}, {seconds / timed * 1e3:.1f} ms per control "
         f"step; spd_solve launches {launches} "
         f"({launches / LEG_STEPS:.1f} per control step); active contacts "
         f"per env at the end {float(active.mean()):.3f}; envs with a foot "
         f"on the ground {float(on_ground.float().mean()):.4f} at the end, "
         f"{float(grounded.float().mean()):.4f} at some step; dropped "
         f"{run['dropped']} in all "
         f"({run['dropped'] / (LEG_STEPS * B_MAIN):.4f} "
         f"per env and step); GRF of the four foot sensors, median env "
         f"{float(grf.median()):.1f} N against the body weight "
         f"{weight:.1f} N ({float(grf.median()) / weight:.3f}); lowest "
         f"pelvis over the floor and the terrain {margin:.4f} m; autoreset "
         f"{run['restarted']} of {B_MAIN} envs")
    _b_main_checks(task_id, env, st, run)
    if not margin > 0.0:
      raise AssertionError(f"{task_id}: a pelvis went below the terrain")
    if not bool(grounded.any()):
      raise AssertionError(f"{task_id}: no foot touched the ground")
    out[f"phase14_{task_id}_launches"] = launches
  out["launches"] = sum(out.values())
  return out


def phase_leg_profile() -> dict:
  """14e: ``tools/profile_step.py`` on PROFILE_ENV, in process."""
  return _profile(PROFILE_ENV)


def phase_legs(phase4_rate: float, cpu_refs=None) -> dict:
  """Phase 14: 14a-14e, each timed; ``cpu_refs`` is a future of
  ``cpu_references()``."""
  refs = cpu_refs.result() if cpu_refs is not None else None
  out = {}
  for part, fn, args in (("14a", phase_hfield_pairs, ()),
                         ("14b", phase_plate, ()),
                         ("14cd", phase_leg_tasks, (phase4_rate, refs)),
                         ("14e", phase_leg_profile, ())):
    t0 = time.perf_counter()
    res = fn(*args)
    _say(f"phase {part}: {time.perf_counter() - t0:.1f} s")
    if "launches" in res:
      out[f"phase{part}_launches"] = res.pop("launches")
    out.update(res)
  return out


# ---------------------------------------------------------------------------
# phase 15: mesh hulls and the rest of the hand and arm tasks
# ---------------------------------------------------------------------------


def _mesh_cases(t1: int, verts: np.ndarray, n: int, seed: int = 0):
  """(p1, m1, s1, p2, m2, s2) as float64 numpy [n, ...] for geom1 of type
  ``t1`` against a hull with vertices ``verts`` (geom2): a quarter each
  separated, shallow, deep and with geom1's centre inside the hull. geom1
  sits along a random direction from the hull (above a plane's normal) at
  a share of the summed support extents."""
  from myosuite_mjx_tpu_torch.engine.model import GeomType as T
  rng = np.random.default_rng(seed)
  out, k = [], n // 4
  for share, plane_share in ((1.4, 1.4), (0.93, 0.93), (0.5, 0.3),
                             (0.1, -0.4)):
    m1, m2 = _rotations(rng, k), _rotations(rng, k)
    s1 = rng.uniform(0.005, 0.02, (k, 3))
    if t1 == T.SPHERE:
      s1[:, 1:] = 0.0
    if t1 == T.CAPSULE:
      s1[:, 1] = rng.uniform(0.01, 0.05, k)
      s1[:, 2] = 0.0
    p2 = rng.uniform(-0.05, 0.05, (k, 3))
    if t1 == T.PLANE:
      u = -m1[:, :, 2]
      hull = (np.einsum("nij,vj->nvi", m2, verts) * -u[:, None]).sum(-1)
      p1 = p2 + plane_share * hull.max(-1)[:, None] * u
    else:
      u = rng.normal(size=(k, 3))
      u /= np.linalg.norm(u, axis=-1, keepdims=True)
      hull = (np.einsum("nij,vj->nvi", m2, verts) * u[:, None]).sum(-1)
      d = np.einsum("nji,nj->ni", m1, -u)
      ext = (s1[:, 0] if t1 == T.SPHERE else
             s1[:, 0] + s1[:, 1] * np.abs(d[:, 2]) if t1 == T.CAPSULE else
             np.linalg.norm(s1 * d, axis=-1))
      p1 = p2 + (share * (hull.max(-1) + ext))[:, None] * u
    out.append((p1, m1, s1, p2, m2, np.zeros((k, 3))))
  return tuple(np.concatenate(x) for x in zip(*out))


def _mesh_narrow(t1: int, cases, device, dtype):
  from myosuite_mjx_tpu_torch.engine import api, collision
  dm = api.load(HULLS, dtype, device).device_model
  args = [torch.as_tensor(a, dtype=dtype, device=device) for a in cases]
  dist, pos, n = collision._mesh_fn(t1, collision._hull(dm, 0))(*args)
  return [x.double().cpu().numpy() for x in (dist, pos, n.expand(pos.shape))]


def phase_mesh_pairs() -> dict:
  """15a: the mesh pairs at B_MAIN, card float32 against CPU float64
  (13a's bounds and flip rule)."""
  from myosuite_mjx_tpu_torch.engine import api, collision
  from myosuite_mjx_tpu_torch.engine.model import GeomType as T
  keys = tuple(PAIR_FLIP)
  verts = np.asarray(api.load(HULLS, torch.float64,
                              "cpu").model.mesh_hull_verts[0])
  for types in sorted(collision.MESH):
    cases = _mesh_cases(types[0], verts, B_MAIN, seed=int(types[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = _mesh_narrow(types[0], cases, DEVICE, torch.float32)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ref = _mesh_narrow(types[0], cases, "cpu", torch.float64)
    cpu32 = _mesh_narrow(types[0], cases, "cpu", torch.float32)

    def lane_errs(out):
      return {k: np.abs((a - b).reshape(B_MAIN, -1)).max(-1)
              for k, a, b in zip(keys, out, ref)}

    def flipped(e):
      return float(np.any([e[k] > PAIR_FLIP[k] for k in keys], 0).mean())

    e, e32 = lane_errs(card), lane_errs(cpu32)
    med = {k: float(np.median(e[k])) for k in keys}
    flips, flips32 = flipped(e), flipped(e32)
    finite = all(np.isfinite(x).all() for x in card)
    good = (finite and flips <= flips32 + PAIR_FLIP_SLACK
            and all(med[k] <= PAIR_MEDIAN_BOUND[k] for k in keys))
    name = f"{T(types[0]).name}-{T(types[1]).name}"
    _say(f"mesh pairs {name} B={B_MAIN} x {card[0].shape[-1]} points "
         f"against a hull of {len(verts)} vertices, card float32 vs cpu "
         f"float64: median lane " + ", ".join(f"{k} {med[k]:.2e}"
                                             for k in keys)
         + "; max " + ", ".join(f"{k} {float(e[k].max()):.2e}" for k in keys)
         + f"; flipped lanes {flips:.4f} (cpu float32 {flips32:.4f}); "
         f"touching lanes {int((ref[0].min(-1) < 0).sum())}; {ms:.1f} ms "
         f"{'ok' if good else 'FAIL'}")
    if not good:
      raise AssertionError(f"mesh pair {name}: card and CPU disagree, or "
                           f"non-finite")
  return {}


def _hulls_start(phys, batch: int):
  """``batch`` hulls envs: each body's start moved by up to 3 mm, small
  random velocities (0.02 m/s or rad/s)."""
  rng = np.random.default_rng(1)
  d = phys.make_data(batch)
  qpos = d.qpos.double().cpu().numpy()
  for b in range(phys.model.nq // 7):
    qpos[:, 7 * b:7 * b + 3] += rng.uniform(-0.003, 0.003, (batch, 3))
  qvel = rng.normal(scale=0.02, size=(batch, phys.model.nv))
  t = lambda x: torch.as_tensor(x, dtype=phys.dtype, device=phys.device)
  return d.replace(qpos=t(qpos), qvel=t(qvel))


def _hulls_b16(device, dtype) -> dict:
  """The hulls scene's 16 envs after HULLS_STEPS substeps: qpos, qvel."""
  from myosuite_mjx_tpu_torch.engine import api
  phys = api.load(HULLS, dtype, device)
  d = _hulls_start(phys, 16)
  for _ in range(HULLS_STEPS):
    d = phys.step(d)
  return {f: getattr(d, f).double().cpu().numpy() for f in FREE_CPU_BOUND}


def phase_hulls(refs: dict | None = None) -> dict:
  """15b: the mesh pairs in dynamics through ``Physics`` on the hulls
  scene; ``refs`` is ``cpu_references()`` (computed here without it)."""
  from myosuite_mjx_tpu_torch.engine import api, collision
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  card = _hulls_b16(DEVICE, torch.float32)
  ref = refs["hulls"] if refs else _hulls_b16("cpu", torch.float64)
  for f, bound in FREE_CPU_BOUND.items():
    err = np.abs(card[f] - ref[f]).max(-1)
    worst, median = float(err.max()), float(np.median(err))
    ok = worst <= bound
    _say(f"hulls B=16, {HULLS_STEPS} substeps, card float32 vs cpu "
         f"float64, {f}: max abs err worst env {worst:.3e}, median env "
         f"{median:.3e} (bound {bound:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"hulls: card and CPU disagree on {f}")

  phys = api.load(HULLS, torch.float32, DEVICE)
  m = phys.model
  spec = collision.collision_spec(phys.device_model)
  mesh_groups = [g for g in spec.groups if g.hull is not None]
  d = _hulls_start(phys, B_MAIN)
  advance = phys.step_n(10)
  d = advance(d)
  touched = {tuple(g.types): False for g in mesh_groups}
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(HULLS_WINDOW // 10 - 1):
    d = advance(d)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  rate = (HULLS_WINDOW - 10) * B_MAIN / seconds
  for g in mesh_groups:
    dist, _, _ = collision.group_fn(g, d)(
        d.geom_xpos[:, g.g1], d.geom_xmat[:, g.g1],
        g.size1.expand(B_MAIN, -1, -1), d.geom_xpos[:, g.g2],
        d.geom_xmat[:, g.g2], g.size2.expand(B_MAIN, -1, -1))
    touched[tuple(g.types)] = float((dist < 0).any(-1).any(-1).float().mean())
  nbody = m.nq // 7
  speed = d.qvel.reshape(B_MAIN, nbody, 6).abs().amax(-1)
  # the geoms' centres (a mesh geom's is its centroid; the slab's body
  # origin is its bottom face)
  height = d.geom_xpos[:, np.asarray(m.geom_bodyid) > 0, 2]
  active = (d.contact.dist < 0).sum(-1)
  median = float(speed.amax(-1).median())
  lowest = float(height.min())
  from myosuite_mjx_tpu_torch.engine.model import GeomType as T
  _say(f"hulls B={B_MAIN}: {HULLS_WINDOW} substeps, {HULLS_WINDOW - 10} "
       f"timed in {seconds:.3f} s: {rate:.1f} physics-steps/s "
       f"({seconds / (HULLS_WINDOW - 10) * 1e3:.1f} ms per substep); "
       f"active contacts per env {float(active.float().mean()):.3f}, "
       f"dropped {float(d.ncon_dropped.float().mean()):.3f} per env; share "
       f"of envs touching per mesh pair at the end "
       + ", ".join(f"{T(t[0]).name}-MESH {v:.4f}"
                   for t, v in sorted(touched.items()))
       + f"; fastest body per env, median {median:.4f} (bound {HULLS_REST});"
       f" lowest geom centre {lowest:.4f}; spd_solve launches "
       f"{cuda_linalg.spd_solve_cuda.launches}")
  for name, x in (("qpos", d.qpos), ("qvel", d.qvel)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"hulls: non-finite {name} at B={B_MAIN}")
  if set(touched) != collision.MESH or not all(touched.values()):
    raise AssertionError(f"hulls: a mesh pair never touched: {touched}")
  if not (median <= HULLS_REST and lowest > 0.0):
    raise AssertionError("hulls: the bodies did not come to rest, or one "
                         "fell through the plane")
  if cuda_linalg.spd_solve_cuda.launches <= 0:
    raise AssertionError("phase 15b never launched the SPD kernel")
  return {"launches": cuda_linalg.spd_solve_cuda.launches}


def _hand_arm_checks(env, st, task_id: str, first: bool) -> None:
  """15d's task checks on a state: the baoding balls above ``drop_th``
  (``first``: at the init), one active SAR object geom per env sized
  from its table."""
  if task_id.startswith("hand23Baoding") and first:
    z = st.data.site_xpos[:, [env.object1_sid, env.object2_sid], 2]
    low = float(z.min())
    _say(f"hand-arm {task_id}: lowest ball at the init {low:.4f} m "
         f"(drop_th {env.drop_th})")
    if not low > env.drop_th:
      raise AssertionError(f"{task_id}: a ball starts below drop_th")
  if task_id.startswith("hand23Reorient"):
    from myosuite_mjx_tpu_torch.envs import reorient_sar
    sizes = st.data.overlay["geom_size"][:, env.obj_gids]      # [B, 4, 3]
    active = (sizes > 1e-5).any(-1)
    t = st.aux["type_idx"].long()
    tables = [torch.as_tensor(x, dtype=sizes.dtype, device=sizes.device)
              for x in reorient_sar.geometry_table(env.TABLE)]
    own = sizes[torch.arange(len(t), device=t.device), t]
    in_table = torch.zeros_like(t, dtype=torch.bool)
    for i, tab in enumerate(tables):
      hit = (own[:, None, :] == tab[None]).all(-1).any(-1)
      in_table |= (t == i) & hit
    one = (active.sum(-1) == 1) & active.gather(1, t[:, None])[:, 0]
    if not bool(one.all() and in_table.all()):
      raise AssertionError(f"{task_id}: not exactly one object geom active "
                           f"per env with its table's size")


def phase_hand_arm_tasks(phase4_rate: float, refs: dict | None = None) -> dict:
  """15c-d: the new hand and arm tasks through ``envs.make``; ``refs`` is
  ``cpu_references()`` (computed here without it)."""
  out = {}
  for task_id in HAND_ARM_TASKS:
    _hold_b16(task_id, refs, "hand-arm")

    env = _task_env(task_id)
    m = env.model
    bimanual = task_id.endswith("Bimanual-v0")
    touching = torch.zeros(5, device=DEVICE)
    ended_first = []

    def on_step(i, prev, st, ended):
      if i == 0:
        ended_first.append(float(st.info["terminated"].float().mean()))
      if bimanual:
        touching.add_(env._touching_vec(st.data).sum(0))

    st, run = _drive_b_main(
        env, HAND_ARM_STEPS, on_step,
        on_init=lambda st: _hand_arm_checks(env, st, task_id, first=True))
    seconds, timed, launches = run["seconds"], run["timed"], run["launches"]
    rate = run["rate"]
    ended_first = ended_first[0]
    active = (st.data.contact.dist < 0).sum(-1).float()
    _hand_arm_checks(env, st, task_id, first=False)
    extra = ""
    if bimanual:
      extra = ("; touching classes (arm, prosthesis, start, goal, other), "
               "env-steps with the class on: "
               + str([int(x) for x in touching.tolist()]))
    _say(f"hand-arm {task_id} B={B_MAIN} (nv {m.nv}, nu {m.nu}, frame_skip "
         f"{env.frame_skip}, horizon {env.horizon}): {HAND_ARM_STEPS} "
         f"control steps, {timed} timed in {seconds:.3f} s: {rate:.1f} "
         f"physics-steps/s, {rate / phase4_rate:.3f} of phase 4's "
         f"{phase4_rate:.1f}, {seconds / timed * 1e3:.1f} ms per control "
         f"step; spd_solve launches {launches} ({launches / HAND_ARM_STEPS:.1f}"
         f" per control step); active contacts per env at the end "
         f"{float(active.mean()):.3f}; dropped {run['dropped']} in all "
         f"({run['dropped'] / (HAND_ARM_STEPS * B_MAIN):.4f} per env and "
         f"step); envs ended by the task at step 1 {ended_first:.4f}; "
         f"autoreset {run['restarted']} of {B_MAIN} envs{extra}")
    _b_main_checks(task_id, env, st, run)
    if ended_first >= 1.0:
      raise AssertionError(f"{task_id}: every env ended at step 1")
    if bimanual and not float(touching.sum()) > 0:
      raise AssertionError(f"{task_id}: no env reported a touching class")
    out[f"phase15_{task_id}_launches"] = launches
  out["launches"] = sum(out.values())
  return out


def phase_arm_profile() -> dict:
  """15e: ``tools/profile_step.py`` on PROFILE_ARM_ENV, in process."""
  return _profile(PROFILE_ARM_ENV)


def phase_hand_arm(phase4_rate: float, cpu_refs=None) -> dict:
  """Phase 15: 15a-15e, each timed; ``cpu_refs`` is a future of
  ``cpu_references()``."""
  refs = cpu_refs.result() if cpu_refs is not None else None
  out = {}
  for part, fn, args in (("15a", phase_mesh_pairs, ()),
                         ("15b", phase_hulls, (refs,)),
                         ("15cd", phase_hand_arm_tasks, (phase4_rate, refs)),
                         ("15e", phase_arm_profile, ())):
    t0 = time.perf_counter()
    res = fn(*args)
    _say(f"phase {part}: {time.perf_counter() - t0:.1f} s")
    if "launches" in res:
      out[f"phase{part}_launches"] = res.pop("launches")
    out.update(res)
  return out


# ---------------------------------------------------------------------------
# phase 16: the OSL RunTrack and MyoDM tracking tasks
# ---------------------------------------------------------------------------


def phase_osl_machine() -> dict:
  """16a: ``osl.step`` on the card (float32) against the port on the CPU
  (float64) on the same seeded float32 sensor vectors and states."""
  from myosuite_mjx_tpu_torch.envs import osl
  rng = np.random.default_rng(0)
  n = OSL_SAMPLES
  bw = 63.65 * 9.81
  state = rng.integers(0, 4, n).astype(np.int32)
  sens = np.stack([
      rng.uniform(-1.5, 1.6, n), rng.uniform(-0.3, 0.3, n),
      rng.uniform(-0.5, 0.5, n), rng.uniform(-2.0, 2.0, n),
      rng.uniform(-0.1, 0.6, n) * bw], 1).astype(np.float32)
  p = osl.OSLParams(body_weight=bw)
  s_card, t_card = osl.step(torch.as_tensor(state, device=DEVICE),
                            torch.as_tensor(sens, device=DEVICE), p)
  s_cpu, t_cpu = osl.step(torch.as_tensor(state),
                          torch.as_tensor(sens).double(), p)
  s_card, t_card = s_card.cpu().numpy(), t_card.double().cpu().numpy()
  moved = s_cpu.numpy() != state
  same = int((s_card == s_cpu.numpy()).sum())
  err = float(np.abs(t_card - t_cpu.numpy()).max())
  hist = np.bincount(s_card, minlength=4).tolist()
  ok = same == n and err <= OSL_TORQUE_BOUND
  _say(f"osl machine B={n}: card float32 vs cpu float64: states equal "
       f"{same} of {n}, torque max abs err {err:.3e} N m (bound "
       f"{OSL_TORQUE_BOUND:g}); transitions {int(moved.sum())}; states "
       f"after the step {hist} {'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("the OSL machine disagrees between card and CPU")
  return {}


def phase_osl_track_tasks(phase4_rate: float, refs: dict | None = None
                          ) -> dict:
  """16b-c: the OSL and tracking tasks through ``envs.make``; ``refs`` is
  ``cpu_references()`` (computed here without it)."""
  for task_id in OSL_TRACK_TASKS:
    _hold_b16(task_id, refs, "osl-track")
  out = {}
  for task_id in OSL_TRACK_RATE_TASKS:
    env = _task_env(task_id)
    m = env.model
    osl_task = task_id.startswith("osl54")
    left0 = torch.zeros(B_MAIN, dtype=torch.bool, device=DEVICE)
    states = torch.zeros(4, dtype=torch.int64, device=DEVICE)
    bonus = torch.zeros((), device=DEVICE)
    contacts = torch.zeros((), device=DEVICE)

    def on_step(i, prev, st, ended):
      contacts.add_((st.data.contact.dist < 0).sum())
      if osl_task:
        # the machine's step is in the pre-reset state: count it in the
        # envs that did not reset
        now = st.aux["osl_state"].long()
        left0.logical_or_((prev.aux["osl_state"] == 0) & (now != 0)
                          & ~ended)
        states.add_(torch.bincount(now, minlength=4))
      else:
        rwd = env.get_reward_dict(env.get_obs_dict(st.data, st.aux),
                                  st.data, st.aux)
        bonus.add_(rwd["bonus"].sum())

    st, run = _drive_b_main(env, OSL_TRACK_STEPS, on_step)
    seconds, timed, launches = run["seconds"], run["timed"], run["launches"]
    rate = run["rate"]
    env_steps = OSL_TRACK_STEPS * B_MAIN
    extra = (f"; OSL states over env-steps {states.tolist()}, envs that "
             f"left early stance {int(left0.sum())}" if osl_task else
             f"; lift bonus in {int(bonus)} env-steps (lift height "
             f"{env._lift_z:.4f} m)")
    _say(f"osl-track {task_id} B={B_MAIN} (nv {m.nv}, nu {m.nu}, "
         f"frame_skip {env.frame_skip}, horizon {env.horizon}): "
         f"{OSL_TRACK_STEPS} control steps, {timed} timed in {seconds:.3f} "
         f"s: {rate:.1f} physics-steps/s, {rate / phase4_rate:.3f} of phase "
         f"4's {phase4_rate:.1f}, {seconds / timed * 1e3:.1f} ms per control "
         f"step; spd_solve launches {launches} "
         f"({launches / OSL_TRACK_STEPS:.1f} per control step); active "
         f"contacts per env and step {float(contacts) / env_steps:.3f}; "
         f"dropped {run['dropped']} ({run['dropped'] / env_steps:.4f} per "
         f"env and step); autoreset {run['restarted']} of {B_MAIN} envs"
         f"{extra}")
    _b_main_checks(task_id, env, st, run)
    if osl_task and not bool(left0.any()):
      raise AssertionError(f"{task_id}: the OSL machine never left early "
                           f"stance")
    out[f"phase16_{task_id}_launches"] = launches
  out["launches"] = sum(out.values())
  return out


def phase_osl_track(phase4_rate: float, cpu_refs=None) -> dict:
  """Phase 16: 16a and 16b-c, each timed; ``cpu_refs`` is a future of
  ``cpu_references()``."""
  refs = cpu_refs.result() if cpu_refs is not None else None
  out = {}
  for part, fn, args in (("16a", phase_osl_machine, ()),
                         ("16bc", phase_osl_track_tasks,
                          (phase4_rate, refs))):
    t0 = time.perf_counter()
    res = fn(*args)
    _say(f"phase {part}: {time.perf_counter() - t0:.1f} s")
    if "launches" in res:
      out["phase16_launches"] = res.pop("launches")
    out.update(res)
  return out


# ---------------------------------------------------------------------------
# phase 17: the general kernel's paths (float64, n > 64), IK and the
# examine commands
# ---------------------------------------------------------------------------


def _pose_b16(device, dtype) -> dict:
  """hand23 PoseFixed, 16 envs, F64_STEPS control steps of seeded actions."""
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  actions = np.random.default_rng(0).uniform(0.0, 1.0, (F64_STEPS, 16, 39))
  benv = BatchedEnv(PoseEnv(HAND23, dtype=dtype, **HAND_POSE_FIXED), 16,
                    device)
  st = benv.init()
  for a in actions:
    st = benv.step(st, torch.as_tensor(a, dtype=dtype, device=device))
  return {f: getattr(st.data, f).double().cpu().numpy()
          for f in F64_CARD_CPU_BOUND}


def phase_f64_env(refs: dict | None = None) -> None:
  """17a: MyoEnv in float64 on the card against the CPU port; ``refs`` is
  ``cpu_references()`` (computed here without it)."""
  card = _pose_b16(DEVICE, torch.float64)
  ref = refs["pose_f64"] if refs else _pose_b16("cpu", torch.float64)
  for f, bound in F64_CARD_CPU_BOUND.items():
    err = np.abs(card[f] - ref[f]).max(-1)
    median, flips = float(np.median(err)), int((err > bound).sum())
    ok = (median <= bound and flips <= F64_FLIP_ENVS
          and np.isfinite(card[f]).all())
    _say(f"17a hand23 PoseFixed float64 B=16, {F64_STEPS} control steps, "
         f"card vs cpu, {f}: median env {median:.3e} (bound {bound:g}); "
         f"envs past it {flips} (at most {F64_FLIP_ENVS}); worst env "
         f"{float(err.max()):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"17a: float64 card and CPU disagree on {f}")


def _chain_start(phys, batch: int):
  """``batch`` chain72 envs at qpos0 with small seeded joint velocities."""
  qvel = np.random.default_rng(0).normal(scale=0.05,
                                         size=(batch, phys.model.nv))
  d = phys.make_data(batch)
  return d.replace(qvel=torch.as_tensor(qvel, dtype=phys.dtype,
                                        device=phys.device))


def _chain_b16(device, dtype) -> dict:
  """chain72's 16 envs after CHAIN_STEPS substeps: qpos and qvel as
  float64 on the host."""
  from myosuite_mjx_tpu_torch.engine import api
  phys = api.load(CHAIN72, dtype, device)
  d = phys.step_n(CHAIN_STEPS)(_chain_start(phys, 16))
  return {f: getattr(d, f).double().cpu() for f in ("qpos", "qvel")}


def phase_chain72(refs: dict | None = None) -> dict:
  """17b: chain72 through Physics, B = 16 against the CPU in both types,
  then float32 at B_MAIN; ``refs`` is ``cpu_references()`` (computed here
  without it)."""
  from myosuite_mjx_tpu_torch.engine import api
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  ref = refs["chain72"] if refs else _chain_b16("cpu", torch.float64)
  for dtype, bounds in CHAIN_CPU_BOUND.items():
    card_d = _chain_b16(DEVICE, dtype)
    for f, bound in bounds.items():
      card = card_d[f]
      err = float((card - ref[f]).abs().max())
      ok = err <= bound and bool(torch.isfinite(card).all())
      _say(f"17b chain72 B=16, {CHAIN_STEPS} substeps, card "
           f"{str(dtype)[6:]} vs cpu float64, {f}: max abs err {err:.3e} "
           f"(bound {bound:g}; peak |{f}| {float(ref[f].abs().max()):.3f}) "
           f"{'ok' if ok else 'FAIL'}")
      if not ok:
        raise AssertionError(f"chain72: card {dtype} and CPU disagree on "
                             f"{f}")

  phys = api.load(CHAIN72, torch.float32, DEVICE)
  advance = phys.step_n(CHAIN_STEPS)
  d = phys.step_n(2)(_chain_start(phys, B_MAIN))
  torch.cuda.synchronize()
  n0 = cuda_linalg.spd_solve_general_cuda.launches
  t0 = time.perf_counter()
  d = advance(d)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = cuda_linalg.spd_solve_general_cuda.launches - n0
  rate = CHAIN_STEPS * B_MAIN / seconds
  active = (d.contact.dist < 0).sum(-1).float()
  touching = float((active > 0).float().mean())
  _say(f"17b chain72 float32 B={B_MAIN}: {CHAIN_STEPS} substeps in "
       f"{seconds:.3f} s: {rate:.1f} physics-steps/s; general kernel "
       f"launches {launches} ({launches / CHAIN_STEPS:.1f} per substep); "
       f"active contacts per env {float(active.mean()):.2f} (envs touching "
       f"{touching:.4f}), dropped {int(d.ncon_dropped.sum())}, ne_active "
       f"mean {float(d.ne_active.float().mean()):.2f}")
  for name, x in (("qpos", d.qpos), ("qvel", d.qvel)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"chain72: non-finite {name} at B={B_MAIN}")
  if launches <= 0 or touching < 0.5:
    raise AssertionError("chain72: no general kernel launch, or the chain "
                         "left the floor in most envs")
  return {"chain72_physics_steps_per_s": rate}


def _ik_case(device, dtype, batch: int, seed: int = 0):
  """IK of hand23's IK_SITE to the site's positions at ``batch`` seeded
  feasible poses, on ``device``: (result, targets, reached, seconds)."""
  from myosuite_mjx_tpu_torch.engine import model as model_mod
  from myosuite_mjx_tpu_torch.engine import smooth
  from myosuite_mjx_tpu_torch.utils import ik
  m = model_mod.load_npz(HAND23)
  dm = model_mod.DeviceModel(m, dtype, device)
  lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
  goals = lo + np.random.default_rng(seed).uniform(
      0.25, 0.75, (batch, m.nq)) * (hi - lo)
  sid = m.name2id("site", IK_SITE)
  site = lambda q: smooth.kinematics(dm, q)["site_xpos"][:, sid]
  target = site(torch.as_tensor(goals, dtype=dtype, device=device))
  if device != "cpu":
    torch.cuda.synchronize()
  t0 = time.perf_counter()
  res = ik.qpos_from_site_pose(dm, IK_SITE, target_pos=target, tol=IK_TOL,
                               max_steps=IK_MAX_STEPS)
  if device != "cpu":
    torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  reached = torch.linalg.vector_norm(site(res.qpos) - target, dim=-1)
  return res, reached, seconds


def phase_ik() -> None:
  """17c: IK at B_MAIN in float32 and float64; float64 at B = 16 against
  the CPU."""
  for dtype in (torch.float32, torch.float64):
    res, reached, seconds = _ik_case(DEVICE, dtype, B_MAIN)
    share = float(res.success.double().mean())
    _say(f"17c IK {IK_SITE} {str(dtype)[6:]} B={B_MAIN}: success "
         f"{share:.4f} (tol {IK_TOL:g}), steps mean "
         f"{float(res.steps.double().mean()):.2f} max {int(res.steps.max())}"
         f", reach error median {float(reached.median()):.3e} max "
         f"{float(reached.max()):.3e} m, {seconds:.3f} s")
    if not (bool(torch.isfinite(res.qpos).all()) and share > 0.9):
      raise AssertionError(f"IK {dtype}: non-finite qpos or success "
                           f"{share}")
  card, _, _ = _ik_case(DEVICE, torch.float64, 16, seed=1)
  cpu, _, _ = _ik_case("cpu", torch.float64, 16, seed=1)
  err = float((card.qpos.cpu() - cpu.qpos).abs().max())
  same = (torch.equal(card.success.cpu(), cpu.success)
          and torch.equal(card.steps.cpu(), cpu.steps))
  ok = same and err <= IK_QPOS_BOUND
  _say(f"17c IK float64 B=16 card vs cpu: qpos max abs err {err:.3e} "
       f"(bound {IK_QPOS_BOUND:g}), success and steps equal {same} "
       f"{'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("IK: float64 card and CPU disagree")


def phase_examine() -> None:
  """17d: one short call of each examine command through ``main``."""
  from myosuite_mjx_tpu_torch.logger.trace import Trace
  from myosuite_mjx_tpu_torch.utils import (examine_env, examine_logs,
                                            examine_reference, examine_sim)
  with tempfile.TemporaryDirectory() as tmp:
    sim = examine_sim.main(["--model_path", CHAIN72, "--horizon", "10",
                            "--device", DEVICE])
    if not np.isfinite(sim["qpos"]).all():
      raise AssertionError("examine_sim: non-finite qpos")
    out = examine_env.main(["-e", EXAMINE_ROLLOUT_ENV, "-n", "16", "-o", tmp,
                            "-f", "pickle", "--device", DEVICE])
    trace = Trace.load(out)
    if len(trace.trace) != 16 or not all(
        np.isfinite(g["observations"]).all() for g in trace.trace.values()):
      raise AssertionError("examine_env: missing or non-finite trials")
    rec = examine_logs.main(["-e", EXAMINE_ENV, "-m", "record", "--horizon",
                             "5", "--num_repeat", "16", "-o", tmp, "-f",
                             "pickle", "--device", DEVICE])
    res = examine_logs.main(["-e", EXAMINE_ENV, "-m", "playback", "-p", rec,
                             "--device", DEVICE])
    worst = max(max(r["obs_err"], r["qpos_drift"]) for r in res.values())
    _say(f"17d examine_logs record -> playback on the card: {len(res)} "
         f"trials, largest difference from the log {worst:.3e} "
         f"{'ok' if worst == 0.0 else 'FAIL'}")
    if worst != 0.0:
      raise AssertionError("examine_logs: playback does not reproduce the "
                           "log exactly")
    frames = examine_reference.main(["-e", EXAMINE_TRACK, "--device",
                                     DEVICE])
    if not np.isfinite(frames).all():
      raise AssertionError("examine_reference: non-finite frames")


def phase_general_paths(cpu_refs=None) -> dict:
  """Phase 17; both kernels' counts are set to 0 here and read at the
  end, each part's general-kernel launches apart. ``cpu_refs`` is a
  future of ``cpu_references()``."""
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  refs = cpu_refs.result() if cpu_refs is not None else None
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  cuda_linalg.spd_solve_general_cuda.launches = 0
  parts, out = {}, {}
  for part, fn, args in (("a", phase_f64_env, (refs,)),
                         ("b", phase_chain72, (refs,)),
                         ("c", phase_ik, ()), ("d", phase_examine, ())):
    n0, t0 = cuda_linalg.spd_solve_general_cuda.launches, time.perf_counter()
    res = fn(*args)
    torch.cuda.synchronize()
    parts[part] = cuda_linalg.spd_solve_general_cuda.launches - n0
    out.update(res or {})
    _say(f"phase 17{part}: {time.perf_counter() - t0:.1f} s, general kernel "
         f"launches {parts[part]}")
    if parts[part] <= 0:
      raise AssertionError(f"phase 17{part} never launched the general "
                           f"kernel")
  return {"launches": cuda_linalg.spd_solve_general_cuda.launches,
          "register_launches": cuda_linalg.spd_solve_cuda.launches,
          "parts": parts, **out}


# ---------------------------------------------------------------------------
# phase 18: the reflex walker and its tuner, the gym adapter and the CNN
# encoder, the data-parallel learners and the tools
# ---------------------------------------------------------------------------


def _reflex_inputs(n: int, seed: int = 0):
  """Seeded float32 inputs of ``reflex_update``: control parameters
  [n, 46] from params around 1, phase flags [n, 2] and a sensor dict
  spread over every threshold of the phase logic."""
  from myosuite_mjx_tpu_torch.agents import reflex
  rng = np.random.default_rng(seed)
  cp = reflex.expand_params(rng.uniform(-0.5, 2.5, (n, reflex.N_PARAMS)),
                            torch.float32, "cpu")
  flags = {f.name: torch.as_tensor(rng.random((n, 2)) < 0.5)
           for f in dataclasses.fields(reflex.ReflexState)}
  u = lambda lo, hi: torch.as_tensor(rng.uniform(lo, hi, (n, 2)),
                                     dtype=torch.float32)
  sens = {
      "theta": u(-0.4, 0.4), "d_pos": u(-1.0, 2.0), "dtheta": u(-2.0, 2.0),
      "load_ipsi": u(-0.1, 1.5), "alpha": u(0.8, 2.4),
      "dalpha": u(-3.0, 3.0), "alpha_f": u(1.2, 2.0),
      "phi_hip": u(2.0, 3.8), "phi_knee": u(1.6, 3.3),
      "phi_ankle": u(1.0, 2.2), "dphi_knee": u(-5.0, 5.0),
      "F_RF": u(-1.0, 0.2), "F_VAS": u(-1.0, 0.2), "F_GAS": u(-1.0, 0.2),
      "F_SOL": u(-1.0, 0.2)}
  sens["contact_ipsi"] = sens["load_ipsi"] > 0.1
  sens["contact_contra"] = sens["contact_ipsi"].flip(-1)
  sens["load_contra"] = sens["load_ipsi"].flip(-1)
  return cp, flags, sens


def phase_reflex_update() -> dict:
  """18a: ``reflex_update`` on the card (float32) against the port on the
  CPU (float64) on the same seeded float32 inputs."""
  from myosuite_mjx_tpu_torch.agents import reflex
  cp, flags, sens = _reflex_inputs(REFLEX_SAMPLES)
  out = {}
  for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float64)):
    st = reflex.ReflexState(**{k: v.to(device) for k, v in flags.items()})
    new, stim = reflex.reflex_update(
        cp.to(device, dtype), st,
        {k: v.to(device) if v.dtype == torch.bool else v.to(device, dtype)
         for k, v in sens.items()})
    out[dtype] = ({f: getattr(new, f).cpu() for f in flags},
                  stim.double().cpu())
  card, ref = out[torch.float32], out[torch.float64]
  same = sum(int((card[0][f] == ref[0][f]).all(-1).sum()) for f in flags)
  err = float((card[1] - ref[1]).abs().max())
  moved = sum(int((ref[0][f] != flags[f]).sum()) for f in flags)
  ok = same == len(flags) * REFLEX_SAMPLES and err <= REFLEX_STIM_BOUND
  _say(f"18a reflex_update B={REFLEX_SAMPLES}: card float32 vs cpu "
       f"float64: flag rows equal {same} of {len(flags) * REFLEX_SAMPLES} "
       f"({moved} flags moved), stim max abs err {err:.3e} (bound "
       f"{REFLEX_STIM_BOUND:g}) {'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("18a: reflex_update disagrees between card and CPU")
  return {"launches": 0}


def _reflex_params(n: int, seed: int) -> np.ndarray:
  """``n`` gain vectors around the nominal ones, as the tuner draws."""
  rng = np.random.default_rng(seed)
  return np.clip(1.0 + 0.15 * rng.standard_normal((n, 46)), -2.0, 4.0)


def _reflex_b4(device, dtype) -> dict:
  """REFLEX_CPU_WALKERS walkers, each its own gains, after
  REFLEX_CPU_TICKS control ticks: qpos, qvel and the pelvis heights."""
  from myosuite_mjx_tpu_torch.agents import reflex
  walker = reflex.ReflexWalker(dtype=dtype)
  d, traj = walker.rollout(REFLEX_CPU_TICKS,
                           _reflex_params(REFLEX_CPU_WALKERS, 1),
                           device=device)
  return {"qpos": d.qpos.double().cpu().numpy(),
          "qvel": d.qvel.double().cpu().numpy(),
          "height": traj["height"].double().cpu().numpy()}


def phase_reflex_walk(refs: dict | None = None) -> dict:
  """18b: ``ReflexWalker.rollout`` of REFLEX_WALKERS walkers on
  legs80_reflex, then REFLEX_CPU_WALKERS against the CPU; ``refs`` is
  ``cpu_references()`` (computed here without it)."""
  from myosuite_mjx_tpu_torch.agents import reflex
  walker = reflex.ReflexWalker()
  params = _reflex_params(REFLEX_WALKERS, 0)
  t0 = time.perf_counter()
  (d, traj), launches = _zeroed(
      functools.partial(walker.rollout, device=DEVICE), REFLEX_TICKS, params)
  seconds = time.perf_counter() - t0
  h, x = traj["height"].cpu().numpy(), traj["x"].cpu().numpy()
  steps = traj["footsteps"].cpu().numpy()
  rate = REFLEX_TICKS * walker.substeps * REFLEX_WALKERS / seconds
  _say(f"18b ReflexWalker legs80_reflex B={REFLEX_WALKERS}, {REFLEX_TICKS} "
       f"ticks x {walker.substeps} substeps (reset included): "
       f"{rate:,.1f} physics-steps/s, {seconds:.2f} s, SPD launches "
       f"{launches} ({launches / REFLEX_TICKS:.1f} a tick); pelvis height "
       f"median {float(np.median(h[0])):.4f} -> {float(np.median(h[-1])):.4f}"
       f" m (min {float(h.min()):.4f}), x median {float(np.median(x[-1])):.4f}"
       f" m, footsteps mean {float(steps.mean()):.2f} max {int(steps.max())}")
  if not (torch.isfinite(d.qpos).all() and np.isfinite(h).all()):
    raise AssertionError("18b: non-finite walker state")
  card = _reflex_b4(DEVICE, torch.float32)
  ref = refs["reflex"] if refs else _reflex_b4("cpu", torch.float64)
  for f, bound in (("qpos", CARD_CPU_BOUND["qpos"]),
                   ("qvel", CARD_CPU_BOUND["qvel"]),
                   ("height", CARD_CPU_BOUND["qpos"])):
    err = float(np.abs(card[f] - ref[f]).max())
    ok = err <= bound and np.isfinite(card[f]).all()
    _say(f"18b {REFLEX_CPU_WALKERS} walkers x {REFLEX_CPU_TICKS} ticks, "
         f"card float32 vs cpu float64, {f}: max abs err {err:.3e} (bound "
         f"{bound:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"18b: card and CPU walkers disagree on {f}")
  return {"reflex_physics_steps_per_s": rate, "launches": launches}


def phase_tune_reflex() -> dict:
  """18c: the CEM tuner, TUNE_ARGS, into a temporary directory."""
  from myosuite_mjx_tpu_torch.tools import tune_reflex
  with tempfile.TemporaryDirectory() as tmp:
    out_path = os.path.join(tmp, "gains.npz")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
      res, launches = _zeroed(tune_reflex.main, TUNE_ARGS + [
          "--out", out_path, "--device", DEVICE])
    seconds = time.perf_counter() - t0
    written = (os.path.exists(out_path)
               and os.path.exists(out_path.replace(".npz", "_history.json")))
  hist = res["history"]
  for rec in hist:
    _say(f"  tune_reflex: {json.dumps(rec)}")
  finite = all(np.isfinite([r["best"], r["elite_mean"], r["best_ever"]]).all()
               for r in hist)
  rising = all(b["best_ever"] >= a["best_ever"]
               for a, b in zip(hist, hist[1:]))
  ok = finite and rising and written and len(hist) == 2
  _say(f"18c tune_reflex {' '.join(TUNE_ARGS)}: {seconds:.1f} s, best "
       f"fitness {res['best']['fitness']:.4f} ({res['best']['t_alive']} "
       f"ticks alive); finite {finite}, best never falls {rising}, outputs "
       f"written {written} {'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("18c: the tuner's run is not as it must be")
  return {"launches": launches}


def phase_gym() -> dict:
  """18d: ``gym_make`` for one env and for B_MAIN envs on the card, and
  the CNN encoder, card float32 against CPU float64."""
  from myosuite_mjx_tpu_torch import envs
  from myosuite_mjx_tpu_torch.envs import gym_adapter, visual
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  rng = np.random.default_rng(0)
  torch.cuda.synchronize()
  cuda_linalg.spd_solve_cuda.launches = 0
  env = envs.gym_make(GYM_ENV, seed=0, device=DEVICE)
  spaces = gym_adapter.gym_spaces is not None
  obs, _ = env.reset(seed=0)
  nu = env.unwrapped_myo.action_dim
  rewards = []
  for _ in range(GYM_STEPS):
    obs, r, term, trunc, info = env.step(rng.uniform(0.0, 1.0, nu))
    rewards.append(r)
    if not (isinstance(term, bool) and isinstance(trunc, bool)):
      raise AssertionError("18d: GymEnv flags are not bools")
  if not (np.isfinite(obs).all() and np.isfinite(rewards).all()):
    raise AssertionError("18d: GymEnv gave non-finite output")
  venv = envs.gym_make(GYM_ENV, seed=0, num_envs=B_MAIN, device=DEVICE)
  vobs, _ = venv.reset()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(GYM_VEC_STEPS):
    vobs, vrew, done, trunc, _ = venv.step(
        rng.uniform(0.0, 1.0, (B_MAIN, nu)).astype(np.float32))
  seconds = time.perf_counter() - t0
  torch.cuda.synchronize()
  launches = cuda_linalg.spd_solve_cuda.launches
  frame_skip = env.unwrapped_myo.frame_skip
  rate = GYM_VEC_STEPS * frame_skip * B_MAIN / seconds
  if not (vobs.shape == (B_MAIN, obs.shape[0]) and np.isfinite(vobs).all()
          and np.isfinite(vrew).all() and done.dtype == bool):
    raise AssertionError("18d: GymVecEnv gave a wrong or non-finite output")
  _say(f"18d gym_make {GYM_ENV}: GymEnv {GYM_STEPS} steps, obs "
       f"{obs.shape}, rewards {np.round(rewards, 4).tolist()}; GymVecEnv "
       f"B={B_MAIN} {GYM_VEC_STEPS} steps (host numpy each step) "
       f"{rate:,.1f} physics-steps/s; gymnasium spaces {spaces}")
  frames = torch.as_tensor(rng.integers(0, 256, (CNN_FRAMES, 84, 84, 3),
                                        dtype=np.uint8))
  enc = visual.encoder("flax_cnn", 84, 84, device=DEVICE)
  with torch.no_grad():
    card = enc(frames.to(DEVICE)).double().cpu()
    ref = copy.deepcopy(enc).to("cpu", torch.float64)(frames)
  err = float((card - ref).abs().max() / ref.abs().max())
  ok = card.shape == (CNN_FRAMES, 64) and err <= CNN_BOUND
  _say(f"18d flax_cnn encoder {CNN_FRAMES} x 84 x 84: card float32 vs cpu "
       f"float64 {err:.3e} of the largest feature (bound {CNN_BOUND:g}) "
       f"{'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("18d: the CNN encoder disagrees between card and "
                         "CPU")
  return {"gym_vec_physics_steps_per_s": rate, "launches": launches}


@contextlib.contextmanager
def _mesh_run_settings():
  """The pose task's horizon cut to MESH_HORIZON in ``envs.make`` and PPO
  at MESH_PPO's settings (the CLI has no flags for them), and one
  process's NCCL group configuration in the environment; the group the
  first CLI run makes serves every run inside, and is destroyed at the
  end."""
  from myosuite_mjx_tpu_torch.train import ppo
  import torch.distributed as dist
  cfg = ppo.PPOConfig
  with socket.socket() as sk:
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
  env_vars = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
              "WORLD_SIZE": "1", "RANK": "0"}
  saved = {k: os.environ.get(k) for k in env_vars}
  ppo.PPOConfig = functools.partial(cfg, **MESH_PPO)
  os.environ.update(env_vars)
  try:
    with _env_horizon(MESH_HORIZON):
      yield
  finally:
    ppo.PPOConfig = cfg
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
    if dist.is_initialized():
      dist.destroy_process_group()


def phase_mesh() -> dict:
  """18e: the CLI's --mesh data (NPG, then PPO) at world size 1 on NCCL,
  each run's launches counted alone, and each state against the
  unsharded learner's one iteration (run after the count is read)."""
  from myosuite_mjx_tpu_torch import envs
  from myosuite_mjx_tpu_torch.tools.scaling_efficiency import flat_params
  from myosuite_mjx_tpu_torch.train import npg, ppo
  import torch.distributed as dist
  out = {"launches": 0}
  with _mesh_run_settings():
    for algo in ("npg", "ppo"):
      per_iter = MESH_ENVS * MESH_HORIZON
      res, launches = _zeroed(_cli, [
          "--env", GYM_ENV, "--algo", algo, "--num-envs", str(MESH_ENVS),
          "--total-steps", str(per_iter), "--mesh", "data", "--log-every",
          "1", "--device", DEVICE])
      out["launches"] += launches
      backend = dist.get_backend() if dist.is_initialized() else None
      world = dist.get_world_size() if dist.is_initialized() else 0
      env = envs.make(GYM_ENV)
      learner = (npg.NPG(env, npg.NPGConfig(num_envs=MESH_ENVS), DEVICE)
                 if algo == "npg" else
                 ppo.PPO(env, ppo.PPOConfig(num_envs=MESH_ENVS), DEVICE))
      g = torch.Generator(device=DEVICE).manual_seed(0)
      ts = learner.init(generator=g)
      before = flat_params(ts).clone()
      ts, _ = learner.train_step(ts, g)
      plain, sharded = flat_params(ts), flat_params(res["state"])
      change = float((plain - before).abs().max())
      err = float((sharded - plain).abs().max()) / max(change, 1e-30)
      rec = res["records"][-1] if res["records"] else {}
      expected = "nccl" if DEVICE == "cuda" else "gloo"
      ok = (backend == expected and world == 1 and len(res["records"]) == 1
            and rec.get("env_steps") == per_iter and change > 0
            and launches > 0 and err <= MESH_BOUND
            and all(np.isfinite(v) for v in rec.values()))
      _say(f"18e cli --mesh data --algo {algo}: {backend} world {world}, "
           f"{MESH_ENVS} envs x {MESH_HORIZON} steps, {res['seconds']:.1f} "
           f"s (init included), SPD launches {launches}; sharded vs "
           f"unsharded state: "
           f"{err:.3e} of the largest parameter change {change:.3e} (bound "
           f"{MESH_BOUND:g}) {'ok' if ok else 'FAIL'}")
      if not ok:
        raise AssertionError(f"18e: --mesh data {algo} did not launch the "
                             f"SPD kernel, or is not the unsharded step")
      out[f"mesh_{algo}_env_steps_per_s"] = per_iter / res["seconds"]
  return out


def phase_tools() -> dict:
  """18f: train_zoo_baseline into a temporary zoo, its snapshot loaded
  and acting on the card; then convergence_study on the hold scene."""
  from myosuite_mjx_tpu_torch.tools import convergence_study
  from myosuite_mjx_tpu_torch.tools import train_zoo_baseline
  from myosuite_mjx_tpu_torch.train import zoo
  log = io.StringIO()
  with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
      path, zoo_launches = _zeroed(train_zoo_baseline.main, ZOO_ARGS + [
          "--zoo-dir", tmp, "--device", DEVICE])
    seconds = time.perf_counter() - t0
    with open(path[:-4] + "_metrics.json") as f:
      history = json.load(f)["history"]
    policy = zoo.load_policy(path, device=DEVICE)
    act = policy(torch.zeros((16, policy.net.pi[0].in_features),
                             device=DEVICE))
  ok = (len(history) == 1 and act.shape == (16, 39) and zoo_launches > 0
        and bool(torch.isfinite(act).all()))
  _say(f"18f train_zoo_baseline {' '.join(ZOO_ARGS)}: {seconds:.1f} s, "
       f"SPD launches {zoo_launches}, "
       f"metrics {json.dumps(history[-1])}, the snapshot acts on the card "
       f"{'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("18f: the zoo tool's snapshot is not as it must be")
  log = io.StringIO()
  t0 = time.perf_counter()
  with contextlib.redirect_stdout(log):
    it, study_launches = _zeroed(convergence_study.main, CONVERGENCE_ARGS
                                 + ["--device", DEVICE])
  seconds = time.perf_counter() - t0
  for ln in log.getvalue().splitlines():
    _say(f"  convergence_study: {ln}")
  ok = it.shape == (5, 512) and 1 <= it.max() <= 100 and study_launches > 0
  _say(f"18f convergence_study {' '.join(CONVERGENCE_ARGS)}: {seconds:.1f} "
       f"s, SPD launches {study_launches} {'ok' if ok else 'FAIL'}")
  if not ok:
    raise AssertionError("18f: the convergence study's iterations are off, "
                         "or it never launched the SPD kernel")
  return {"launches": zoo_launches + study_launches}


def phase_rest_of_port(cpu_refs=None) -> dict:
  """Phase 18. Each part sets the register kernel's count to 0 just
  before each run of its path and reads it just after, and returns the
  sum as ``launches``; its comparisons run outside those windows (18a
  launches none: it is the controller alone). ``cpu_refs`` is a future of
  ``cpu_references()``."""
  refs = cpu_refs.result() if cpu_refs is not None else None
  parts, out = {}, {}
  for part, fn, args in (("a", phase_reflex_update, ()),
                         ("b", phase_reflex_walk, (refs,)),
                         ("c", phase_tune_reflex, ()), ("d", phase_gym, ()),
                         ("e", phase_mesh, ()), ("f", phase_tools, ())):
    t0 = time.perf_counter()
    rec = fn(*args)
    parts[part] = rec.pop("launches")
    out.update(rec)
    _say(f"phase 18{part}: {time.perf_counter() - t0:.1f} s, SPD launches "
         f"on its path {parts[part]}")
    if part != "a" and parts[part] <= 0:
      raise AssertionError(f"phase 18{part} never launched the SPD kernel")
  return {"launches": sum(parts.values()), "parts": parts, **out}


@contextlib.contextmanager
def _launch_shapes(shapes: set):
  """Record the (dtype, B, n) of every ``linalg.spd_solve`` call on the card
  made inside (the engine calls it through the module; the launch counts
  stay the kernel wrappers' own)."""
  from myosuite_mjx_tpu_torch.ops import linalg
  solve = linalg.spd_solve

  def recording(a, b, factor=False):
    if b.is_cuda:
      shapes.add((str(b.dtype)[6:], *b.shape))
    return solve(a, b, factor)

  linalg.spd_solve = recording
  try:
    yield
  finally:
    linalg.spd_solve = solve


def _timed_phase(number: int, fn, *args):
  t0 = time.perf_counter()
  out = fn(*args)
  _say(f"phase {number}: {time.perf_counter() - t0:.1f} s")
  return out


def main() -> int:
  t0 = time.perf_counter()
  smi = phase_device()
  instances = _timed_phase(2, phase_build)
  # phases 9's and 13-17's CPU references, in one worker while the card
  # works
  pool = concurrent.futures.ProcessPoolExecutor(
      1, mp_context=multiprocessing.get_context("spawn"))
  with pool:
    cond_refs = pool.submit(cpu_references_conditions)
    cpu_refs = pool.submit(cpu_references)
    return _main_phases(smi, instances, cond_refs, cpu_refs, t0)


def _checked_shapes() -> set:
  """Every (dtype, B, n) phase 3 held against the plain version."""
  return ({("float32", b, n) for b in BATCHES for n in SIZES}
          | {("float64", b, n) for b in GENERAL_BATCHES
             for n in GENERAL_F64_SIZES}
          | {("float32", b, n) for b in GENERAL_BATCHES
             for n in GENERAL_F32_SIZES})


def _main_phases(smi: str, instances: dict, cond_refs, cpu_refs,
                 t_start: float) -> int:
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  kernels = _timed_phase(3, phase_kernels)
  shapes: set = set()
  cuda_linalg.spd_solve_general_cuda.launches = 0
  with _launch_shapes(shapes):
    main_path = _timed_phase(4, phase_main_path)
    _timed_phase(5, phase_card_vs_cpu)
    train = _timed_phase(6, phase_train)
    _timed_phase(7, phase_policy)
    sac = _timed_phase(8, phase_sac)
    conditions = _timed_phase(9, phase_conditions,
                              main_path["physics_steps_per_s"], cond_refs)
    cli_run = _timed_phase(10, phase_cli)
    proof = _timed_phase(11, phase_prove_sac)
    physics = _timed_phase(12, phase_physics)
    contact = _timed_phase(13, phase_contact_tasks,
                           main_path["physics_steps_per_s"], cpu_refs)
    legs = _timed_phase(14, phase_legs, main_path["physics_steps_per_s"],
                        cpu_refs)
    hand_arm = _timed_phase(15, phase_hand_arm,
                            main_path["physics_steps_per_s"], cpu_refs)
    osl_track = _timed_phase(16, phase_osl_track,
                             main_path["physics_steps_per_s"], cpu_refs)
    general_4_16 = cuda_linalg.spd_solve_general_cuda.launches
    general_path = _timed_phase(17, phase_general_paths, cpu_refs)
    rest = _timed_phase(18, phase_rest_of_port, cpu_refs)
  unchecked = shapes - _checked_shapes()
  _say(f"spd_solve (dtype, B, n) launched in phases 4-18: {sorted(shapes)}; "
       f"not held against the plain version in phase 3: "
       f"{sorted(unchecked)}; general kernel launches in phases 4-16 "
       f"{general_4_16}")
  if not shapes or unchecked:
    raise AssertionError(f"no shape recorded, or shapes {sorted(unchecked)} "
                         f"never checked")
  _say(f"chip_smoke: phases 1-18 in {time.perf_counter() - t_start:.1f} s")
  _say(smi)
  general = kernels["spd_solve_general"]
  _say(json.dumps({"kernels": [{
      "name": "spd_solve", "route": "cuda",
      "source": "myosuite_mjx_tpu_torch/csrc/spd_solve.cu",
      "replaces": "myosuite_mjx_tpu/ops/pallas_linalg.py:77",
      "launches": main_path["launches"], **train, **sac, **conditions,
      **cli_run, **proof, "physics_launches": physics["physics_launches"],
      **contact, **legs, **hand_arm, **osl_track,
      "phase17_launches": general_path["register_launches"],
      **{f"phase18{k}_launches": v for k, v in rest["parts"].items()},
      **kernels["spd_solve"]}, {
      "name": "spd_solve_general", "route": "cuda",
      "source": "myosuite_mjx_tpu_torch/csrc/spd_solve_general.cu",
      "replaces": "myosuite_mjx_tpu/ops/linalg.py:19",
      "launches": general_path["launches"],
      **{f"phase17{k}_launches": v
         for k, v in general_path["parts"].items()},
      "phases4_16_launches": general_4_16, **general,
      "float32_register_vs_general": kernels["f32_compare"],
      "instances": instances}]}))
  _say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
