#!/usr/bin/env python3
"""Smoke run of the PyTorch port (isaacgymenvs_ma_tpu_torch) on one GPU.

    python3 chip_smoke.py [--kernels-only | --glue-only]

Phases, each printing its own lines; any failure exits non-zero
(``--kernels-only`` stops after phase 3, ``--glue-only`` runs phases 1 and
7 alone; neither prints the result line):
  1. device: torch/CUDA versions, the card's name and power limit
  2. build: nvcc builds kernels B1-B3 for the Ant, BallBalance,
     FrankaReachMA, Cartpole, FrankaCollectMA, FrankaPPMA,
     FrankaCombineMA, Humanoid, Anymal (AnymalTerrain's is the same),
     Ingenuity, Quadcopter, FrankaReach, FrankaCabinet, FrankaCubeStack
     (FrankaCubeStack2's is the same), Trifinger, AllegroKuka,
     AllegroKukaTwoArms, ShadowHand, AllegroHand, ShadowHandOpenAI_FF,
     AllegroHandLSTM and Dextreme (AllegroHand's header: built once)
     scenes and the Factory and IndustReal ones (Pick at 128, 512 and 1024
     envs and Place share one header), HumanoidAMP's (HumanoidAMPHands'
     is the same; AntSAC's and HumanoidSAC's are Ant's and Humanoid's),
     B4 for the
     Ant, BallBalance, FrankaReachMA, FrankaCollectMA and FrankaPPMA
     contact plans (the last two with their grab group), the Humanoid,
     Anymal and Ingenuity plans, the FrankaReach, FrankaCabinet (grab
     group), FrankaCubeStack (grab group), Trifinger, AllegroKuka and
     AllegroKukaTwoArms plans, HumanoidAMP's and a
     synthetic plan with grab rows, B5 for n = 6, 7, 14, 30 and 48,
     all compilers started together (a header shared by two plans is
     compiled once); each kernel's ptxas registers and spills
  3. kernels: each kernel against its plain PyTorch twin on the card, with
     kernel and twin times: B1-B3 at Ant-4096 shapes on a generic state and
     at BallBalance-4096, FrankaReachMA-8192 and Cartpole-512 shapes on
     warmed-up states; B4 on the inputs the main path hands it at Ant-4096
     (no frames), BallBalance-4096 (frames, attractors) and
     FrankaReachMA-8192 (41 rows with frames), and on the synthetic grab
     plan; B1-B3 at FrankaCollectMA-8192 and FrankaPPMA-8192 on warmed-up
     states and B4 on their routes' inputs (65 / 73 rows with frames and 4
     grab rows) with live grabs in a quarter of the envs (each agent's cube
     moved onto its grip site, its gripper action negative); B1-B3 at
     Humanoid-4096 (one 27-dof block of H), Anymal-4096, Ingenuity-4096
     and Quadcopter-4096 on warmed-up states, B4 on the route inputs of
     Humanoid (35 rows), AnymalTerrain (68 terrain rows, the bases 30-180 m
     from the world origin) and Ingenuity (8 rows, a quarter of the
     chassis landed); B1-B3 at FrankaReach-4096, FrankaCabinet-4096,
     FrankaCubeStack-8192 and Trifinger-16384 on warmed-up states
     (Trifinger's B2 with the mass and shape scales its randomizer drew, B3
     with the gravity wrench they scale), B4 on their routes' inputs (the
     cabinet's handle and cube A grabbed in a quarter of the envs;
     Trifinger's per-env friction and shape-scaled pair rows) and B5 at
     the OSC stacks of FrankaReach and FrankaCubeStack; B1-B3 at
     AllegroKuka-8192 and AllegroKukaTwoArms-8192 on warmed-up states (B2
     with the cuboid catalog's per-env shape scales, B3 with the gravity
     wrench they scale; TwoArms' B2 block of 201,248 B, one block an SM),
     B4 on their routes' inputs (34 / 44 rows, the cube's pair rows
     shape-scaled); B2 with per-env
     mass and shape scales and B3 with the gravity wrench they scale at
     Ant-4096 (seeded scales), Trifinger-16384 (its drawn scales) and the
     two AllegroKuka scenes (their cuboid sizes),
     with B2's time beside its time without scales; B1-B3 at
     ShadowHand-8192 (H blocks 24 + 6), AllegroHand-8192 (16 + 6),
     ShadowHandOpenAI_FF-16384, AllegroHandLSTM-16384 and
     AllegroHandDextremeADR-8192 on warmed-up states (the hands split
     masses, so B4 is not on their path), and B2 with Dextreme-ADR's own
     per-body mass scale from its ADR rows, B3 with the gravity wrench it
     scales (``[scaled_kernel]``); B1-B3 at FactoryTaskNutBoltPick-128
     and -1024, FactoryTaskNutBoltScrew-128, FactoryTaskGears-128 and
     IndustRealTaskPegsInsert-128 on warmed-up states (qdd and H^-1 held
     per env); B1-B3 at HumanoidAMP-4096 (31 bodies, one 34-dof block of
     H) on a state 30 steps in, every env reset once by Reference State
     Init, and B4 on its route's inputs (42 candidate rows); and B5 on
     Screw's two operational-space stacks ((128, 7, 7)
     arm mass matrices, (128, 6, 6) J M^-1 J^T + 1e-6 I); B5 on
     the two
     OSC inverses of a warmed-up FrankaReachMA-8192
     step ((16384, 7, 7) arm mass matrices, (16384, 6, 6) J M^-1 J^T) and
     on seeded SPD matrices at (16384, 7, 7), (4096, 14, 14), (1024, 30,
     30) and (256, 48, 48), with torch.linalg.inv's time beside it; for
     the team kernels B1-B4, per scene, and for B5 per shape, the device
     time per launch by CUPTI beside the bound (B3: also with only H^-1's
     block entries read), the one-thread kernels' recorded time (B1-B4),
     ptxas's registers and spills, and the launch layout (team, envs or
     matrices per block, shared memory, blocks an SM by shared memory);
     the plain twins timed over 3 calls after a warm-up one
  4. golden: the committed JAX captures replayed through the kernels: Ant
     and BallBalance, each on the default loop and on B4; FrankaReachMA on
     the default loop (compaction and row reuse) and, from its own
     capture, on B4 (all 41 candidate rows, no compaction or reuse);
     Cartpole's 101-step rollout (the contact-free path); FrankaCollectMA
     on the default loop and (128 envs) on B4, FrankaPPMA on the default
     loop, each with live grabs in half of the envs; Humanoid, Anymal,
     AnymalTerrain (one step at a time against the reference's own
     one-ulp spread, with a push) and Ingenuity on both routes, Quadcopter
     on the loop; FrankaReach and FrankaCabinet on both routes and
     FrankaCabinet's kernel-route capture (128 envs) on B4, FrankaCubeStack
     and FrankaCubeStack2 on the loop (beyond four times the reference's
     own trajectory spread), Trifinger with its recorded randomization on
     the loop and its kernel-route capture (128 envs) on B4, AllegroKuka
     and AllegroKukaTwoArms Reorientation on the loop and AllegroKuka's
     kernel-route capture (128 envs) on B4, each one step at a time
     against the reference's own one-ulp spread, their object-force draws
     injected
     (the JAX engine has no kernel route at TwoArms); ShadowHand,
     AllegroHand, ShadowHandOpenAI_FF and AllegroHandLSTM on the
     mass-splitting loop, one step at a time, their reset, force and goal
     draws injected; AllegroHandDextremeManualDR and AllegroHandDextremeADR
     (the ADR one from widened ranges: restitution and limit shifts in the
     engine) so, with every draw of their hooks injected and the RNA's
     recorded weights; the five Factory and two IndustReal captures (8
     envs, a 23-step episode: Pick's close-and-lift epilogue in the third
     recorded step) on the loop, one step at a time against the
     reference's own one-ulp spread; HumanoidAMP (8 envs, 3 steps from
     Reference State Init resets) on both routes and HumanoidAMPHands on
     the loop, at the ground rule
  restitution: one engine step of AllegroHand-8192 (plane restitution
     0.5, every cube thrown at the palm) with restitution 0.5 on every body
     and seeded limit shifts on the card and on the CPU twins, held at the
     ground-rule bounds widened per env by the CPU step's one-ulp spread;
     the share of active rows whose bounce target binds; the route
     ``engine.route_for`` gives the hand's call and an Ant-4096 call with
     the contact kernel requested and restitution (the loop) and without
     it (B4)
  factory_engine: one engine step of FactoryTaskNutBoltPick-128 (warm
     start, body damping, bf16 solver rows, the nut's and bolt's SDF grids,
     mass splitting) on the card and on the CPU twins from the same state,
     held at the ground-rule bounds widened per env by the CPU step's
     one-ulp spread; the share of active rows warm start seeds, the mean
     |lambda| carried in, the mean |damping wrench|, the bf16 rule's rows x
     nv and the route
  5. main path, each phase with the launch counts set to 0 just before it:
     Ant-4096 and BallBalance-4096 on the default contact loop and on B4,
     FrankaReachMA at 8192 envs x 2 arms on the default loop and on B4,
     Cartpole-512 (B1-B3 only: no contact rows, no OSC), FrankaCollectMA
     and FrankaPPMA at 8192 x 2 on both routes and FrankaCombineMA at
     8192 x 2 on the default loop, Humanoid-4096, Anymal-4096,
     AnymalTerrain-4096 (B2 on each of its 4 substeps; B3 forbidden) and
     Ingenuity-4096 on both routes and Quadcopter-4096 on the loop (B4
     forbidden: no contact rows), FrankaReach-4096, FrankaCabinet-4096 (no
     OSC: B5 forbidden), FrankaCubeStack-8192 and Trifinger-16384 (its
     shipped randomization on) on both routes and FrankaCubeStack2-8192 on
     the loop, AllegroKuka-8192 and AllegroKukaTwoArms-8192 (cuboid sizes
     per env, random object forces; B5 forbidden) on both routes,
     ShadowHand-8192, AllegroHand-8192, ShadowHandOpenAI_FF-16384 and
     AllegroHandLSTM-16384, AllegroHandDextremeManualDR-8192 and
     AllegroHandDextremeADR-8192 with the contact kernel requested (mass
     splitting, and ADR's restitution, take the batched loop, the JAX
     route rule: B4 and B5 forbidden; after each a ``[mass_split]`` line,
     the share of active rows scaled below 1 and the smallest scale, and
     at the Allegro scenes a ``[dof_friction]`` line, the mean |friction
     torque|; after Dextreme's an ``[rna]`` line, the share of envs the
     RNA blends a step, and ADR's ``[adr]`` line: npd, queued boundary
     episodes, the mean |limit shift| and restitution reaching the engine),
     10 steps each after 3 untimed ones (50 and 10 until the data-parallel
     learners joined, 100 until the Factory phases did), tanh(obs @ W)
     actions;
     each ``[main]`` line names the contact route the engine took;
     env-steps/s (and agent-steps/s), stream ms per step by CUDA events
     (the kernels and the device's idle gaps between them), launches per
     kernel, the host waits of one more step (CUDA sync debug mode) by
     file and line, and for the tasks with grabs the share of agent rows
     with a grab live; after Trifinger's, its randomization measured on
     the path: the spread of the drawn scales, the share of envs whose
     friction changed at a reset (every flagged env, no other) and the
     noise std added to actions and observations against the config's;
     then ``[shim]``: ``ComplexObsRLGPUEnv`` over Dextreme-ADR-8192, each
     group's shape and ``reset_done``'s count; then the Factory family
     (Pick, Place, Screw, Gears, Insertion) and IndustReal (PegsInsert,
     GearsInsert) at their published 128 envs and Pick at 1024, 10 steps
     each and Pick 100 (its episode's length), the contact kernel
     requested (warm start and mass splitting take the loop: B4
     forbidden, B5 only and twice a step at Screw),
     each followed by a ``[factory]`` line: the host reads of the two
     data-dependent branches a step and, at Pick, the close-and-lift
     epilogues run in the phase and the last one's lift success share;
     then HumanoidAMP-4096 on the default loop and on B4 and
     HumanoidAMPHands-4096 on the loop (10 steps each), after the first a
     Reference State Init check (every other env flagged: each leaves the
     step at its motion draw's state bit for bit)
  6. train, each run with the launch counts set to 0 just before it: PPO
     (``learning/ppo.py``) on Ant-4096 with the Ant train config (1
     warm-up epoch, 3 timed) and on FrankaReachMA at 8192 envs x 2 arms
     with its config (1 warm-up, 1 timed; B5 exactly twice a step), and
     the same on FrankaCollectMA at 8192 x 2 (its FSM occupancy extras
     printed), Humanoid-4096, AnymalTerrain-4096 and FrankaCubeStack-8192
     with their configs (1 warm-up, 1 timed), AllegroKuka-8192 with the
     AllegroKukaLSTM config (the recurrent path: LSTM 768, seq_len 16) and
     Trifinger-16384 with its config (the central-value critic on 113
     privileged states) and ShadowHandOpenAI_FF-16384 with its config
     (the central-value critic on 211 privileged states, 3 engine steps
     a step) and AllegroHandDextremeADR-8192 with its config (the central
     value on 112 true states; ``adr_npd`` printed),
     FactoryTaskNutBoltPick-512 with its config (an epilogue an episode)
     and IndustRealTaskPegsInsert-128 with its config (one epoch each, no
     warm-up), the AMP learner on
     HumanoidAMP-4096 with its config (an ``[amp]`` line: the main phase's
     RSI reset share, the discriminator's reward, accuracies and losses,
     the replay fill), PPO on the HRL wrapper over HumanoidAMP-4096 (a
     fresh LLC, latent 64, units [1024, 512], 5 inner steps an outer step;
     the HumanoidAMP config as a2c_continuous; an ``[hrl]`` line), 1
     warm-up and 1 timed each, and SAC on AntSAC-4096 and HumanoidSAC-4096
     with their configs (1 warm-up epoch holding the 5 seed steps, 1 timed
     epoch of updates; a ``[sac]`` line: alpha, the replay fill, the
     losses), each epoch's seconds,
     rollout and update ms (CUDA events),
     training frames/s and losses; then Cartpole-512 through the ``train``
     entry point until its mean return passes 100, failing if it has not
     by epoch 100 (the config's max_epochs)
  7. glue (data parallelism, the entry point's flags, profiling, PBT,
     terrain normal frames): ``[dist]`` Ant-4096 (global) through the
     train entry point under ``python -m torch.distributed.run
     --standalone --nproc_per_node=2`` (both ranks on cuda:0 over gloo:
     NCCL refuses two ranks on one device), 1 warm-up and 1 timed epoch,
     each rank's epoch seconds, B1-B3 launches, gradient all-reduce ms an
     update (CUDA events) and bytes, and parameter + Adam digest (failing
     unless the digests agree, the losses are finite and each rank
     launched B1-B3); then one rank on NCCL (world 1) for one epoch in
     this process; then
     the 2-rank checkpoint resumed in this process, parameters, Adam state
     and the full env state bit-equal to what was saved; ``[dist_sac]``
     and ``[dist_amp]`` AntSAC-4096 and HumanoidAMP-4096 (global) the same
     way with their configs (SAC's replay ring and AMP's discriminator
     batch assembled from both ranks' rows), 1 warm-up epoch (AntSAC's
     holds the 5 seed steps) and 1 timed, each rank's epoch seconds,
     B1-B3 launches, gradient all-reduce ms an update and combine ms
     (CUDA events), replay fill, losses and digest (failing unless the
     digests agree, the losses are finite and each rank launched B1-B3),
     then the 2-rank SAC checkpoint resumed in this process, bit-equal
     with its ring;
     ``[dryrun]`` ``dryrun_multiproc(2)`` on cuda:0 over gloo (Ant,
     FrankaReachMA, the asymmetric ShadowHand; a worker process started
     after phase 3, beside phases 4-4b, which time nothing on the card);
     ``[summaries]`` the
     ``[dist]`` run's event file read back with every CRC checked, its tags
     and steps, and its ``config.yaml``; ``[normal_frames]``
     AnymalTerrain-4096 with ``terrain_normal_frames`` and the contact
     kernel requested, 50 steps on the loop (B2 on each substep, B3 and
     B4 forbidden), then one engine step from a state 30 steps in on the
     card and, for its first 512 envs, on the CPU twins, held at the
     ground-rule bounds widened per env by four times the CPU step's own
     one-ulp spread (eight nudged runs), and the share of terrain rows
     whose normal tilts more than 10 degrees; ``[video]`` Ant-4096 with
     ``capture_video`` through the entry point (PNG frames, consecutive
     frames differ); ``[trace]`` ``profiling.trace`` around 3 Ant-4096
     steps in a fresh process (started with the ``[dryrun]`` worker), the
     exported trace holding each ``annotate`` name and the B1-B3 kernels;
     ``[pbt]`` one
     ``PbtAlgoObserver`` cycle of three Cartpole-512 members on the card
     (checkpoints and metas written, the replacement decision equal to a
     CPU observer's on the same workspace, ``restore_fn`` leaving the
     donor's parameters bit-equal)
Each phase prints its seconds (``[phase_seconds]``) and its ``@timed``
helpers' (``[helper_seconds]``).  The line before the
last is the kernels JSON (a row per kernel at the scene where it runs
first, launches summed over every phase, then a row per kernel at
FrankaCollectMA, FrankaPPMA, Humanoid, Anymal, Ingenuity, Quadcopter,
FrankaReach, FrankaCabinet, FrankaCubeStack, Trifinger, AllegroKuka,
AllegroKukaTwoArms, ShadowHand, AllegroHand, ShadowHandOpenAI_FF,
AllegroHandLSTM, AllegroHandDextremeADR, the Factory scenes of phase 3
(Pick-128, Pick-1024, Screw with B5, Gears, PegsInsert),
AllegroHandDextremeManualDR (ADR's), FrankaCubeStack2 (FrankaCubeStack's),
HumanoidAMP, HumanoidAMPHands (HumanoidAMP's), AnymalTerrain
(Anymal's) and AnymalTerrain with normal frames (Anymal's), launches
summed over that task's main phases), the last line {"ok": true,
"device": {...}}.  Needs a CUDA
device; never falls back to the CPU and never imports jax.
"""
import atexit
import collections
import functools
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 4096
# phase 5's depth: steps of each main phase after MAIN_WARMUP untimed ones;
# the Factory family and IndustReal run FACTORY_STEPS, Pick PICK_STEPS, so
# that its 100-step episode ends inside the phase (the close-and-lift
# epilogue)
MAIN_WARMUP, MAIN_STEPS, FACTORY_STEPS, PICK_STEPS = 3, 10, 10, 100
PHASES = (  # tag, task, use_contact_kernel, steps, envs
    ("ant", "Ant", False, MAIN_STEPS, N_ENVS),
    ("ant_b4", "Ant", True, MAIN_STEPS, N_ENVS),
    ("ball_balance", "BallBalance", False, MAIN_STEPS, N_ENVS),
    ("ball_balance_b4", "BallBalance", True, MAIN_STEPS, N_ENVS),
    ("franka_reach_ma", "FrankaReachMA", False, MAIN_STEPS, 8192),
    ("franka_reach_ma_b4", "FrankaReachMA", True, MAIN_STEPS, 8192),
    ("cartpole", "Cartpole", False, MAIN_STEPS, 512),
    ("franka_collect_ma", "FrankaCollectMA", False, MAIN_STEPS, 8192),
    ("franka_collect_ma_b4", "FrankaCollectMA", True, MAIN_STEPS, 8192),
    ("franka_ppma", "FrankaPPMA", False, MAIN_STEPS, 8192),
    ("franka_ppma_b4", "FrankaPPMA", True, MAIN_STEPS, 8192),
    ("franka_combine_ma", "FrankaCombineMA", False, MAIN_STEPS, 8192),
    ("humanoid", "Humanoid", False, MAIN_STEPS, N_ENVS),
    ("humanoid_b4", "Humanoid", True, MAIN_STEPS, N_ENVS),
    ("anymal", "Anymal", False, MAIN_STEPS, N_ENVS),
    ("anymal_b4", "Anymal", True, MAIN_STEPS, N_ENVS),
    ("anymal_terrain", "AnymalTerrain", False, MAIN_STEPS, N_ENVS),
    ("anymal_terrain_b4", "AnymalTerrain", True, MAIN_STEPS, N_ENVS),
    ("ingenuity", "Ingenuity", False, MAIN_STEPS, N_ENVS),
    ("ingenuity_b4", "Ingenuity", True, MAIN_STEPS, N_ENVS),
    ("quadcopter", "Quadcopter", False, MAIN_STEPS, N_ENVS),
    ("franka_reach", "FrankaReach", False, MAIN_STEPS, N_ENVS),
    ("franka_reach_b4", "FrankaReach", True, MAIN_STEPS, N_ENVS),
    ("franka_cabinet", "FrankaCabinet", False, MAIN_STEPS, N_ENVS),
    ("franka_cabinet_b4", "FrankaCabinet", True, MAIN_STEPS, N_ENVS),
    ("franka_cube_stack", "FrankaCubeStack", False, MAIN_STEPS, 8192),
    ("franka_cube_stack_b4", "FrankaCubeStack", True, MAIN_STEPS, 8192),
    ("franka_cube_stack2", "FrankaCubeStack2", False, MAIN_STEPS, 8192),
    ("trifinger", "Trifinger", False, MAIN_STEPS, 16384),
    ("trifinger_b4", "Trifinger", True, MAIN_STEPS, 16384),
    ("allegro_kuka", "AllegroKuka", False, MAIN_STEPS, 8192),
    ("allegro_kuka_b4", "AllegroKuka", True, MAIN_STEPS, 8192),
    ("allegro_kuka_two_arms", "AllegroKukaTwoArms", False, MAIN_STEPS, 8192),
    ("allegro_kuka_two_arms_b4", "AllegroKukaTwoArms", True, MAIN_STEPS, 8192),
    # the hands split masses: the contact kernel requested, the engine
    # takes its batched loop (the JAX route rule)
    ("shadow_hand", "ShadowHand", True, MAIN_STEPS, 8192),
    ("allegro_hand", "AllegroHand", True, MAIN_STEPS, 8192),
    ("shadow_hand_openai_ff", "ShadowHandOpenAI_FF", True, MAIN_STEPS,
     16384),
    ("allegro_hand_lstm", "AllegroHandLSTM", True, MAIN_STEPS, 16384),
    # Dextreme: AllegroHand's scene; ADR's rows bring restitution and limit
    # shifts to the engine, which keep it on the loop too
    ("allegro_hand_dextreme_manual_dr", "AllegroHandDextremeManualDR", True,
     MAIN_STEPS, 8192),
    ("allegro_hand_dextreme_adr", "AllegroHandDextremeADR", True, MAIN_STEPS,
     8192),
    # the Factory family and IndustReal at their published 128 envs (Pick
    # also at 1024), the contact kernel requested: warm start and mass
    # splitting take the batched loop (the JAX route rule), B5 only at
    # Screw (its operational-space controller), B4 never
    ("factory_pick", "FactoryTaskNutBoltPick", True, PICK_STEPS, 128),
    ("factory_pick_1024", "FactoryTaskNutBoltPick", True, PICK_STEPS,
     1024),
    ("factory_place", "FactoryTaskNutBoltPlace", True, FACTORY_STEPS,
     128),
    ("factory_screw", "FactoryTaskNutBoltScrew", True, FACTORY_STEPS,
     128),
    ("factory_gears", "FactoryTaskGears", True, FACTORY_STEPS, 128),
    ("factory_insertion", "FactoryTaskInsertion", True, FACTORY_STEPS,
     128),
    ("industreal_pegs_insert", "IndustRealTaskPegsInsert", True,
     FACTORY_STEPS, 128),
    ("industreal_gears_insert", "IndustRealTaskGearsInsert", True,
     FACTORY_STEPS, 128),
    # HumanoidAMP (Reference State Init from its motion clips) on the
    # default loop and on B4, and HumanoidAMPHands (the cartwheel clip) on
    # the loop
    ("humanoid_amp", "HumanoidAMP", False, MAIN_STEPS, N_ENVS),
    ("humanoid_amp_b4", "HumanoidAMP", True, MAIN_STEPS, N_ENVS),
    ("humanoid_amp_hands", "HumanoidAMPHands", False, MAIN_STEPS, N_ENVS),
)
# tasks built for phase 6 only: tag, task, envs (Pick at the width of the
# repo's solved run, BASELINE.md:90)
TRAIN_ONLY = (("factory_pick_512", "FactoryTaskNutBoltPick", 512),)
# the SAC registry names (Ant and Humanoid as they are), built for phase 6
# on the default loop: tag, task, envs
SAC_TASKS = (("ant_sac", "AntSAC", N_ENVS), ("humanoid_sac", "HumanoidSAC",
                                              N_ENVS))
# the tasks that split masses: their contact solve never runs B4
MASS_SPLIT = ("ShadowHand", "AllegroHand", "ShadowHandOpenAI_FF",
              "AllegroHandLSTM", "AllegroHandDextremeManualDR",
              "AllegroHandDextremeADR")
DEXTREME = ("AllegroHandDextremeManualDR", "AllegroHandDextremeADR")
# the Factory and IndustReal tasks: warm start and mass splitting keep
# their contact solve on the loop
FACTORY = ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace",
           "FactoryTaskNutBoltScrew", "FactoryTaskGears",
           "FactoryTaskInsertion", "IndustRealTaskPegsInsert",
           "IndustRealTaskGearsInsert")
# the Factory scenes whose B1-B3 phase 3 holds on a warmed-up state at
# each main phase's width (Place runs Pick's scene); Screw's B5 also at its
# operational-space stacks
FACTORY_SCENES = ("factory_pick", "factory_pick_1024", "factory_screw",
                  "factory_gears", "industreal_pegs_insert")
# the hand scenes: B1-B3 on a warmed-up state at each main phase's width
# (ManualDR runs the ADR scene's kernels)
HAND_SCENES = ("shadow_hand", "allegro_hand", "shadow_hand_openai_ff",
               "allegro_hand_lstm", "allegro_hand_dextreme_adr")
# the Franka tasks with OSC (kernel B5 twice every step); FrankaCabinet
# drives its arm with joint torques
OSC_TASKS = ("FrankaReachMA", "FrankaCollectMA", "FrankaPPMA",
             "FrankaCombineMA", "FrankaReach", "FrankaCubeStack",
             "FrankaCubeStack2", "FactoryTaskNutBoltScrew")
# the MA scenes with grab constraints whose kernels phase 3 checks: B1-B3
# on a warmed-up state, B4 on its route's inputs with live grabs
GRAB_SCENES = ("franka_collect_ma", "franka_ppma")
DYN = ("fk_motion", "dyn_forward", "dyn_cached")
# the legged and aerial scenes: B1-B3 on a warmed-up state (AnymalTerrain
# shares Anymal's scene), B4 on each contact plan's route inputs, Anymal's
# on the terrain rows of an AnymalTerrain step (Quadcopter has no contact
# rows)
LOCO_SCENES = ("humanoid", "anymal", "ingenuity", "quadcopter",
               "humanoid_amp")
LOCO_B4 = {"humanoid": "humanoid_b4", "anymal": "anymal_terrain_b4",
           "ingenuity": "ingenuity_b4", "humanoid_amp": "humanoid_amp_b4"}
# the single-arm Franka scenes, Trifinger's and the AllegroKuka scenes:
# B1-B3 on a warmed-up state (Trifinger's B2 with its drawn mass and shape
# scales, AllegroKuka's with its cuboid sizes, B3 with the scaled gravity
# wrench), B4 on each route's inputs (the cabinet's handle grab and cube
# A's grab live in a quarter of the envs, Trifinger's and AllegroKuka's
# shape-scaled pair rows, Trifinger's per-env friction), B5 at the OSC
# stacks; FrankaCubeStack2 runs FrankaCubeStack's scene and kernels
SINGLE_SCENES = ("franka_reach", "franka_cabinet", "franka_cube_stack",
                 "trifinger", "allegro_kuka", "allegro_kuka_two_arms")
# the scenes whose B2 and B3 are also timed with and without their
# physics scales (``[scaled_kernel]``): their drawn or catalog scales;
# Dextreme-ADR's per-body mass scale from its ADR rows (no shape scale)
SCALED_SCENES = ("trifinger", "allegro_kuka", "allegro_kuka_two_arms",
                 "allegro_hand_dextreme_adr")
# kernels a task's main phases must not launch: AnymalTerrain does not
# reuse the mass matrix (B2 on every substep, never B3)
NEVER = {"AnymalTerrain": ("dyn_cached",)}
# phase 6: tag, task (a main phase's), train config, warm-up epochs,
# timed epochs
TRAIN_RUNS = (("train_ant", "ant", "Ant", 1, 3),
              ("train_franka_reach_ma", "franka_reach_ma", "FrankaReachMA",
               1, 1),
              ("train_franka_collect_ma", "franka_collect_ma",
               "FrankaCollectMA", 1, 1),
              ("train_humanoid", "humanoid", "Humanoid", 1, 1),
              ("train_anymal_terrain", "anymal_terrain", "AnymalTerrain",
               1, 1),
              ("train_franka_cube_stack", "franka_cube_stack",
               "FrankaCubeStack", 1, 1),
              # the recurrent path (LSTM, truncated BPTT) and the
              # asymmetric one (central-value critic)
              ("train_allegro_kuka_lstm", "allegro_kuka", "AllegroKukaLSTM",
               1, 1),
              ("train_trifinger", "trifinger", "Trifinger", 1, 1),
              ("train_shadow_hand_openai_ff", "shadow_hand_openai_ff",
               "ShadowHandOpenAI_FF", 1, 1),
              # the central-value critic on 112 true states, ADR adapting
              ("train_allegro_hand_dextreme_adr", "allegro_hand_dextreme_adr",
               "AllegroHandDextremeADR", 1, 1),
              # Factory Pick at 512 envs (its close-and-lift epilogue on
              # an episode's last step) and IndustReal's pegs at 128, one
              # epoch each without a warm-up (an epoch takes 20-26 s)
              ("train_factory_pick", "factory_pick_512",
               "FactoryTaskNutBoltPick", 0, 1),
              ("train_industreal_pegs_insert", "industreal_pegs_insert",
               "IndustRealTaskPegsInsert", 0, 1))
# phase 6's other learners, each 1 warm-up and 1 timed epoch: the AMP
# learner on HumanoidAMP with its config; SAC on AntSAC and HumanoidSAC
# with theirs (8 env steps an epoch, the 5 seed steps in the warm-up
# one); PPO on the HRL wrapper over HumanoidAMP with a fresh LLC
# (HRL_LLC: latent 64, units [1024, 512], the JAX defaults) and
# HRL_LLC_STEPS inner steps an outer step, trained with the HumanoidAMP
# config as an a2c_continuous one (HRL_CONFIG)
AMP_RUN = ("train_humanoid_amp", "humanoid_amp", "HumanoidAMP")
SAC_RUNS = (("train_ant_sac", "ant_sac", "AntSAC"),
            ("train_humanoid_sac", "humanoid_sac", "HumanoidSAC"))
HRL_RUN = ("train_hrl", "humanoid_amp")
HRL_LLC = {"latent_dim": 64, "units": [1024, 512]}
HRL_LLC_STEPS = 5
HRL_CONFIG = "HumanoidAMP"
# shared memory of one H100 SM (228 KB) and the 1 KB the runtime reserves
# a block: a block's layout fits SM_SMEM // (smem + 1024) blocks an SM
SM_SMEM, BLOCK_RESERVED = 233472, 1024
# learn_cartpole: the bar of tests/test_ppo_cartpole.py within the Cartpole
# config's max_epochs
LEARN_BAR, LEARN_EPOCHS = 100.0, 100
# kernel name -> scene of its kernels-JSON row (where it runs first)
JSON_SCENE = {"fk_motion": "ant", "dyn_forward": "ant", "dyn_cached": "ant",
              "contact_solve": "ant", "spd_inverse": "franka_reach_ma"}
KERNELS = {  # kernel name -> (CUDA source, TPU kernel replaced)
    "fk_motion": ("isaacgymenvs_ma_tpu_torch/physics/csrc/fk_motion.cu",
                  "isaacgymenvs_ma_tpu/physics/dyn_kernel.py:657"),
    "dyn_forward": ("isaacgymenvs_ma_tpu_torch/physics/csrc/dyn_forward.cu",
                    "isaacgymenvs_ma_tpu/physics/dyn_kernel.py:404"),
    "dyn_cached": ("isaacgymenvs_ma_tpu_torch/physics/csrc/dyn_cached.cu",
                   "isaacgymenvs_ma_tpu/physics/dyn_kernel.py:475"),
    "contact_solve": (
        "isaacgymenvs_ma_tpu_torch/physics/csrc/contact_solve.cu",
        "isaacgymenvs_ma_tpu/physics/contact_kernel.py:221"),
    "spd_inverse": ("isaacgymenvs_ma_tpu_torch/physics/csrc/spd_inverse.cu",
                    "isaacgymenvs_ma_tpu/physics/engine.py:241"),
}
# H100 SXM published peaks: HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# The team kernels B1-B4: device us per launch of their one-thread
# predecessors, by CUPTI inside the step (PERF.md §6; one H100 80GB HBM3,
# 700 W); None: no one-thread time on that plan
RECORDED_US = {("ant", "fk_motion"): 5.02,
               ("ball_balance", "fk_motion"): 4.26,
               ("franka_reach_ma", "fk_motion"): 16.22,
               ("ant", "dyn_forward"): 48.51,
               ("ball_balance", "dyn_forward"): 72.08,
               ("franka_reach_ma", "dyn_forward"): 1069.51,
               ("ant", "dyn_cached"): 11.74,
               ("ball_balance", "dyn_cached"): 12.66,
               ("franka_reach_ma", "dyn_cached"): 190.53,
               ("ant", "contact_solve"): 269.60,
               ("ball_balance", "contact_solve"): 634.54,
               ("franka_reach_ma", "contact_solve"): None,
               ("grab", "contact_solve"): None,
               **{(scene, name): None
                  for scene in ("franka_collect_ma", "franka_ppma")
                  for name in ("fk_motion", "dyn_forward", "dyn_cached",
                               "contact_solve")},
               ("cartpole", "fk_motion"): None,
               ("cartpole", "dyn_forward"): None,
               ("cartpole", "dyn_cached"): None,
               **{(scene, name): None
                  for scene in LOCO_SCENES + SINGLE_SCENES + HAND_SCENES
                  + FACTORY_SCENES + ("factory_pick_512",)
                  for name in ("fk_motion", "dyn_forward", "dyn_cached",
                               "contact_solve")}}
# B5's seeded stacks, (B, n, seed): the OSC sizes, the JAX kernel's own
# measured size (engine.py:249-250) and two rows a lane
SPD_SEEDED = ((16384, 7, 21), (4096, 14, 22), (1024, 30, 23), (256, 48, 24))


def phase(tag, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


# seconds spent in the helpers marked @timed since the last phase lap,
# each including the helpers it calls
HELPER_SECONDS = collections.Counter()


def timed(fn):
    @functools.wraps(fn)
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            HELPER_SECONDS[fn.__name__] += time.perf_counter() - t0
    return wrapper


class PhaseClock:
    """Prints each phase's seconds (``[phase_seconds]`` lines) and the
    seconds its @timed helpers took (``[helper_seconds]``)."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def lap(self, name):
        now = time.perf_counter()
        phase("phase_seconds", phase=name, seconds=f"{now - self.t:.2f}",
              total=f"{now - self.t0:.2f}")
        if HELPER_SECONDS:
            phase("helper_seconds", phase=name,
                  **{k: f"{v:.2f}" for k, v in
                     sorted(HELPER_SECONDS.items(), key=lambda x: -x[1])})
        HELPER_SECONDS.clear()
        self.t = now


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


@timed
def gpu_ms(torch, fn, batches=5, per_batch=20, warmup=3):
    """Median over batches of the mean device time of ``per_batch`` calls,
    by CUDA events (after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


@timed
def twin_ms(torch, fn):
    """``gpu_ms`` of a plain twin, over fewer calls: a twin takes 2-190 ms
    a call (hundreds of small launches), so one batch of 3 calls after one
    warm-up call.  3 x 5 and 5 x 20 calls gave Ant's and ShadowHand's B1-B3
    twins within 1-37 % of each other (PERF.md §6), well inside the
    kernels' 100-1000x lead."""
    return gpu_ms(torch, fn, batches=1, per_batch=3, warmup=1)


@timed
def device_us(torch, fn, kernel, calls=20):
    """Mean device time (us) per launch of the CUDA kernel whose name holds
    ``kernel``, by CUPTI (torch.profiler) over the launches it records of
    ``calls`` calls of ``fn`` after a warm-up (it may miss the first; a
    window in which it saw none is taken again): the kernel alone, without
    the host's share.  Where CUPTI records no launch in three windows (it
    can stop recording for the rest of a process), the time per call by
    CUDA events stands in for it, and a ``[timer]`` line says so."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):     # the profiler now and then records no launch
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e.device_time_total for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name]
        if calls // 2 <= len(hits) <= calls:
            return sum(hits) / len(hits)
    us = gpu_ms(torch, fn, per_batch=calls) * 1e3
    phase("timer", kernel=kernel, cupti_launches=len(hits), calls=calls,
          source="cuda_events", device_us=f"{us:.2f}")
    return us


def ptxas_report(log, kernel):
    """Registers, stack frame, spill store / load bytes and static shared
    memory of the entry function whose name holds ``kernel``, from the
    ``-Xptxas -v`` report of its build."""
    rep, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?([^' ]+)",
                      line)
        if m:
            current = m.group(1)
            continue
        if current is None or kernel not in current:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_st", r"(\d+) bytes spill stores"),
                         ("spill_ld", r"(\d+) bytes spill loads"),
                         ("regs", r"Used (\d+) registers"),
                         ("static_smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                rep[key] = int(m.group(1))
    return rep


def nbytes(*tensors):
    """Bytes of the given tensors (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes_, flops):
    """Least time (ms) of the work on an H100, and what bounds it."""
    t_b, t_f = nbytes_ / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# FLOPs per env of the function each kernel computes, counted from the
# plain twins and rounded up (a multiply-add is 2; sin and cos 20 each)
def flops_fk(plan):
    return 120 * plan.nb + 40 * plan.nv


def flops_rnea(plan):
    return 260 * plan.nb + 40 * plan.nv


def flops_dyn_forward(plan):
    nb, nv = plan.nb, plan.nv
    return (272 * nb + 72 * nv + 14 * nv * nv + 2 * nv ** 3
            + flops_rnea(plan))


def flops_dyn_cached(plan):
    return flops_rnea(plan) + 2 * plan.nv * plan.nv + plan.nv


def flops_spd(n):
    """The Gauss-Jordan sweep of one n x n matrix: per pivot a rank-1
    update (2 n^2) and the pivot row and column (3 n)."""
    return n * (2 * n * n + 3 * n)


def flops_contact(cplan):
    """The least work of ``solve_bl``, whatever B4 itself does.  Once: J
    from S and the points, 12 per nonzero row-mask entry (S_ang x p plus
    S_lin), +15 per contact entry to project it into a frame.  Per
    iteration: J qd and J^T dlam, 12 per nonzero entry; ~23 per contact row
    (clamps, friction box), ~12 per bilateral row; qd += H^-1 x with x
    nonzero only on the dofs the group touches; 15 per limit dof and a
    full H^-1 matvec.  Then J^T lam once."""
    nv = cplan.nv
    nnz = cplan.mask_nonzeros()
    used = {k: int((cplan.masks[k] != 0).any(axis=0).sum()) for k in nnz}
    rows = {"c": cplan.P, "a": cplan.A, "g": cplan.G}
    per_row = {"c": 23, "a": 12, "g": 12}
    build = 12 * sum(nnz.values()) + (15 * nnz["c"] if cplan.has_frames
                                      else 0)
    it = sum(12 * nnz[k] + per_row[k] * rows[k]
             + (2 * nv * used[k] + nv if rows[k] else 0) for k in nnz)
    it += 15 * nv + 2 * nv * nv + nv
    return build + cplan.num_iterations * it + 6 * nnz["c"] + 2 * nv


@timed
def rounding_noise(torch, run, run64, args, kw=None):
    """How far float32 rounding alone moves a twin, per output and env:
    the largest, over the env's entries, of the float32 twin's distance
    from ``run64`` (the twin in float64 on the same inputs) and from itself
    on inputs moved by one rounding step (x (1 +- 2^-23), signs from a
    seed; three such runs).  Returns [(noise (N,), float64 output)] per
    output of ``run``."""
    kw = kw or {}
    tup = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731

    def each(f, xs, ks):
        return (*(f(x) for x in xs),), {k: f(v) for k, v in ks.items()}

    def f64(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() \
            else t

    ref = tup(run(*args, **kw))
    a64, k64 = each(f64, args, kw)
    ref64 = tup(run64(*a64, **k64))
    dev = [(r.double() - r64).abs() for r, r64 in zip(ref, ref64)]
    g = torch.Generator(device=ref[0].device).manual_seed(17)

    def nudge(t):
        if not (torch.is_tensor(t) and t.is_floating_point()):
            return t
        s = torch.randint(0, 2, t.shape, generator=g, device=t.device,
                          dtype=t.dtype) * 2 - 1
        return t * (1 + s * 2.0 ** -23)

    for _ in range(3):
        an, kn = each(nudge, args, kw)
        out = tup(run(*an, **kn))
        dev = [torch.maximum(d, (o - r).abs().double())
               for d, o, r in zip(dev, out, ref)]
    return [(d.reshape(-1, d.shape[-1]).amax(dim=0), r64)
            for d, r64 in zip(dev, ref64)]


def hold(name, got, ref, rtol, atol, noise=None):
    """Hold a batch-last kernel output against its float32 twin ``ref``
    within ``atol + rtol |ref|`` per entry.  With ``noise``, a pair from
    ``rounding_noise``, each env's bound is widened by four times the
    twin's float32 noise in that env: where rounding alone moves the twin
    that far, the kernel, which sums in another order, may differ by as
    much.  Prints the error (and, widened, the kernel's and the twin's
    distance from the float64 twin), the largest and the median bound used
    and the median and largest |ref|; returns the max abs error."""
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    ref_d = ref.double()
    tol = atol + rtol * ref_d.abs()
    extra = ""
    if noise is not None:
        env_noise, ref64 = noise
        tol = tol + 4.0 * env_noise
        extra = (f" kernel_vs_f64={float((got.double() - ref64).abs().max()):.3g}"
                 f" twin_vs_f64={float((ref_d - ref64).abs().max()):.3g}")
    diff = (got.double() - ref_d).abs()
    err = float(diff.max())
    print(f"[check] {name} max_abs_err={err:.3g}{extra} "
          f"max_bound={float(tol.max()):.3g} "
          f"median_bound={float(tol.median()):.3g} "
          f"median_abs_ref={float(ref_d.abs().median()):.3g} "
          f"max_abs_ref={float(ref_d.abs().max()):.3g} "
          f"widened={noise is not None}", flush=True)
    if not bool((diff <= tol).all()):     # NaN fails too
        i = int((diff - tol).nan_to_num(nan=float("inf")).reshape(-1)
                .argmax())
        at = ""
        if noise is not None:
            at = (f", env noise {float(env_noise[i % ref.shape[-1]]):.3g}, "
                  f"kernel vs f64 there "
                  f"{abs(float(got.reshape(-1)[i]) - float(ref64.reshape(-1)[i])):.3g}")
        raise AssertionError(
            f"{name}: kernel vs twin differs by {err:.3g} (worst excess at "
            f"flat index {i}, bound there {float(tol.reshape(-1)[i]):.3g}"
            f"{at})")
    return err


def generic_ant_state(np, task, seed):
    """A mid-motion Ant state from a seed: displaced and tilted torsos,
    joints anywhere inside their limits, nonzero velocities."""
    g = np.random.default_rng(seed)
    n = task.num_envs
    m = task.model
    q = np.zeros((n, m.nq), np.float32)
    q[:, 0:2] = g.uniform(-1.0, 1.0, (n, 2))
    q[:, 2] = g.uniform(0.25, 0.7, n)
    quat = np.array([0, 0, 0, 1.0]) + 0.3 * g.normal(size=(n, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 7:] = g.uniform(np.asarray(m.dof_lower[6:]),
                         np.asarray(m.dof_upper[6:]), (n, 8))
    qd = g.normal(0.0, 1.0, (n, m.nv)).astype(np.float32)
    return q, qd


def policy(torch, task, dev):
    """tanh(obs @ W) with W from a seed (as bench.py drives the JAX
    package)."""
    gw = torch.Generator(device=dev).manual_seed(0)
    W = torch.randn((task.num_obs, task.num_actions), generator=gw,
                    device=dev) * 0.1
    return lambda obs: torch.tanh(obs @ W)


def zero_obs(torch, task, dev):
    """The obs a run starts from: one row per agent."""
    return torch.zeros((task.rl_games_batch, task.num_obs), device=dev)


@timed
def run_steps(torch, task, state, obs, act, steps):
    for _ in range(steps):
        state, res = task.step(state, act(obs))
        obs = res.obs
    return state, obs


@timed
def check_dyn_kernels(torch, dk, task, q_bl, qd_bl, dev, scene, widen=(),
                      scales=None):
    """B1-B3 against their twins on one scene's state; returns per kernel
    {max_abs_err, ms, plain_ms, device_us, bytes, flops}; for B3 also the
    bytes with only H^-1's block entries read (``block_bytes``).
    ``widen``: names of the
    B2 and B3 outputs ("qdd", "Hinv") held per env against the twin's
    float32 rounding noise as ``hold`` says; the others at fixed bounds.
    ``scales``: the main path's per-env (mass (N, nb), shape (N, nb, 3))
    physics scales (Trifinger's domain randomization): B2 is held and
    timed with them, and B3 with the gravity wrench they scale."""
    plan = task.engine.plan
    N = q_bl.shape[-1]
    g = torch.Generator(device=dev).manual_seed(3)
    rhs_bl = torch.randn((plan.nv, N), generator=g, device=dev)
    diag_bl = (task.engine.dof_armature[:, None] + 0.1).expand(
        plan.nv, N).contiguous()
    consts = plan.consts(dev)
    c64 = {k: v.double() for k, v in consts.items()}
    report = {}
    close = lambda what, a, b, rtol, atol, noise=None: hold(  # noqa: E731
        f"{scene} {what}", a, b, rtol, atol, noise)

    def noise(twin, names, *a):
        """{output name: rounding_noise pair} for the twin's outputs (named
        ``names`` in order) that ``widen`` names."""
        if not set(names) & set(widen):
            return {}
        run = lambda c: lambda *x: twin(plan, c, *x)  # noqa: E731
        pairs = rounding_noise(torch, run(consts), run(c64), a)
        return {n: z for n, z in zip(names, pairs) if n in widen}

    bx, bq, S = dk.fk_motion(plan, q_bl)
    rbx, rbq, rS = dk._fk_motion_bl(plan, q_bl)
    err = max(close("fk_motion body_x", bx, rbx, 1e-5, 1e-5),
              close("fk_motion body_q", bq, rbq, 1e-5, 1e-5),
              close("fk_motion S", S, rS, 1e-5, 1e-5))
    report["fk_motion"] = dict(
        max_abs_err=err, ms=gpu_ms(torch, lambda: dk.fk_motion(plan, q_bl)),
        plain_ms=twin_ms(torch, lambda: dk._fk_motion_bl(plan, q_bl)),
        device_us=device_us(torch, lambda: dk.fk_motion(plan, q_bl),
                            "fk_motion_kernel"),
        bytes=nbytes(q_bl, bx, bq, S), flops=flops_fk(plan) * N)

    args = (rbx, rbq, rS, qd_bl, rhs_bl, diag_bl)
    if scales is not None:
        args = (*args, scales[0].expand(N, plan.nb).t().contiguous(),
                scales[1].permute(1, 2, 0).contiguous())
    qdd, hinv, io = dk.dyn_forward(plan, *args)
    rqdd, rhinv, rio = dk.dyn_full_bl(plan, consts, *args)
    # qdd goes through the bias force, which at BallBalance (balls rolling
    # and spinning fast 1-2 m from the world origin) cancels large terms;
    # at FrankaReachMA H^-1 spans the cubes' tiny rotational inertias
    # (~1e4) and the arms' (~1)
    out3 = ("qdd", "Hinv", "I_O")
    nz = noise(dk.dyn_full_bl, out3, *args)
    err = max(close("dyn_forward I_O", io, rio, 1e-5, 1e-5),
              close("dyn_forward Hinv", hinv, rhinv, 2e-4, 1e-5,
                    nz.get("Hinv")),
              close("dyn_forward qdd", qdd, rqdd, 2e-4, 2e-4, nz.get("qdd")))
    # per-env mass and shape scales (the domain-randomization inputs)
    ms = torch.rand((plan.nb, N), generator=g, device=dev) + 0.5
    ss = torch.rand((plan.nb, 3, N), generator=g, device=dev) * 0.7 + 0.7
    out_s = dk.dyn_forward(plan, *args[:6], ms, ss)
    ref_s = dk.dyn_full_bl(plan, consts, *args[:6], ms, ss)
    nz = noise(dk.dyn_full_bl, out3, *args[:6], ms, ss)
    err = max(err, *(close(f"dyn_forward scaled {k}", a, b, *tol, nz.get(k))
                     for k, a, b, tol in zip(
                         out3, out_s, ref_s,
                         ((2e-4, 2e-4), (2e-4, 1e-5), (1e-5, 1e-5)))))
    report["dyn_forward"] = dict(
        max_abs_err=err, ms=gpu_ms(torch, lambda: dk.dyn_forward(plan, *args)),
        plain_ms=twin_ms(torch, lambda: dk.dyn_full_bl(plan, consts, *args)),
        device_us=device_us(torch, lambda: dk.dyn_forward(plan, *args),
                            "dyn_forward_kernel"),
        bytes=nbytes(*args, qdd, hinv, io), flops=flops_dyn_forward(plan) * N)

    body_x, body_q = rbx.permute(2, 0, 1), rbq.permute(2, 0, 1)
    fg = task.engine.gravity_wrench(body_x, body_q, *(scales or ())).permute(
        1, 2, 0).contiguous()
    cargs = (rS, qd_bl, rhs_bl, rio, rhinv, fg)
    qdd_c = dk.dyn_cached(plan, *cargs)
    rqdd_c = dk.dyn_cached_bl(plan, consts, *cargs)
    nz = noise(dk.dyn_cached_bl, ("qdd",), *cargs).get("qdd")
    err = close("dyn_cached qdd", qdd_c, rqdd_c, 2e-4, 2e-4, nz)
    n_hb = len(dk.tree_lists(plan)["hb_row"])
    report["dyn_cached"] = dict(
        max_abs_err=err,
        ms=gpu_ms(torch, lambda: dk.dyn_cached(plan, *cargs)),
        plain_ms=twin_ms(torch,
                         lambda: dk.dyn_cached_bl(plan, consts, *cargs)),
        device_us=device_us(torch, lambda: dk.dyn_cached(plan, *cargs),
                            "dyn_cached_kernel"),
        bytes=nbytes(*cargs, qdd_c), flops=flops_dyn_cached(plan) * N,
        block_bytes=nbytes(*cargs, qdd_c) - nbytes(rhinv) + 4 * n_hb * N)
    return report


@timed
def check_scaled_dyn(torch, dk, task, q_bl, qd_bl, mass, shape, dev, scene,
                     widen):
    """B2 with per-env ``mass`` (N, nb) and ``shape`` (N, nb, 3) scales
    (batch-last (nb, N) and (nb, 3, N) for the kernel; ``shape`` None: the
    mass scale alone, as Dextreme-ADR's rows give it) against its twin
    with the same scales, and B3 against its twin with the gravity wrench
    those scales give (engine.gravity_wrench), at ``hold``'s B2 / B3
    bounds (qdd and H^-1 widened per env with ``widen``).  Prints B2's
    device us per launch with the scales beside its time without them;
    returns {name: max_abs_err}."""
    plan = task.engine.plan
    N = q_bl.shape[-1]
    g = torch.Generator(device=dev).manual_seed(4)
    rhs_bl = torch.randn((plan.nv, N), generator=g, device=dev)
    diag_bl = (task.engine.dof_armature[:, None] + 0.1).expand(
        plan.nv, N).contiguous()
    consts = plan.consts(dev)
    c64 = {k: v.double() for k, v in consts.items()}
    bx, bq, S = dk._fk_motion_bl(plan, q_bl)
    ms_bl = mass.expand(N, plan.nb).t().contiguous()
    ss_bl = None if shape is None else shape.permute(1, 2, 0).contiguous()
    args = (bx, bq, S, qd_bl, rhs_bl, diag_bl, ms_bl, ss_bl)
    out = dk.dyn_forward(plan, *args)
    ref = dk.dyn_full_bl(plan, consts, *args)
    run = lambda f, c: lambda *x: f(plan, c, *x)  # noqa: E731
    nz = (rounding_noise(torch, run(dk.dyn_full_bl, consts),
                         run(dk.dyn_full_bl, c64), args) if widen
          else (None,) * 3)
    errs = {}
    errs["dyn_forward"] = max(
        hold(f"{scene} scaled dyn_forward {k}", a, b, *tol, z)
        for k, a, b, tol, z in zip(
            ("qdd", "Hinv", "I_O"), out, ref,
            ((2e-4, 2e-4), (2e-4, 1e-5), (1e-5, 1e-5)),
            (nz[0], nz[1], None)))
    fg = task.engine.gravity_wrench(bx.permute(2, 0, 1), bq.permute(2, 0, 1),
                                    mass, shape).permute(1, 2, 0).contiguous()
    cargs = (S, qd_bl, rhs_bl, ref[2], ref[1], fg)
    nzc = (rounding_noise(torch, run(dk.dyn_cached_bl, consts),
                          run(dk.dyn_cached_bl, c64), cargs)[0] if widen
           else None)
    errs["dyn_cached"] = hold(f"{scene} scaled dyn_cached qdd",
                              dk.dyn_cached(plan, *cargs),
                              dk.dyn_cached_bl(plan, consts, *cargs),
                              2e-4, 2e-4, nzc)
    us = device_us(torch, lambda: dk.dyn_forward(plan, *args),
                   "dyn_forward_kernel")
    us0 = device_us(torch, lambda: dk.dyn_forward(plan, *args[:6]),
                    "dyn_forward_kernel")
    b_us = bound(nbytes(*args, *out), flops_dyn_forward(plan) * N)[0] * 1e3
    phase("scaled_kernel", scene=scene, name="dyn_forward", envs=N,
          device_us=f"{us:.2f}", unscaled_device_us=f"{us0:.2f}",
          bound_us=f"{b_us:.2f}", max_abs_err=f"{errs['dyn_forward']:.3g}",
          cached_max_abs_err=f"{errs['dyn_cached']:.3g}",
          mass_range=f"{float(mass.min()):.4f}-{float(mass.max()):.4f}",
          shape_range=("none" if shape is None else
                       f"{float(shape.min()):.4f}-{float(shape.max()):.4f}"))
    return errs


@timed
def capture_contact_inputs(torch, ck, task, dev, steps, grabs=False,
                           landed_z=None):
    """Run ``steps`` steps of a B4-route task and return the batch-last
    arguments of its last kernel-B4 launch (the main path's inputs).  With
    ``grabs`` (an MA task with grab constraints) the last step starts with
    live grabs in the first quarter of the envs (``parity.live_grabs``:
    each agent's cube on its grip site and at rest, its gripper action
    negative): a tanh policy almost never closes a gripper within 2.25 cm
    of a cube, so the grab rows would hold nothing otherwise; ``grabs`` may
    also be the function that makes them live (FrankaCabinet's
    ``parity.live_cabinet_grabs``).  With
    ``landed_z`` the last step starts with the root body of the first
    quarter of the envs at that height and at rest (Ingenuity: its box on
    the ground; the tanh policy keeps it in the air)."""
    from isaacgymenvs_ma_tpu_torch.utils.parity import live_grabs
    box = {}
    launch = ck.solve_kernel

    def spy(plan, *a, **k):
        box["call"] = (plan, a, k)
        return launch(plan, *a, **k)

    act = policy(torch, task, dev)
    state, obs = run_steps(torch, task, task.initial_state(),
                           zero_obs(torch, task, dev), act, steps - 1)
    actions = act(obs)
    if grabs:
        make_live = (live_grabs if grabs is True else grabs)
        state = make_live(task, state, actions,
                          torch.arange(task.num_envs // 4, device=dev))
    if landed_z is not None:
        q, qd = state.sim.q.clone(), state.sim.qd.clone()
        q[: task.num_envs // 4, 2] = landed_z
        qd[: task.num_envs // 4] = 0.0
        state = state._replace(sim=state.sim._replace(q=q, qd=qd))
    ck.solve_kernel = spy
    try:
        task.step(state, actions)
    finally:
        ck.solve_kernel = launch
    if grabs:
        g_act = box["call"][2]["g_act"]
        live = float(g_act.sum())
        print(f"[check] {type(task).__name__} live grab rows in the "
              f"captured B4 launch: {live:.0f} of {g_act.numel()}",
              flush=True)
        if not live:
            raise RuntimeError("no grab live in the captured B4 launch")
    if landed_z is not None:
        rows = float(box["call"][2]["active"].sum())
        print(f"[check] {type(task).__name__} active contact rows in the "
              f"captured B4 launch: {rows:.0f}", flush=True)
        if not rows:
            raise RuntimeError("no contact row active in the captured B4 "
                               "launch")
    return box["call"]


def synthetic_grab_call(torch, np, ck, dev, N=N_ENVS, nv=14, P=8, A=2, G=2):
    """A seeded contact problem with every group, grab rows included, frames
    on the contact rows, an SPD H^-1 and consistent Delassus diagonals, as
    (plan, (S, Hinv), keyword arguments) of ``solve_kernel``."""
    g = np.random.default_rng(5)
    masks = {k: g.choice([-1.0, 0.0, 0.0, 1.0], (r, nv)).astype(np.float32)
             for k, r in (("c", P), ("a", A), ("g", G))}
    plan = ck.ContactPlan(masks, nv, num_iterations=8, relaxation=0.35,
                          has_frames=True)
    t = lambda x: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(x, np.float32), device=dev)
    M = g.normal(size=(N, nv, nv)) / np.sqrt(nv)
    Hinv = t(np.moveaxis(M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(nv), 0, -1))
    S = t(g.normal(size=(nv, 6, N)))
    Q, _ = np.linalg.qr(g.normal(size=(N, P, 3, 3)))
    frames = t(np.moveaxis(Q, (0, 1), (-1, -2)))              # (3, 3, P, N)
    pts = {k: t(g.uniform(-1, 1, (3, r, N)))
           for k, r in (("c", P), ("a", A), ("g", G))}
    w = {}
    for k in ("c", "a", "g"):
        J = ck._row_jacobian(S, pts[k], plan.mask_tensors(dev)[k])
        if k == "c":
            J = torch.stack([sum(J[c] * frames[c, l][:, None, :]
                                 for c in range(3)) for l in range(3)])
        HJ = torch.einsum("ivb,ckvb->ckib", Hinv, J)
        w[k] = torch.clamp(torch.sum(J * HJ, dim=2), min=1e-8).contiguous()
    kw = dict(
        qd=t(g.normal(size=(nv, N))), pts_c=pts["c"],
        b_n=t(g.uniform(0, 1, (P, N))), mu=t(g.uniform(0.5, 1, (P, N))),
        active=t(g.uniform(size=(P, N)) < 0.7), frames=frames, w_c=w["c"],
        b_lo=t(g.uniform(0, 1, (nv, N))), b_hi=t(g.uniform(0, 1, (nv, N))),
        act_lo=t(g.uniform(size=(nv, N)) < 0.2),
        act_hi=t(g.uniform(size=(nv, N)) < 0.2),
        pts_a=pts["a"], b_a=t(g.normal(size=(3, A, N))), w_a=w["a"],
        pts_g=pts["g"], b_g=t(g.normal(size=(3, G, N))),
        g_act=t(g.uniform(size=(G, N)) < 0.5), w_g=w["g"])
    return plan, (S, Hinv), kw


@timed
def check_contact_kernel(torch, ck, call, scene, widen):
    """B4 against its twin on one call's inputs (rtol = atol = 1e-4: the
    kernel sums over rows and dofs in another order; with ``widen``, per
    env as ``hold`` says); returns the report entry."""
    plan, a, k = call
    out = ck.solve_kernel(plan, *a, **k)
    ref = ck.solve_bl(plan, *a, **k)
    twin = lambda *x, **kx: ck.solve_bl(plan, *x, **kx)  # noqa: E731
    noise = (rounding_noise(torch, twin, twin, a, k) if widen
             else (None,) * len(ref))
    err = max(hold(f"{scene} contact_solve {name}", x, y, 1e-4, 1e-4, nz)
              for name, x, y, nz in zip(("qd", "lam", "imp_dof"), out, ref,
                                        noise))
    N = a[0].shape[-1]
    return dict(max_abs_err=err,
                ms=gpu_ms(torch, lambda: ck.solve_kernel(plan, *a, **k)),
                plain_ms=twin_ms(torch, lambda: ck.solve_bl(plan, *a, **k)),
                device_us=device_us(
                    torch, lambda: ck.solve_kernel(plan, *a, **k),
                    "contact_solve_kernel"),
                bytes=nbytes(*a, *k.values(), *out),
                flops=flops_contact(plan) * N)


def capture_osc_inputs(torch, ctl, task, state, dev):
    """The SPD matrices one FrankaReachMA control step inverts through
    kernel B5 (the arm mass matrices, then J M^-1 J^T), from ``state``:
    OSC's ``spd_inverse`` (module ``ctl``) is wrapped for one call."""
    box = []
    inverse = ctl.spd_inverse

    def spy(H):
        box.append(H.clone())
        return inverse(H)

    ctl.spd_inverse = spy
    try:
        task.pre_physics(state, policy(torch, task, dev)(
            zero_obs(torch, task, dev) + 0.5))
    finally:
        ctl.spd_inverse = inverse
    return box


def seeded_spd(torch, B, n, seed, dev):
    """A A^T + 3 I from a seed (tests/test_contact_opt.py:88-89)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, n, n), generator=g, device=dev)
    return A @ A.transpose(1, 2) + 3.0 * torch.eye(n, device=dev)


@timed
def check_spd_kernel(torch, sk, dk, H, label, widen):
    """B5 against its twin on a (B, n, n) SPD stack: rtol 1e-4 / atol 1e-6
    per entry (the kernel rounds fused multiply-adds once); with
    ``widen`` each matrix's bound is widened by its twin's float32 rounding
    noise as ``hold`` says (near-singular arm poses make J M^-1 J^T
    ill-conditioned).  Prints max |H H^-1 - I| of the kernel and the twin;
    returns the report entry, with torch.linalg.inv's time beside it."""
    B, n = H.shape[0], H.shape[-1]
    out = sk.sweep_inverse(H)
    H_bl = H.permute(1, 2, 0).contiguous()
    ref = dk.sweep_inverse_bl(H_bl)
    nz = (rounding_noise(torch, dk.sweep_inverse_bl, dk.sweep_inverse_bl,
                         (H_bl,))[0] if widen else None)
    err = hold(f"{label} spd_inverse", out.permute(1, 2, 0), ref, 1e-4, 1e-6,
               nz)
    eye = torch.eye(n, device=H.device)
    resid = [float((torch.bmm(H, x) - eye).abs().amax())
             for x in (out, ref.permute(2, 0, 1))]
    print(f"[check] {label} spd_inverse max|H Hinv - I| kernel={resid[0]:.3g}"
          f" twin={resid[1]:.3g}", flush=True)
    return dict(max_abs_err=err, ms=gpu_ms(torch, lambda: sk.sweep_inverse(H)),
                plain_ms=twin_ms(torch, lambda: dk.sweep_inverse_bl(H_bl)),
                library_ms=gpu_ms(torch, lambda: torch.linalg.inv(H)),
                device_us=device_us(torch, lambda: sk.sweep_inverse(H),
                                    "spd_inverse_kernel"),
                bytes=nbytes(H, out), flops=flops_spd(n) * B, n=n)


@timed
def main_phase(torch, wrappers, task, dev, steps, expected, forbidden,
               warmup=MAIN_WARMUP):
    """One main-path phase: ``warmup`` steps, every launch count set to 0,
    ``steps`` steps, the counts read.  Fails on non-finite output, a wrong
    shape, a kernel of ``expected`` never launched or one of ``forbidden``
    launched.  For a task with grab constraints it also sums, on the card,
    the agent rows with a grab live in each step's control."""
    act = policy(torch, task, dev)
    state = task.initial_state()
    obs = zero_obs(torch, task, dev)
    state, obs = run_steps(torch, task, state, obs, act, warmup)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    resets = torch.zeros((), dtype=torch.int64, device=dev)
    grab_rows = torch.zeros((), dtype=torch.float32, device=dev)
    if task.engine.grabs:
        pre = task.pre_physics

        def counted(*a, **k):
            nonlocal grab_rows
            ctrl = pre(*a, **k)
            grab_rows = grab_rows + ctrl.grab_active.reshape(
                task.num_envs, task.num_agents, -1).amax(-1).sum()
            return ctrl

        task.pre_physics = counted
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, res = task.step(state, act(obs))
        obs = res.obs
        finite &= torch.isfinite(obs).all() & torch.isfinite(res.rew).all()
        resets += res.reset.sum()
    end.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if task.engine.grabs:
        del task.pre_physics
    launches = {name: w.launches for name, w in wrappers.items()}
    waits = host_waits(torch, task, state, act, obs)
    finite &= (torch.isfinite(state.sim.q).all()
               & torch.isfinite(state.sim.qd).all())
    if not bool(finite):
        raise RuntimeError("main path produced non-finite values")
    if tuple(obs.shape) != (task.rl_games_batch, task.num_obs):
        raise RuntimeError(f"obs shape {tuple(obs.shape)}")
    check_launches(launches, expected, forbidden, "main path")
    return dict(seconds=seconds, stream_ms=start.elapsed_time(end) / steps,
                resets=int(resets), launches=launches,
                grab_share=float(grab_rows) / (steps * task.rl_games_batch),
                host_waits=waits)


@timed
def dr_stats(torch, task, dev, steps=20):
    """The domain randomization on a task's main path (Trifinger): ``steps``
    steps of the tanh policy from a fresh state with the noise the step
    adds to the actions and observations summed on the card (the
    randomizer's methods wrapped), then one step with every other env
    flagged to reset.  Fails unless the friction scales changed in every
    flagged env and in no other, and the measured noise std is within 5%
    of the configuration's (actions: white and correlated together).
    Prints the spread of the drawn mass, shape and friction scales of the
    randomized actor."""
    dr = task.randomizer
    acc = {k: torch.zeros(3, dtype=torch.float64, device=dev)
           for k in ("actions", "observations")}

    def wrap(key, f):
        def noisy(x, noise, **k):
            out = f(x, noise, **k)
            dx = (out - x).double()
            acc[key] += torch.stack([torch.ones_like(dx).sum(), dx.sum(),
                                     (dx * dx).sum()])
            return out
        return noisy

    dr.randomize_actions = wrap("actions", dr.randomize_actions)
    dr.randomize_observations = wrap("observations",
                                     dr.randomize_observations)
    try:
        act = policy(torch, task, dev)
        st, obs = run_steps(torch, task, task.initial_state(),
                            zero_obs(torch, task, dev), act, steps)
        flags = (torch.arange(task.num_envs, device=dev) % 2 == 0).to(
            torch.int32)
        st2, _ = task.step(st._replace(reset_buf=flags), act(obs))
    finally:
        del dr.randomize_actions, dr.randomize_observations
    changed = (st2.phys.friction != st.phys.friction).any(-1)
    share = float(changed[flags == 1].double().mean())
    stray = float(changed[flags == 0].double().mean())
    stds = {}
    for key, spec in (("actions", dr.act_spec), ("observations",
                                                  dr.obs_spec)):
        n, s1, s2 = (float(v) for v in acc[key])
        var_w = float(spec["range"][1])
        var_c = float(spec.get("range_correlated", [0, 0])[1])
        stds[key] = ((s2 / n - (s1 / n) ** 2) ** 0.5,
                     (var_w ** 2 + var_c ** 2) ** 0.5)
    body = task.object_body
    ph = st.phys
    spread = lambda x: f"{float(x.min()):.4f}/{float(x.mean()):.4f}/" \
        f"{float(x.max()):.4f}"  # noqa: E731
    phase("dr", task=type(task).__name__, envs=task.num_envs,
          mass=spread(ph.mass[:, body]), shape=spread(ph.shape[:, body]),
          friction=spread(ph.friction), reset_changed_share=f"{share:.4f}",
          unflagged_changed_share=f"{stray:.4f}",
          **{f"{k}_noise_std": f"{v[0]:.6f}" for k, v in stds.items()},
          **{f"{k}_config_std": f"{v[1]:.6f}" for k, v in stds.items()})
    if share != 1.0 or stray != 0.0:
        raise RuntimeError(f"friction resampled in {share} of the flagged "
                           f"envs and {stray} of the others")
    for k, (got, want) in stds.items():
        if abs(got - want) > 0.05 * want:
            raise RuntimeError(f"{k} noise std {got} against the "
                               f"configuration's {want}")


def check_launches(launches, expected, forbidden, what):
    missing = [k for k in expected if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{what} never launched kernels {missing}")
    stray = [k for k in forbidden if launches[k]]
    if stray:
        raise RuntimeError(f"{what} launched kernels {stray} off their path")


@timed
def train_run(torch, wrappers, agent, warm, epochs, expected, forbidden):
    """One training run: ``warm`` epochs, every launch count set to 0, then
    ``epochs`` timed epochs, each by CUDA events split at the start of the
    update (rollout + GAE | normalisers + minibatch SGD) and by the host
    clock to a synchronize, its host waits for the card counted by file
    and line (CUDA sync debug mode).  Fails on a non-finite loss or
    parameter, parameters unchanged by an epoch, a wrong obs shape or a
    kernel outside its set."""
    task = agent.task
    marks = []
    update = agent._update

    def timed_update(*a, **k):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        return update(*a, **k)

    agent._update = timed_update
    agent.init()
    for _ in range(warm):
        agent.train_epoch()
    for w in wrappers.values():
        w.launches = 0
    rows = []
    for _ in range(epochs):
        before = [p.detach().clone() for p in agent.net.parameters()]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        # count the epoch's host waits for the card (CUDA sync debug mode)
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                start.record()
                m = agent.train_epoch()
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or not all(bool(torch.isfinite(p).all())
                          for p in agent.net.parameters()):
            raise RuntimeError(f"non-finite training values {bad or 'params'}")
        if all(torch.equal(a, b) for a, b in zip(before,
                                                 agent.net.parameters())):
            raise RuntimeError("an epoch left the parameters unchanged")
        sync_at = collections.Counter(
            "/".join(w.filename.split(os.sep)[-2:]) + f":{w.lineno}"
            for w in syncs)
        rows.append(dict(seconds=seconds,
                         rollout_ms=start.elapsed_time(marks[-1]),
                         update_ms=marks[-1].elapsed_time(end), m=m,
                         host_syncs=len(syncs), sync_at=sync_at))
    shape = tuple(agent.last_obs.shape)
    if shape != (task.rl_games_batch, task.num_obs):
        raise RuntimeError(f"obs shape {shape}")
    launches = {name: w.launches for name, w in wrappers.items()}
    check_launches(launches, expected, forbidden, "training")
    return rows, launches


def report_ppo(tag, task, agent, rows, launches, epochs, **extra):
    """The ``[train]`` lines of a PPO-family run: one an epoch, then its
    launches."""
    for i, r in enumerate(rows):
        m, sec = r["m"], r["seconds"]
        rows_per_s = agent.batch * agent.horizon / sec
        agents = ({} if task.num_agents == 1 else dict(
            agents=task.num_agents, agent_steps_per_s=f"{rows_per_s:.1f}"))
        phase("train", run=tag, epoch=i + 1, envs=task.num_envs,
              network=type(agent.net).__name__,
              horizon=agent.horizon, minibatches=agent.num_minibatches,
              mini_epochs=agent.cfg.mini_epochs, seconds=f"{sec:.4f}",
              rollout_ms=f"{r['rollout_ms']:.3f}",
              update_ms=f"{r['update_ms']:.3f}",
              host_syncs=r["host_syncs"],
              sync_at=json.dumps(dict(r["sync_at"])).replace(" ", ""),
              env_steps_per_s=f"{task.num_envs * agent.horizon / sec:.1f}",
              **agents, **{k: f"{m[k]:.6g}" for k in (
                  "loss", "a_loss", "c_loss", "kl", "lr", "sigma",
                  "mean_return", "episodes_done")},
              **{k.split("/")[-1]: f"{v:.6g}" for k, v in m.items()
                 if "fsm" in k.lower() or k.startswith("disc_")})
    phase("train", run=tag, epochs=epochs,
          launches=json.dumps(launches).replace(" ", ""), **extra)


@timed
def sac_run(torch, wrappers, agent, warm, epochs, expected, forbidden):
    """One SAC run: ``warm`` epochs (the seed steps among them), every
    launch count set to 0, then ``epochs`` timed epochs, each by CUDA
    events and by the host clock to a synchronize, its host waits counted
    by file and line.  Fails on a non-finite metric or parameter, an epoch
    without updates or that left the actor or the critic unchanged, a
    wrong obs shape or a kernel outside its set."""
    task = agent.task
    agent.init()
    for _ in range(warm):
        agent.train_epoch()
    for w in wrappers.values():
        w.launches = 0
    rows = []
    for _ in range(epochs):
        nets = (agent.actor, agent.critic)
        before = [[p.detach().clone() for p in n.parameters()] for n in nets]
        step0 = agent.step
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                start.record()
                m = agent.train_epoch()
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        m = {k: float(v) for k, v in m.items()}
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or not all(bool(torch.isfinite(p).all()) for n in nets
                          for p in n.parameters()):
            raise RuntimeError(f"non-finite SAC values {bad or 'params'}")
        updates = sum(1 for s in range(step0 + 1, agent.step + 1)
                      if s > agent.num_seed_steps)
        if not updates or any(
                all(torch.equal(a, b) for a, b in zip(bs, n.parameters()))
                for bs, n in zip(before, nets)):
            raise RuntimeError(f"a SAC epoch with {updates} updates left "
                               "the actor or the critic unchanged")
        rows.append(dict(seconds=seconds, device_ms=start.elapsed_time(end),
                         m=m, updates=updates, host_syncs=len(syncs),
                         sync_at=collections.Counter(
                             "/".join(w.filename.split(os.sep)[-2:])
                             + f":{w.lineno}" for w in syncs)))
    shape = tuple(agent.last_obs.shape)
    if shape != (task.rl_games_batch, task.num_obs):
        raise RuntimeError(f"obs shape {shape}")
    launches = {name: w.launches for name, w in wrappers.items()}
    check_launches(launches, expected, forbidden, "SAC training")
    return rows, launches


@timed
def amp_rsi_check(torch, task, dev, steps=10):
    """Reference State Init on the card: ``steps`` steps of the tanh policy
    from a fresh state, then one step with every other env flagged to
    reset and the motion draws given.  Each flagged env must leave the step
    at the motion library's state for its draw (root pose and velocity,
    dof positions and velocities), bit for bit; the share of the other
    envs at it is reported (``stray``, 0 expected)."""
    act = policy(torch, task, dev)
    st, obs = run_steps(torch, task, task.initial_state(),
                        zero_obs(torch, task, dev), act, steps)
    n, ml = task.num_envs, task.motion_lib
    flags = torch.arange(n, device=dev) % 2 == 0
    g = torch.Generator(device=dev).manual_seed(21)
    ids = ml.sample_motions(n, g)
    times = ml.sample_time(ids, g)
    st2, _ = task.step(st._replace(reset_buf=flags.to(torch.int32)),
                       act(obs), reset_draws=(ids, times))
    s = ml.get_motion_state(ids, times)
    want = torch.cat([s["root_pos"], s["root_rot"], s["root_vel"],
                      s["root_ang_vel"], s["dof_pos"], s["dof_vel"]], -1)
    sim = st2.sim
    got = torch.cat([sim.q[:, 0:7], sim.qd[:, 0:6],
                     task.engine.dof_pos(sim), task.engine.dof_vel(sim)], -1)
    diff = (got - want).abs().amax(-1)
    err = float(diff[flags].max())
    if err != 0.0:
        raise RuntimeError(f"RSI resets {err} away from the motion state")
    return {"err": err, "stray": float((diff[~flags] == 0).double().mean())}


def hrl_inner_steps(torch, hrl, agent):
    """The wrapped task's steps in one outer step of the HRL wrapper,
    counted on the host from the agent's state and latents of zeros."""
    step, calls = hrl.task.step, []

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    hrl.task.step = counted
    try:
        hrl.step(agent.env_state, hrl.zero_actions())
    finally:
        del hrl.task.step
    return len(calls)


def build_all(_build, plans):
    """Build every plan's kernels, all nvcc processes started together;
    print the time and each kernel's ptxas registers and spills."""
    t0 = time.perf_counter()
    # plans with the same header (Anymal's and AnymalTerrain's scene)
    # share their libraries: each header is compiled once, the others load
    first = {}
    for _, p in plans:
        first.setdefault((type(p).__name__, p.header()), p)
    pending = [_build.build(p, wait=False) for p in first.values()]
    for finish in pending:
        finish()
    for _, p in plans:
        _build.build(p)
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          libraries=sum(len(p.libs) for p in first.values()))
    for scene, p in plans:
        for name in sorted(p.build_log):
            for line in p.build_log[name].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {scene} {name}: {line.strip()}",
                          flush=True)


def check_franka_kernels(torch, dk, sk, ck, ctl, task, task_b4, dev):
    """B1-B3 at FrankaReachMA-8192 shapes on a state 30 steps in (cubes on
    the table, arms moving), qdd and H^-1 held per env; B4 on the inputs
    the B4 route hands it 30 steps in (41 rows with frames, held per env);
    B5 on the first state's two OSC inverses (held per matrix) and on
    the seeded SPD stacks of ``SPD_SEEDED`` (fixed bounds)."""
    st, _ = run_steps(torch, task, task.initial_state(),
                      zero_obs(torch, task, dev), policy(torch, task, dev), 30)
    gq = torch.Generator(device=dev).manual_seed(13)
    qd = st.sim.qd + 0.3 * torch.randn(st.sim.qd.shape, generator=gq,
                                       device=dev)
    rep = check_dyn_kernels(torch, dk, task, st.sim.q.t().contiguous(),
                            qd.t().contiguous(), dev, "franka_reach_ma",
                            ("qdd", "Hinv"))
    rep["contact_solve"] = check_contact_kernel(
        torch, ck, capture_contact_inputs(torch, ck, task_b4, dev, 30),
        "franka_reach_ma", True)
    mm, m_eef_inv = capture_osc_inputs(torch, ctl, task, st, dev)

    def spd(label, H, widen):
        B, n = H.shape[0], H.shape[-1]
        return check_spd_kernel(torch, sk, dk, H,
                                f"franka_reach_ma {label} ({B},{n},{n})",
                                widen)

    # the kernels JSON row of B5: the arm mass matrices of the main path
    rep["spd_inverse"] = spd("osc_mm", mm, True)
    extra = {"osc_m_eef_inv": spd("osc_m_eef_inv", m_eef_inv, True)}
    for B, n, seed in SPD_SEEDED:
        extra[f"seeded_{n}"] = spd(f"seeded_{n}",
                                   seeded_spd(torch, B, n, seed, dev), False)
    return rep, extra


def check_loco_kernels(torch, dk, ck, task, task_b4, dev, scene):
    """B1-B3 at a legged or aerial scene's 4096-env shapes on a state 30
    steps in (qd nudged by N(0, 0.3)), qdd and H^-1 held per env (Humanoid
    sweeps one 27-dof block); B4 on the inputs its route hands it 30 steps
    in, held per env (at Anymal the terrain rows of an AnymalTerrain step,
    its bases 30-180 m from the world origin; at Ingenuity with a quarter
    of the chassis landed, their box corners 2 mm into the ground)."""
    st, _ = run_steps(torch, task, task.initial_state(),
                      zero_obs(torch, task, dev), policy(torch, task, dev), 30)
    gq = torch.Generator(device=dev).manual_seed(15)
    qd = st.sim.qd + 0.3 * torch.randn(st.sim.qd.shape, generator=gq,
                                       device=dev)
    rep = check_dyn_kernels(torch, dk, task, st.sim.q.t().contiguous(),
                            qd.t().contiguous(), dev, scene, ("qdd", "Hinv"))
    if task_b4 is not None:
        landed = 0.058 if scene == "ingenuity" else None
        rep["contact_solve"] = check_contact_kernel(
            torch, ck, capture_contact_inputs(torch, ck, task_b4, dev, 30,
                                              landed_z=landed),
            scene, True)
    return rep


def check_single_kernels(torch, dk, sk, ck, ctl, task, task_b4, dev, scene,
                         parity):
    """B1-B3 at a single-arm Franka or Trifinger scene's full-width shapes
    on a state 30 steps in (qd nudged by N(0, 0.3)), qdd and H^-1 held per
    env, Trifinger's B2 and B3 with the physics scales its randomizer drew
    (B2 with its mass and shape scales, B3 with the gravity wrench they
    scale); B4 on the inputs its route hands it 30 steps in, held per env
    (FrankaCabinet with the handle grabbed and FrankaCubeStack with cube A
    held in a quarter of the envs; Trifinger's rows with its per-env
    friction and shape-scaled pair rows); B5 at the two OSC stacks of the
    OSC tasks, held per matrix."""
    st, _ = run_steps(torch, task, task.initial_state(),
                      zero_obs(torch, task, dev), policy(torch, task, dev), 30)
    gq = torch.Generator(device=dev).manual_seed(16)
    qd = st.sim.qd + 0.3 * torch.randn(st.sim.qd.shape, generator=gq,
                                       device=dev)
    scales = (None if st.phys is None or st.phys.shape is None
              else (st.phys.mass, st.phys.shape))
    rep = check_dyn_kernels(torch, dk, task, st.sim.q.t().contiguous(),
                            qd.t().contiguous(), dev, scene, ("qdd", "Hinv"),
                            scales)
    grabs = {"franka_cabinet": parity.live_cabinet_grabs,
             "franka_cube_stack": True}.get(scene, False)
    call = capture_contact_inputs(torch, ck, task_b4, dev, 30, grabs=grabs)
    if scene == "trifinger":
        mu = call[2]["mu"]
        print(f"[check] trifinger B4 launch: per-env mu spread "
              f"{float(mu.min()):.4f}-{float(mu.max()):.4f} over "
              f"{tuple(mu.shape)}", flush=True)
    elif scene.startswith("allegro_kuka"):
        act = call[2]["active"]
        sc = task_b4.object_scales
        print(f"[check] {scene} B4 launch: active rows {float(act.sum()):.0f}"
              f" of {act.numel()}, the cube's per-env scales "
              f"{float(sc.min()):.2f}-{float(sc.max()):.2f} "
              f"({len(set(map(tuple, task_b4.object_scales_np)))} sizes)",
              flush=True)
    rep["contact_solve"] = check_contact_kernel(torch, ck, call, scene, True)
    extra = {}
    if type(task).__name__ in OSC_TASKS:
        mm, m_eef_inv = capture_osc_inputs(torch, ctl, task, st, dev)
        for label, H in (("osc_mm", mm), ("osc_m_eef_inv", m_eef_inv)):
            B, n = H.shape[0], H.shape[-1]
            extra[label] = check_spd_kernel(
                torch, sk, dk, H, f"{scene} {label} ({B},{n},{n})", True)
        rep["spd_inverse"] = extra.pop("osc_mm")
    return rep, extra


def check_hand_kernels(torch, dk, task, dev, scene):
    """B1-B3 at a hand scene's full-width shapes on a state 30 steps in
    (qd nudged by N(0, 0.3)), qdd and H^-1 held per env.  The hands split
    masses, so their contact solve is the batched loop and B4 is not on
    their path."""
    st, _ = run_steps(torch, task, task.initial_state(),
                      zero_obs(torch, task, dev), policy(torch, task, dev), 30)
    gq = torch.Generator(device=dev).manual_seed(18)
    qd = st.sim.qd + 0.3 * torch.randn(st.sim.qd.shape, generator=gq,
                                       device=dev)
    return check_dyn_kernels(torch, dk, task, st.sim.q.t().contiguous(),
                             qd.t().contiguous(), dev, scene,
                             ("qdd", "Hinv"))


@timed
def hand_stats(torch, task, dev, tag, steps=10):
    """The hands' engine features live on the main path: ``steps`` steps
    of the tanh policy after 10 with the engine's row scale spied (every
    solve's active rows and their scales summed on the card).  Prints the
    share of active rows scaled below 1 and the smallest scale
    (``[mass_split]``; fails unless some row is scaled) and, with dof
    friction, the mean and largest |friction torque| mu tanh(qd / 0.05)
    over the hand dofs of the states stepped from (``[dof_friction]``)."""
    eng = task.engine
    acc = torch.zeros(3, dtype=torch.float64, device=dev)
    low = torch.ones((), device=dev)
    split = eng.mass_split_scale

    def spy(active, sel, frames):
        nonlocal low
        rs = split(active, sel, frames)
        a = active.to(rs.dtype)
        acc.add_(torch.stack([a.sum(), (a * (rs < 1.0)).sum(),
                              torch.ones((), device=dev)]).double())
        low = torch.minimum(low, torch.where(active, rs, 1.0).amin())
        return rs

    act = policy(torch, task, dev)
    st, obs = run_steps(torch, task, task.initial_state(),
                        zero_obs(torch, task, dev), act, 10)
    fric = torch.zeros(2, dtype=torch.float64, device=dev)
    eng.mass_split_scale = spy
    try:
        for _ in range(steps):
            if eng.has_dof_friction:
                tq = (eng.dof_friction * torch.tanh(st.sim.qd / 0.05)).abs()
                fric[0] += tq[:, eng.dof_friction > 0].mean().double()
                fric[1] = torch.maximum(fric[1], tq.amax().double())
            st, res = task.step(st, act(obs))
            obs = res.obs
    finally:
        del eng.mass_split_scale
    n_act, n_low, solves = (float(v) for v in acc)
    share = n_low / max(n_act, 1.0)
    phase("mass_split", phase=tag, envs=task.num_envs, steps=steps,
          solves=int(solves), active_rows_per_solve=f"{n_act / solves:.1f}",
          scaled_share=f"{share:.4f}", min_scale=f"{float(low):.4f}")
    if not share > 0.0:
        raise RuntimeError(f"{tag}: no active contact row scaled by mass "
                           "splitting")
    if eng.has_dof_friction:
        phase("dof_friction", phase=tag, envs=task.num_envs,
              mean_abs_torque=f"{float(fric[0]) / steps:.6f}",
              max_abs_torque=f"{float(fric[1]):.6f}",
              friction=f"{float(eng.dof_friction.max()):.4f}")


def restitution_phase(torch, np, tasks, dev, steps_in=30):
    """``[restitution]``: one engine step of the AllegroHand scene at
    8192 envs (plane restitution 0.5) on the card and on the CPU twins from
    the same state (30 policy steps in, every cube thrown at the palm at 1
    m/s), control and physics scales (restitution 0.5 on every body,
    limit shifts U(-0.1, 0.1) on the hand dofs from a seed), held at the
    ground-rule bounds (q rtol 2e-4 / atol 2e-5, qd 3e-3: a pair scene)
    with each env's bound widened by four times the CPU step's own move
    under one-ulp noise on q and qd (two nudged runs).  Prints the share
    of active rows whose bounce target binds in the card's step (fails
    unless above 0) and the route ``engine.route_for`` gives for the hand
    scene's call and for an Ant-4096 call with the contact kernel
    requested and restitution (fails unless both read the loop)."""
    from isaacgymenvs_ma_tpu_torch.utils.domain_rand import PhysScales
    base = tasks["allegro_hand"]
    n, nb, nv = base.num_envs, base.engine.nb, base.engine.nv
    params = base.sim_params._replace(plane_restitution=0.5)
    card = type(base)(base.cfg, device=dev, seed=1, sim_params=params)
    cpu = type(base)(base.cfg, device="cpu", seed=1, sim_params=params)
    st, obs = run_steps(torch, card, card.initial_state(),
                        zero_obs(torch, card, dev), policy(torch, card, dev),
                        steps_in)
    qd = st.sim.qd.clone()
    qd[:, card.obj_va + 2] = -1.0
    st = st._replace(sim=st.sim._replace(qd=qd))
    ctrl, _ = card.pre_physics(st, policy(torch, card, dev)(obs))
    g = np.random.default_rng(15)
    shift = np.zeros((n, nv), np.float32)
    shift[:, card.hand_dofs] = g.uniform(-0.1, 0.1,
                                         (n, len(card.hand_dofs)))

    def scales(device):
        one = torch.ones((n, 1), device=device)
        sh = torch.as_tensor(shift, device=device)
        return PhysScales(one, one, one, one, dof_lower_shift=sh,
                          dof_upper_shift=-sh,
                          restitution=torch.full((n, nb), 0.5,
                                                 device=device))
    # the card's step with its bounce targets counted
    eng = card.engine
    normal, bounce = eng._normal_targets, eng._bounce_targets
    last = {}
    acc = torch.zeros(2, dtype=torch.float64, device=dev)

    def normal_targets(phi):
        last["active"], b_n = normal(phi)
        return last["active"], b_n

    def bounce_targets(b_n, e_rows, J_flat, qd_, R):
        lifted = bounce(b_n, e_rows, J_flat, qd_, R)
        act = last["active"]
        acc.add_(torch.stack([act.sum(), (act & (lifted > b_n)).sum()])
                 .double())
        return lifted

    eng._normal_targets, eng._bounce_targets = normal_targets, bounce_targets
    try:
        phys = scales(dev)
        got, _ = eng.step(st.sim, ctrl, phys=phys)
    finally:
        del eng._normal_targets, eng._bounce_targets
    cpu_ctrl = ctrl._replace(**{k: getattr(ctrl, k).cpu() for k in (
        "tau", "pos_target", "vel_target", "f_ext")
        if getattr(ctrl, k) is not None})
    sim0 = st.sim._replace(q=st.sim.q.cpu(), qd=st.sim.qd.cpu())
    t0 = time.perf_counter()
    ref, _ = cpu.engine.step(sim0, cpu_ctrl, phys=scales("cpu"))
    cpu_s = time.perf_counter() - t0
    gn = torch.Generator().manual_seed(16)
    spread = {"q": torch.zeros(n, dtype=torch.float64),
              "qd": torch.zeros(n, dtype=torch.float64)}
    for _ in range(2):
        nudge = lambda x: x * (1 + (torch.randint(  # noqa: E731
            0, 2, x.shape, generator=gn) * 2 - 1) * 2.0 ** -23)
        alt, _ = cpu.engine.step(sim0._replace(q=nudge(sim0.q),
                                               qd=nudge(sim0.qd)),
                                 cpu_ctrl, phys=scales("cpu"))
        for k in spread:
            d = (getattr(alt, k) - getattr(ref, k)).abs().amax(-1).double()
            spread[k] = torch.maximum(spread[k], d)
    errs = {}
    for k, rtol, atol in (("q", 2e-4, 2e-5), ("qd", 3e-3, 3e-3)):
        a = getattr(got, k).cpu().double()
        b = getattr(ref, k).double()
        tol = atol + rtol * b.abs() + 4.0 * spread[k][:, None]
        diff = (a - b).abs()
        errs[k] = float(diff.max())
        print(f"[check] restitution {k} max_abs_err={errs[k]:.3g} "
              f"max_bound={float(tol.max()):.3g} "
              f"median_bound={float(tol.median()):.3g} "
              f"median_env_spread={float(spread[k].median()):.3g}",
              flush=True)
        if not bool((diff <= tol).all()):
            raise AssertionError(f"restitution {k}: card vs CPU differs by "
                                 f"{errs[k]:.3g} beyond its bound")
    active, binds = (float(v) for v in acc)
    share = binds / max(active, 1.0)
    ant = tasks["ant_b4"]
    na = ant.num_envs
    ant_phys = PhysScales.ones(na, dev)._replace(
        restitution=torch.full((na, 1), 0.5, device=dev))
    routes = {"hand": eng.route_for(phys), "ant_b4": ant.engine.route_for(
        ant_phys), "ant_b4_without": ant.engine.route_for(None)}
    phase("restitution", envs=n, bounce_binding_share=f"{share:.6f}",
          active_rows=int(active), binding_rows=int(binds),
          q_err=f"{errs['q']:.3g}", qd_err=f"{errs['qd']:.3g}",
          cpu_seconds=f"{cpu_s:.2f}", route_hand=routes["hand"],
          route_ant_b4=routes["ant_b4"],
          route_ant_b4_without=routes["ant_b4_without"])
    if not share > 0.0:
        raise RuntimeError("no active row's bounce target binds")
    if routes["hand"] != "loop" or routes["ant_b4"] != "loop" or \
            routes["ant_b4_without"] != "b4":
        raise RuntimeError(f"restitution routes {routes}")


@timed
def dextreme_stats(torch, task, dev, tag, steps=10):
    """Dextreme's randomization on the main path: ``steps`` steps of the
    tanh policy after 10 with ``pre_physics`` spied.  ``[rna]``: the share
    of envs whose actions the RNA blends in a step (U < rnaProb and a
    blend weight above 0: the fixed 0.2 at ManualDR, the ADR row's
    ``rna_alpha``, whose initial range is 0, at ADR).  ``[adr]`` (ADR):
    ``adr_npd``, the boundary episodes queued, and the mean |limit shift|
    over the hand dofs and the mean restitution over the bodies that
    reach the engine."""
    pre = task.pre_physics
    acc = torch.zeros(2, dtype=torch.float64, device=dev)

    def spy(state, actions, draws=None):
        d = task.draw_pre() if draws is None else draws
        alpha = task._adr_value(state.task, "rna_alpha")
        acc.add_(torch.stack([((d.rna_u < task.rna_prob) & (alpha > 0))
                              .double().mean(),
                              torch.ones((), device=dev).double()]))
        return pre(state, actions, draws=d)

    act = policy(torch, task, dev)
    st, obs = run_steps(torch, task, task.initial_state(),
                        zero_obs(torch, task, dev), act, 10)
    task.pre_physics = spy
    try:
        st, obs = run_steps(torch, task, st, obs, act, steps)
    finally:
        del task.pre_physics
    blended, n = (float(v) for v in acc)
    phase("rna", phase=tag, envs=task.num_envs, steps=steps,
          blended_share=f"{blended / n:.6f}", rna_prob=task.rna_prob,
          refresh_interval=task.rna_refresh)
    if not task.use_adr:
        if not blended > 0.0:
            raise RuntimeError(f"{tag}: the RNA blended no env")
        return
    a = st.task.adr
    ph = task.update_phys(st, None)
    hd = torch.as_tensor(task.hand_dofs, device=dev)
    phase("adr", phase=tag, envs=task.num_envs,
          adr_npd=f"{float(task.adr.npd(a)):.6f}",
          queued_episodes=int(float(a.perf_cnt.sum())),
          range_updates=int(float(a.num_updates.sum())),
          mean_abs_limit_shift=f"{float(ph.dof_lower_shift[:, hd].abs().mean() + ph.dof_upper_shift[:, hd].abs().mean()) / 2:.6f}",
          mean_restitution=f"{float(ph.restitution.mean()):.6f}",
          route=task.engine.route_for(ph))
    if task.engine.route_for(ph) != "loop":
        raise RuntimeError(f"{tag}: the ADR scales do not take the loop")


def shim_phase(torch, task, dev, steps=5):
    """``[shim]``: ``utils.rlgames_utils.ComplexObsRLGPUEnv`` over a
    Dextreme task: ``steps`` steps of the tanh policy on the policy
    groups, each group's shape, then ``reset_done`` with every fourth env
    flagged: the count of done ids returned."""
    from isaacgymenvs_ma_tpu_torch.utils.rlgames_utils import (
        ComplexObsRLGPUEnv)
    spec = {"obs": {"names": [n for n, _ in task.obs_spec]},
            "states": {"names": ["states"], "space_name": "state_space"},
            "priv": {"names": ["dof_vel", "dof_force", "object_vels",
                               "ft_force_torques"], "concat": False}}
    env = ComplexObsRLGPUEnv(task, spec)
    act = policy(torch, task, dev)
    out = env.reset()
    for _ in range(steps):
        out, rew, reset, extras = env.step(act(out["obs"]))
    shapes = {"obs": tuple(out["obs"].shape),
              "states": tuple(out["states"].shape),
              **{f"priv.{k}": tuple(v.shape)
                 for k, v in out["priv"].items()}}
    flags = (torch.arange(task.num_envs, device=dev) % 4 == 0).to(torch.int32)
    env._state = env._state._replace(reset_buf=flags)
    out2, done = env.reset_done()
    finite = all(bool(torch.isfinite(v).all()) for v in
                 (out["obs"], out["states"], out2["obs"], out2["states"]))
    phase("shim", task=type(task).__name__, envs=task.num_envs,
          steps=steps, groups=json.dumps(shapes).replace(" ", ""),
          reset_done_count=len(done),
          observation_space=json.dumps(env.get_env_info()[
              "observation_space"]).replace(" ", ""))
    if not finite or len(done) != int(flags.sum()) or \
            shapes["obs"] != (task.num_envs, task.num_obs) or \
            (env._state.reset_buf != 0).any():
        raise RuntimeError(f"shim phase: finite {finite}, done {len(done)}, "
                           f"shapes {shapes}")


@timed
def host_waits(torch, task, state, act, obs):
    """Host waits for the card in one ``task.step`` (CUDA sync debug
    mode), by file and line."""
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            task.step(state, act(obs))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(
        "/".join(w.filename.split(os.sep)[-2:]) + f":{w.lineno}"
        for w in syncs)


def check_ma_kernels(torch, dk, ck, task, task_b4, dev, scene):
    """B1-B3 at an MA scene's 8192-env shapes on a state 30 steps in, qdd
    and H^-1 held per env as at FrankaReachMA; B4 on the inputs its route
    hands it 30 steps in with live grabs in a quarter of the envs (contact
    rows with frames and the grab group, held per env)."""
    st, _ = run_steps(torch, task, task.initial_state(),
                      zero_obs(torch, task, dev), policy(torch, task, dev), 30)
    gq = torch.Generator(device=dev).manual_seed(14)
    qd = st.sim.qd + 0.3 * torch.randn(st.sim.qd.shape, generator=gq,
                                       device=dev)
    rep = check_dyn_kernels(torch, dk, task, st.sim.q.t().contiguous(),
                            qd.t().contiguous(), dev, scene, ("qdd", "Hinv"))
    rep["contact_solve"] = check_contact_kernel(
        torch, ck, capture_contact_inputs(torch, ck, task_b4, dev, 30,
                                          grabs=True), scene, True)
    return rep


def check_factory_kernels(torch, dk, sk, task, dev, scene):
    """B1-B3 at a Factory scene's width on a state 10 policy steps in (qd
    nudged by N(0, 0.3)), qdd and H^-1 held per env as at the hands; at
    Screw also B5 on the two stacks its operational-space controller
    inverts there (the (N, 7, 7) arm mass matrices, then J M^-1 J^T +
    1e-6 I), each matrix's bound widened as at the Franka OSC."""
    st, obs = run_steps(torch, task, task.initial_state(),
                        zero_obs(torch, task, dev), policy(torch, task, dev),
                        10)
    gq = torch.Generator(device=dev).manual_seed(19)
    qd = st.sim.qd + 0.3 * torch.randn(st.sim.qd.shape, generator=gq,
                                       device=dev)
    rep = check_dyn_kernels(torch, dk, task, st.sim.q.t().contiguous(),
                            qd.t().contiguous(), dev, scene, ("qdd", "Hinv"))
    if type(task).__name__ == "FactoryTaskNutBoltScrew":
        from isaacgymenvs_ma_tpu_torch.physics import engine as eng_mod
        box = []
        inverse = eng_mod.spd_inverse

        def spy(H):
            box.append(H.clone())
            return inverse(H)

        eng_mod.spd_inverse = spy
        try:
            task.pre_physics(st, policy(torch, task, dev)(obs))
        finally:
            eng_mod.spd_inverse = inverse
        if [tuple(H.shape) for H in box] != [(task.num_envs, 7, 7),
                                              (task.num_envs, 6, 6)]:
            raise RuntimeError(f"Screw's OSC stacks {[H.shape for H in box]}")
        rep["spd_inverse"] = check_spd_kernel(torch, sk, dk, box[0],
                                              f"{scene} osc_mm", True)
        rep["spd_inverse 6"] = check_spd_kernel(torch, sk, dk, box[1],
                                                f"{scene} osc_lambda", True)
    return rep


def factory_engine_phase(torch, task, dev, steps_in=30):
    """``[factory_engine]``: one engine step of FactoryTaskNutBoltPick-128
    on the card and on the CPU twins from the same state (30 policy steps
    in, carrying the warm-start impulses) and control, the Factory engine
    features all on: warm start 0.9, the Franka's body damping, bfloat16
    solver rows (152 rows x nv 15 reach the auto rule), the nut's and
    bolt's SDF grids, mass splitting.  q and qd held at the ground-rule
    bounds (q rtol 2e-4 / atol 2e-5, qd 3e-3: a pair scene) with each
    env's bound widened by four times the CPU step's own move under
    one-ulp noise on q and qd (two nudged runs: the squeezed nut amplifies
    rounding); the impulses' error printed.  Prints the share of the first
    substep's active rows that warm start seeds, the mean |lambda| of the
    impulses carried in, the mean |damping wrench| on the Franka's bodies,
    the rows x nv of the bf16 rule and the route."""
    cpu = type(task)(task.cfg, device="cpu", seed=1,
                     sim_params=task.sim_params)
    st, obs = run_steps(torch, task, task.initial_state(),
                        zero_obs(torch, task, dev), policy(torch, task, dev),
                        steps_in)
    ctrl = task.pre_physics(st, policy(torch, task, dev)(obs))
    eng = task.engine
    normal = eng._normal_targets
    first = {}

    def normal_targets(phi):
        active, b_n = normal(phi)
        first.setdefault("active", active)
        return active, b_n

    eng._normal_targets = normal_targets
    try:
        got, _ = eng.step(st.sim, ctrl)
    finally:
        del eng._normal_targets
    lam_in = st.sim.lam[0]
    active = first["active"]
    seeded = active & (lam_in.abs().amax(-1) > 0)
    share = float(seeded.sum()) / max(float(active.sum()), 1.0)
    body_x, body_q, S, _ = eng.kinematics(st.sim.q)
    franka = torch.as_tensor([i for i, n in enumerate(task.model.body_names)
                              if n.startswith("panda_")], device=dev)
    wrench = eng.damping_wrench(body_x, body_q, S, st.sim.qd)[:, franka]
    to_cpu = lambda x: None if x is None else x.cpu()  # noqa: E731
    cpu_ctrl = ctrl._replace(tau=ctrl.tau.cpu(),
                             pos_target=to_cpu(ctrl.pos_target),
                             vel_target=to_cpu(ctrl.vel_target))
    sim0 = st.sim._replace(q=st.sim.q.cpu(), qd=st.sim.qd.cpu(),
                           lam=tuple(x.cpu() for x in st.sim.lam))
    t0 = time.perf_counter()
    ref, _ = cpu.engine.step(sim0, cpu_ctrl)
    cpu_s = time.perf_counter() - t0
    n = task.num_envs
    gn = torch.Generator().manual_seed(20)
    spread = {"q": torch.zeros(n, dtype=torch.float64),
              "qd": torch.zeros(n, dtype=torch.float64)}
    for _ in range(2):
        nudge = lambda x: x * (1 + (torch.randint(  # noqa: E731
            0, 2, x.shape, generator=gn) * 2 - 1) * 2.0 ** -23)
        alt, _ = cpu.engine.step(sim0._replace(q=nudge(sim0.q),
                                               qd=nudge(sim0.qd)), cpu_ctrl)
        for k in spread:
            d = (getattr(alt, k) - getattr(ref, k)).abs().amax(-1).double()
            spread[k] = torch.maximum(spread[k], d)
    errs = {}
    for k, rtol, atol in (("q", 2e-4, 2e-5), ("qd", 3e-3, 3e-3)):
        a = getattr(got, k).cpu().double()
        b = getattr(ref, k).double()
        tol = atol + rtol * b.abs() + 4.0 * spread[k][:, None]
        diff = (a - b).abs()
        errs[k] = float(diff.max())
        print(f"[check] factory_engine {k} max_abs_err={errs[k]:.3g} "
              f"max_bound={float(tol.max()):.3g} "
              f"median_bound={float(tol.median()):.3g} "
              f"median_env_spread={float(spread[k].median()):.3g}",
              flush=True)
        if not bool((diff <= tol).all()):
            raise AssertionError(f"factory_engine {k}: card vs CPU differs "
                                 f"by {errs[k]:.3g} beyond its bound")
    lam_err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(got.lam, ref.lam))
    rows = eng.n_ground + eng.n_pair_rows
    phase("factory_engine", task=type(task).__name__, envs=n,
          warm_seeded_share=f"{share:.6f}", active_rows=int(active.sum()),
          mean_abs_lam=f"{float(lam_in.abs().mean()):.6g}",
          mean_abs_damping_wrench=f"{float(wrench.abs().mean()):.6g}",
          rows_x_nv=rows * eng.nv, rows_bf16=eng.rows_bf16,
          route=eng.contact_route, q_err=f"{errs['q']:.3g}",
          qd_err=f"{errs['qd']:.3g}", lam_err=f"{lam_err:.3g}",
          cpu_seconds=f"{cpu_s:.2f}")
    if not (share > 0.0 and eng.rows_bf16 and eng.has_body_damping
            and eng.contact_route == "loop"
            and any(p["grid"] is not None for p in eng.pairs)):
        raise RuntimeError("the Factory engine features are not all live")


def factory_stats(task, lift, reads0, steps):
    """``[factory]`` after a Factory main phase: the host reads its two
    data-dependent branches took a step, the epilogues run and (Pick) the
    share of the last epilogue's envs that lifted the nut."""
    fields = dict(phase_task=type(task).__name__,
                  branch_reads_per_step=f"{(task.branch_reads - reads0) / steps:.3f}")
    if lift:
        fields.update(epilogues=len(lift),
                      lift_success_share=f"{float(lift[-1]):.6f}")
    phase("factory", **fields)


# ----------------------------------------------------------------------
# phase 7: glue

# the [dist] run: Ant at 4096 envs (global) over 2 ranks on cuda:0, gloo
DIST_ARGS = ("task=Ant", "num_envs=4096", "multi_gpu=True",
             "sim_device=cuda:0", "log_interval=1", "seed=42")
DIST_TAGS = ("losses/loss", "losses/a_loss", "losses/c_loss", "info/kl",
             "info/lr", "info/entropy", "info/sigma", "Episode/mean_return",
             "Episode/mean_length")
# [dist_sac] / [dist_amp]: AntSAC-4096 and HumanoidAMP-4096 (global) over 2
# ranks on cuda:0 through the train entry point with their configs, 1
# warm-up epoch (AntSAC's holds its 5 seed steps) and 1 timed
DIST_LEARNERS = (
    ("dist_sac", ("task=Ant", "train=AntSAC", f"num_envs={N_ENVS}",
                  "multi_gpu=True", "sim_device=cuda:0", "log_interval=1",
                  "seed=42")),
    ("dist_amp", ("task=HumanoidAMP", f"num_envs={N_ENVS}", "multi_gpu=True",
                  "sim_device=cuda:0", "log_interval=1", "seed=42")))
# the gradient all-reduces of one update: PPO's and AMP's one (AMP's
# discriminator adds one an epoch), SAC's three (critic, actor, temperature)
ALLREDUCES_PER_UPDATE = {"dist_sac": 3}
NORMAL_FRAMES_STEPS = 50
# the card's step held against the CPU twins on its first 512 envs, the
# spread from eight nudged runs (as scripts/record_torch_golden.py's
# ONE_STEP measures AnymalTerrain's)
NORMAL_FRAMES_CPU_ENVS, NORMAL_FRAMES_NUDGES = 512, 8
TRACE_STEPS = 3
PBT_OBJECTIVES = (1.0, 5.0, 9.0)


def train_rank(args):
    """One rank's run of the train entry point with ``args`` (the
    process group joined from torchrun's variables); returns its report:
    epoch seconds, launches, the last epoch's all-reduce and combine ms
    (CUDA events) and bytes, the replicated state's digest, the losses,
    the replay fill, the run dir."""
    import torch
    from isaacgymenvs_ma_tpu_torch import train as train_cli
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import state_digest
    from isaacgymenvs_ma_tpu_torch.physics import KERNEL_WRAPPERS
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    agent = train_cli.launch(list(args))
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in KERNEL_WRAPPERS.items()}
    dp = agent.dist
    losses = {k: float(agent.metrics[k])
              for k in ("loss", "critic_loss", "actor_loss", "disc_loss")
              if k in agent.metrics}
    fill = getattr(agent, "buf_n", getattr(agent, "replay_n", None))
    # the collectives of the last epoch (DataParallel.mark_epoch)
    return dict(
        rank=dp.rank, world=dp.world, backend=dp.backend,
        envs=agent.task.num_envs, epoch_seconds=agent.epoch_seconds,
        launches=launches, allreduce_ms=dp.collect_timings("allreduce"),
        allreduce_bytes=dp.allreduce_bytes,
        combine_ms=dp.collect_timings("combine"),
        combine_bytes=dp.combine_bytes,
        digest=state_digest(agent), losses=losses,
        loss=losses.get("loss", losses.get("critic_loss")), fill=fill,
        run_dir=agent.run_dir)


def dist_worker(args):
    """``--dist-worker``: one rank under torch.distributed.run; prints its
    ``[dist_rank]`` JSON line."""
    sys.path.insert(0, HERE)
    print("[dist_rank] " + json.dumps(train_rank(args)), flush=True)
    return 0


def nccl_world_one(epochs, experiment):
    """One rank over NCCL (world 1) in this process: the train entry point
    under torchrun's variables, then the process group destroyed."""
    import torch.distributed as dist
    from isaacgymenvs_ma_tpu_torch.parallel.dryrun import free_port
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return train_rank([*DIST_ARGS, "dist_backend=nccl",
                           f"max_iterations={epochs}",
                           f"experiment={experiment}"])
    finally:
        dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@timed
def run_dist(nproc, backend, epochs, experiment, args=DIST_ARGS):
    """The [dist_rank] dicts of a torch.distributed.run launch of the
    train entry point with ``args``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.join(HERE, "chip_smoke.py"),
           "--dist-worker", *args, f"dist_backend={backend}",
           f"max_iterations={epochs}", f"experiment={experiment}"]
    out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"torch.distributed.run ({nproc} x {backend}) "
                           f"failed:\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-6000:]}")
    ranks = [json.loads(line.split(" ", 1)[1])
             for line in out.stdout.splitlines()
             if line.startswith("[dist_rank] ")]
    if sorted(r["rank"] for r in ranks) != list(range(nproc)):
        raise RuntimeError(f"ranks reported: {ranks}")
    return sorted(ranks, key=lambda r: r["rank"])


def dist_learner_phase(torch, task):
    """``[dist_sac]`` and ``[dist_amp]``: each of DIST_LEARNERS over 2
    gloo ranks on cuda:0, each rank's epoch seconds, B1-B3 launches,
    all-reduce and combine ms (CUDA events), replay fill, losses and
    digest, failing unless the digests agree, the losses are finite and
    each rank launched B1-B3; then the 2-rank SAC checkpoint resumed in
    this process on ``task`` (Ant-4096), bit-equal with its ring."""
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.sac import SACAgent
    runs = {}
    for tag, args in DIST_LEARNERS:
        t0 = time.perf_counter()
        ranks = run_dist(2, "gloo", 2, tag, args)
        launch_s = time.perf_counter() - t0
        calls = ALLREDUCES_PER_UPDATE.get(tag, 1)
        for r in ranks:
            ms, cms = r["allreduce_ms"], r["combine_ms"]
            per_update = [sum(ms[i: i + calls])
                          for i in range(0, len(ms) - calls + 1, calls)]
            phase(tag, rank=r["rank"], world=r["world"],
                  backend=r["backend"], envs_per_rank=r["envs"],
                  warmup_epoch_seconds=f"{r['epoch_seconds'][0]:.4f}",
                  epoch_seconds=f"{r['epoch_seconds'][-1]:.4f}",
                  launches=json.dumps(r["launches"]).replace(" ", ""),
                  allreduce_ms_per_update=(
                      f"{statistics.median(per_update):.4f}" if per_update
                      else "not_measured"),
                  allreduces=len(ms),
                  allreduce_bytes_per_epoch=r["allreduce_bytes"],
                  combine_ms=(f"{statistics.median(cms):.4f}" if cms
                              else "not_measured"),
                  combines=len(cms),
                  combine_bytes_per_epoch=r["combine_bytes"],
                  fill=r["fill"],
                  losses=json.dumps({k: float(f"{v:.6g}") for k, v in
                                     r["losses"].items()}).replace(" ", ""),
                  digest=r["digest"][:16], launch_seconds=f"{launch_s:.1f}")
            check_launches(r["launches"], DYN, ("contact_solve",
                                                "spd_inverse"),
                           f"{tag} rank {r['rank']}")
            if not r["losses"] or not all(math.isfinite(v) for v in
                                          r["losses"].values()):
                raise RuntimeError(f"{tag} rank {r['rank']} losses "
                                   f"{r['losses']}")
            if not ms or not cms:
                raise RuntimeError(f"{tag} rank {r['rank']} reduced nothing "
                                   "on the card")
        if len({r["digest"] for r in ranks}) != 1:
            raise RuntimeError(f"{tag} digests differ: "
                               f"{[r['digest'] for r in ranks]}")
        runs[tag] = ranks
    # the 2-rank SAC checkpoint resumed in one process
    run_dir = os.path.join(HERE, runs["dist_sac"][0]["run_dir"])
    path = os.path.join(run_dir, "nn", "dist_sac.pth")
    saved, _, meta = ckpt.load_checkpoint(path)
    agent = SACAgent(task, train_default_config("AntSAC"), seed=42)
    agent.init()
    ckpt.load_agent(path, agent, task)
    sd = agent.state_dict()
    eq = lambda a, b: torch.equal(a.cpu(), b.cpu())  # noqa: E731
    same = all(eq(sd[w][k], v) for w in ("actor", "critic", "target")
               for k, v in saved[w].items())
    same &= all(eq(sd[w][k][f], v[f]) for w in ("actor_optim",
                                               "critic_optim")
                for k, v in saved[w].items() for f in ("exp_avg",
                                                       "exp_avg_sq"))
    same &= all(eq(sd["buffer"][k], v) for k, v in saved["buffer"].items())
    same &= all(eq(sd["env_state"][k], v)
                for k, v in saved["env_state"].items())
    same &= eq(sd["log_alpha"], saved["log_alpha"])
    same &= eq(sd["last_obs"], saved["last_obs"])
    rows = int(saved["buffer"]["obs"].shape[0])
    if not same or meta["world"] != 2 or agent.buf_n != saved["buf_n"] or \
            rows != 16 * N_ENVS or \
            saved["env_state"]["sim.q"].shape[0] != N_ENVS:
        raise RuntimeError(f"2-rank SAC checkpoint resumed unlike saved "
                           f"({meta}, ring rows {rows})")
    phase("dist_sac", resumed_in_one_process=True,
          checkpoint_world=meta["world"], ring_rows=rows,
          buf_n=agent.buf_n, bit_equal=same)
    del agent, sd
    torch.cuda.empty_cache()
    return runs


def trace_worker():
    """``--trace-worker``: ``profiling.trace`` around TRACE_STEPS Ant-4096
    steps in a fresh process; prints a ``[trace_names]`` JSON line with
    the annotate names and kernel names the exported trace holds and the
    worker's seconds."""
    t0 = time.perf_counter()
    import torch
    sys.path.insert(0, HERE)
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.utils import profiling
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    dev = torch.device("cuda", 0)
    task = registry.create_task("Ant", deep_merge(
        registry.task_default_config("Ant"), {"env": {"numEnvs": N_ENVS}}),
        seed=1, device=dev)
    act = policy(torch, task, dev)
    st, obs = run_steps(torch, task, task.initial_state(),
                        zero_obs(torch, task, dev), act, 2)
    logdir = os.path.join(HERE, "runs", "trace_ant")
    with profiling.trace(logdir) as prof:
        for i in range(TRACE_STEPS):
            with profiling.annotate(f"ant_step_{i}"):
                with profiling.annotate("policy"):
                    a = act(obs)
                st, res = task.step(st, a)
                obs = res.obs
    events = json.load(open(prof.trace_path))["traceEvents"]
    kernels = collections.Counter(
        e["name"] for e in events if e.get("cat") == "kernel")
    names = sorted({e.get("name") for e in events
                    if str(e.get("name", "")).startswith(("ant_step_",
                                                          "policy"))})
    print("[trace_names] " + json.dumps(dict(
        annotate=names, kernels=dict(kernels), path=prof.trace_path,
        events=len(events), seconds=time.perf_counter() - t0)), flush=True)
    return 0


def dryrun_worker():
    """``--dryrun-worker``: ``dryrun_multiproc`` over 2 gloo ranks on
    cuda:0; prints a ``[dryrun_legs]`` JSON line: its legs and seconds."""
    t0 = time.perf_counter()
    sys.path.insert(0, HERE)
    from isaacgymenvs_ma_tpu_torch.parallel.dryrun import dryrun_multiproc
    legs = dryrun_multiproc(2, device="cuda:0", backend="gloo")
    print("[dryrun_legs] " + json.dumps(dict(
        legs=legs, seconds=time.perf_counter() - t0)), flush=True)
    return 0


def start_workers():
    """Phase 7's ``[dryrun]`` and ``[trace]`` workers, each a fresh process
    in a session of its own (``stop_workers`` ends it with its children),
    its output under runs/smoke_workers/.  ``main`` starts them after
    phase 3, so that they run beside phases 4-4b, which time nothing on
    the card, and phase 7 reads them."""
    out_dir = os.path.join(HERE, "runs", "smoke_workers")
    os.makedirs(out_dir, exist_ok=True)
    workers = {}
    for flag in ("--dryrun-worker", "--trace-worker"):
        out, err = (os.path.join(out_dir, flag.strip("-") + ext)
                    for ext in (".out", ".err"))
        with open(out, "w") as fo, open(err, "w") as fe:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"), flag],
                cwd=HERE, stdout=fo, stderr=fe, start_new_session=True)
        workers[flag] = (proc, out, err)
    atexit.register(stop_workers, workers)
    return workers


def stop_workers(workers):
    for proc, _, _ in workers.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def finish_worker(workers, flag, tag, timeout=600):
    """Wait for a worker of ``start_workers`` and return its ``[tag]``
    JSON line, echoing its other lines; fails if it failed or printed no
    such line."""
    proc, out_path, err_path = workers[flag]
    try:
        proc.wait(timeout=timeout)
    finally:
        stop_workers({flag: workers[flag]})
    out, err = open(out_path).read(), open(err_path).read()
    lines = [ln for ln in out.splitlines() if ln.startswith(f"[{tag}] ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{flag} failed ({proc.returncode}):\n"
                           f"{out[-3000:]}\n{err[-3000:]}")
    for ln in out.splitlines():
        if not ln.startswith(f"[{tag}] "):
            print(ln, flush=True)
    return json.loads(lines[0].split(" ", 1)[1])


@timed
def normal_frames_phase(torch, np, wrappers, dev):
    """``[normal_frames]``: AnymalTerrain-4096 with terrain_normal_frames
    and the contact kernel requested; returns its main-path launches."""
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    cfg = deep_merge(registry.task_default_config("AnymalTerrain"),
                     {"env": {"numEnvs": N_ENVS}})
    params = parse_sim_params(cfg["sim"])._replace(
        use_contact_kernel=True, terrain_normal_frames=True)
    cls = registry.task_class("AnymalTerrain")
    card = cls(cfg, device=dev, seed=1, sim_params=params)
    eng = card.engine
    route = eng.route_for(None, terrain=card.terrain)
    if route != "loop" or eng.route_for(None) != "b4":
        raise RuntimeError(f"normal frames route {route}")
    steps = NORMAL_FRAMES_STEPS
    # 10 warm-up steps, as since the phase began: their reset draws fix
    # the state the CPU twins hold below (ROADMAP C8: from the state a
    # 3-step warm-up leaves, one env of 512 exceeds its bound)
    r = main_phase(torch, wrappers, card, dev, steps,
                   ("fk_motion", "dyn_forward"),
                   ("dyn_cached", "contact_solve", "spd_inverse"), warmup=10)
    n_b2 = r["launches"]["dyn_forward"]
    if n_b2 < 4 * steps:
        raise RuntimeError(f"B2 launched {n_b2} times in {steps} steps of "
                           "4 substeps")
    # one engine step from a state 30 steps in, card against CPU twins on
    # the first NORMAL_FRAMES_CPU_ENVS envs (the step is per env)
    act = policy(torch, card, dev)
    st, obs = run_steps(torch, card, card.initial_state(),
                        zero_obs(torch, card, dev), act, 30)
    ctrl = card.pre_physics(st, act(obs))
    got, _ = eng.step(st.sim, ctrl, terrain=card.terrain)
    n = min(NORMAL_FRAMES_CPU_ENVS, card.num_envs)
    cpu = cls(deep_merge(cfg, {"env": {"numEnvs": n}}), device="cpu",
              seed=1, sim_params=params)
    cpu_ctrl = ctrl._replace(**{k: getattr(ctrl, k)[:n].cpu() for k in (
        "tau", "pos_target", "vel_target", "f_ext")
        if getattr(ctrl, k) is not None})
    sim0 = st.sim._replace(q=st.sim.q[:n].cpu(), qd=st.sim.qd[:n].cpu())
    t0 = time.perf_counter()
    ref, _ = cpu.engine.step(sim0, cpu_ctrl, terrain=cpu.terrain)
    cpu_s = time.perf_counter() - t0
    gn = torch.Generator().manual_seed(17)
    spread = {"q": torch.zeros(n, dtype=torch.float64),
              "qd": torch.zeros(n, dtype=torch.float64)}
    for _ in range(NORMAL_FRAMES_NUDGES):
        nudge = lambda x: x * (1 + (torch.randint(  # noqa: E731
            0, 2, x.shape, generator=gn) * 2 - 1) * 2.0 ** -23)
        alt, _ = cpu.engine.step(sim0._replace(q=nudge(sim0.q),
                                               qd=nudge(sim0.qd)),
                                 cpu_ctrl, terrain=cpu.terrain)
        for k in spread:
            d = (getattr(alt, k) - getattr(ref, k)).abs().amax(-1).double()
            spread[k] = torch.maximum(spread[k], d)
    # held at the ground-rule bounds widened per env by four times the CPU
    # step's own one-ulp spread, as [restitution] holds its step; the
    # robots stand 30-180 m from the world origin, where one ulp moves a
    # few envs' step far more than two nudged runs see (ROADMAP C8), so
    # the spread comes from eight
    errs, beyond_envs = {}, {}
    for k, rtol, atol in (("q", 2e-4, 2e-5), ("qd", 2e-3, 2e-3)):
        a = getattr(got, k)[:n].cpu().double()
        b = getattr(ref, k).double()
        diff = (a - b).abs()
        tol = atol + rtol * b.abs()
        excess = torch.clamp(diff - 4.0 * spread[k][:, None] - tol,
                             min=0.0).amax(-1)
        errs[k] = float(diff.max())
        beyond_envs[k] = int((excess > 0).sum())
        med = float(excess.median())
        print(f"[check] normal_frames {k} max_abs_err={errs[k]:.3g} "
              f"median_env_excess={med:.3g} "
              f"max_env_excess={float(excess.max()):.3g} "
              f"envs_beyond_own_bound={beyond_envs[k]}/{n} "
              f"median_env_spread={float(spread[k].median()):.3g}",
              flush=True)
        if beyond_envs[k] or not bool(torch.isfinite(a).all()):
            raise AssertionError(
                f"normal_frames {k}: {beyond_envs[k]} envs differ beyond "
                f"their bounds (largest excess {float(excess.max()):.3g})")
    # the terrain rows' normals at that state
    body_x, body_q, _, _ = eng.kinematics(st.sim.q)
    p = eng._contact_points(body_x, body_q)
    gz, nrm = card.terrain.height_and_normal(p[..., 0], p[..., 1])
    tilted = nrm[..., 2] < math.cos(math.radians(10.0))
    active = ((p[..., 2] - gz) * nrm[..., 2] - eng._ground_radii()
              < eng.params.contact_margin)
    share = float(tilted.double().mean())
    act_share = float((tilted & active).double().sum()
                      / active.double().sum().clamp(min=1.0))
    phase("normal_frames", envs=card.num_envs, steps=steps, route=route,
          seconds=f"{r['seconds']:.4f}",
          env_steps_per_s=f"{card.num_envs * steps / r['seconds']:.1f}",
          cpu_envs=n, envs_beyond_own_bound=json.dumps(
              beyond_envs).replace(" ", ""),
          launches=json.dumps(r["launches"]).replace(" ", ""),
          q_err=f"{errs['q']:.3g}", qd_err=f"{errs['qd']:.3g}",
          cpu_seconds=f"{cpu_s:.2f}",
          tilted_over_10deg_share=f"{share:.6f}",
          tilted_share_of_active_rows=f"{act_share:.6f}",
          rows=int(tilted.numel()), active_rows=int(active.sum()))
    return r["launches"]


@timed
def pbt_phase(torch, wrappers, dev):
    """``[pbt]``: three Cartpole-512 members on the card, one observer
    cycle; returns their launches."""
    import random
    import shutil
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu_torch.pbt.pbt import PbtAlgoObserver
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    ws = os.path.join(HERE, "runs", "pbt_chip")
    shutil.rmtree(ws, ignore_errors=True)
    tcfg = train_default_config("Cartpole")
    pcfg = {"enabled": True, "num_policies": len(PBT_OBJECTIVES),
            "workspace": ws, "interval_steps": 1, "start_after": 0,
            "initial_delay": 0, "replace_fraction_worst": 0.34,
            "replace_fraction_best": 0.34, "replace_threshold_frac_std": 0.1,
            "params": {"learning_rate": 3e-4, "gamma": 0.99}}
    for w in wrappers.values():
        w.launches = 0
    members = []
    for i, obj in enumerate(PBT_OBJECTIVES):
        task = registry.create_task("Cartpole", deep_merge(
            registry.task_default_config("Cartpole"),
            {"env": {"numEnvs": 512}}), seed=i + 1, device=dev)
        agent = PPOAgent(task, tcfg, seed=i + 1)
        agent.init()
        m = agent.train_epoch()

        def save(path, agent=agent, task=task):
            ckpt.save_agent(path, agent, task)

        def restore(path, agent=agent, task=task):
            ckpt.load_agent(path, agent, task)
        obs = PbtAlgoObserver({"pbt": dict(pcfg, policy_idx=i)}, tcfg, save,
                              restore)
        decisions = []
        obs._restart = lambda c, p, d=decisions: d.append((c, p))
        obs.after_steps(1, agent.frames, {"true_objective": obj,
                                          "mean_return": float(
                                              m["mean_return"])})
        members.append((agent, obs, decisions))
    launches = {name: w.launches for name, w in wrappers.items()}
    check_launches(launches, DYN, ("contact_solve", "spd_inverse"), "pbt")
    written = sorted(f for d in os.listdir(ws) for f in os.listdir(
        os.path.join(ws, d)))
    if len(written) != 2 * len(PBT_OBJECTIVES):
        raise RuntimeError(f"pbt workspace holds {written}")
    # the worst member's second interval: its decision on the card's
    # checkpoints, and a CPU observer's on a copy of the same workspace
    agent0, obs0, dec0 = members[0]
    frames2 = 2 * agent0.frames
    copy_ws = ws + "_cpu"
    shutil.rmtree(copy_ws, ignore_errors=True)
    shutil.copytree(ws, copy_ws)
    cpu_obs = PbtAlgoObserver({"pbt": dict(pcfg, policy_idx=0,
                                           workspace=copy_ws)}, tcfg,
                              lambda path: open(path, "w").write("x"),
                              lambda path: None)
    cpu_dec = []
    cpu_obs._restart = lambda c, p: cpu_dec.append((c, p))
    cpu_obs.first_frames, cpu_obs.last_interval = (obs0.first_frames,
                                                   obs0.last_interval)
    random.seed(5)
    cpu_obs.after_steps(2, frames2, {"true_objective": PBT_OBJECTIVES[0]})
    random.seed(5)
    obs0.after_steps(2, frames2, {"true_objective": PBT_OBJECTIVES[0]})
    # (the copied metas name the donors' checkpoints in the workspace)
    if not dec0 or dec0 != cpu_dec:
        raise RuntimeError(f"pbt decisions card {dec0} CPU {cpu_dec}")
    donor_ckpt = dec0[0][0]
    donor_idx = int(os.path.basename(os.path.dirname(donor_ckpt))[7:])
    donor = members[donor_idx][0]
    obs0.restore_fn(donor_ckpt)
    equal = all(torch.equal(p, q) for p, q in zip(
        donor.net.parameters(), agent0.net.parameters()))
    if not equal:
        raise RuntimeError("restore_fn left parameters unlike the donor's")
    phase("pbt", members=len(members), envs=512,
          checkpoints_and_metas=len(written), donor=donor_idx,
          mutated=json.dumps(dec0[0][1]).replace(" ", ""),
          decision_equals_cpu=True, restored_bit_equal=equal,
          launches=json.dumps(launches).replace(" ", ""))
    return launches


def glue_phase(torch, np, wrappers, tasks, dev, workers=None):
    """Phase 7; returns the in-process launches by scene and the
    normal-frames run's.  ``workers``: those of ``start_workers``, started
    here if None."""
    from isaacgymenvs_ma_tpu_torch import train as train_cli
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu_torch.utils.observers import read_events
    workers = workers or start_workers()
    launches = collections.Counter()
    # [dist]: 2 ranks over gloo on cuda:0, then NCCL at world 1
    t0 = time.perf_counter()
    ranks = run_dist(2, "gloo", 2, "dist_ant")
    dist_s = time.perf_counter() - t0
    for r in ranks:
        ms = r["allreduce_ms"]
        phase("dist", rank=r["rank"], world=r["world"], backend=r["backend"],
              envs_per_rank=r["envs"],
              warmup_epoch_seconds=f"{r['epoch_seconds'][0]:.4f}",
              epoch_seconds=f"{r['epoch_seconds'][-1]:.4f}",
              launches=json.dumps(r["launches"]).replace(" ", ""),
              allreduce_ms_per_update=(
                  f"{statistics.median(ms):.4f}" if ms else "not_measured"),
              allreduce_updates=len(ms),
              allreduce_bytes=r["allreduce_bytes"] // max(len(ms), 1),
              loss=f"{r['loss']:.6g}", digest=r["digest"][:16],
              launch_seconds=f"{dist_s:.1f}")
        check_launches(r["launches"], DYN, ("contact_solve", "spd_inverse"),
                       f"dist rank {r['rank']}")
        if not math.isfinite(r["loss"]):
            raise RuntimeError(f"dist rank {r['rank']} loss {r['loss']}")
    if len({r["digest"] for r in ranks}) != 1:
        raise RuntimeError(f"dist digests differ: {[r['digest'] for r in ranks]}")
    t0 = time.perf_counter()
    nccl = nccl_world_one(1, "dist_nccl")
    launches.update(nccl["launches"])
    nccl_s = time.perf_counter() - t0
    ms = nccl["allreduce_ms"]
    phase("dist", rank=0, world=1, backend=nccl["backend"],
          envs_per_rank=nccl["envs"],
          epoch_seconds=f"{nccl['epoch_seconds'][-1]:.4f}",
          launches=json.dumps(nccl["launches"]).replace(" ", ""),
          allreduce_ms_per_update=(f"{statistics.median(ms):.4f}" if ms
                                   else "not_measured"),
          allreduce_updates=len(ms), allreduce_bytes=(
              nccl["allreduce_bytes"] // max(len(ms), 1)),
          loss=f"{nccl['loss']:.6g}", seconds=f"{nccl_s:.1f}")
    check_launches(nccl["launches"], DYN, ("contact_solve", "spd_inverse"),
                   "dist nccl")
    if nccl["backend"] != "nccl" or not ms:
        raise RuntimeError("the NCCL rank reduced nothing on the card")
    # the 2-rank checkpoint resumed in one process
    run_dir = os.path.join(HERE, ranks[0]["run_dir"])
    path = os.path.join(run_dir, "nn", "dist_ant.pth")
    saved, _, meta = ckpt.load_checkpoint(path)
    task = tasks["ant"]
    agent = PPOAgent(task, train_default_config("Ant"), seed=42)
    agent.init()
    ckpt.load_agent(path, agent, task)
    sd = agent.state_dict()
    same = all(torch.equal(sd["net"][k].cpu(), v)
               for k, v in saved["net"].items())
    same &= all(torch.equal(sd["env_state"][k].cpu(), v)
                for k, v in saved["env_state"].items())
    same &= all(torch.equal(sd["optim"][k][f].cpu(), v[f].cpu())
                for k, v in saved["optim"].items()
                for f in ("exp_avg", "exp_avg_sq"))
    same &= torch.equal(sd["last_obs"].cpu(), saved["last_obs"])
    if not same or meta["world"] != 2 or \
            saved["env_state"]["sim.q"].shape[0] != N_ENVS:
        raise RuntimeError(f"2-rank checkpoint resumed unlike saved ({meta})")
    phase("dist", resumed_in_one_process=True, checkpoint_world=meta["world"],
          checkpoint_envs=saved["env_state"]["sim.q"].shape[0],
          bit_equal=same)
    # [dist_sac], [dist_amp]
    t0 = time.perf_counter()
    dist_learner_phase(torch, task)
    phase("dist_learners", seconds=f"{time.perf_counter() - t0:.1f}")
    # [dryrun], from its worker
    dry = finish_worker(workers, "--dryrun-worker", "dryrun_legs")
    for r in dry["legs"]:
        phase("dryrun", task=r["task"], ranks=r["ranks"], envs=r["envs"],
              loss=f"{r['loss']:.6g}", kl=f"{r['kl']:.6g}",
              digest=r["digest"][:16], seconds=f"{dry['seconds']:.1f}")
    # [summaries] of the [dist] run
    sdir = os.path.join(run_dir, "summaries")
    files = [f for f in os.listdir(sdir) if "tfevents" in f]
    events = [e for f in files for e in read_events(os.path.join(sdir, f))]
    tags = collections.defaultdict(list)
    for e in events:
        for tag, _ in e["scalars"]:
            tags[tag].append(e["step"])
    want_steps = [N_ENVS * 16 * e for e in (1, 2)]
    missing = [t for t in DIST_TAGS if tags.get(t) != want_steps]
    snap = open(os.path.join(run_dir, "config.yaml")).read()
    if len(files) != 1 or missing or f"numEnvs: {N_ENVS}" not in snap:
        raise RuntimeError(f"summaries {files} missing {missing}")
    phase("summaries", files=len(files), events=len(events),
          records_crc_checked=len(events), tags=len(tags),
          steps=json.dumps(want_steps).replace(" ", ""),
          expected_tags=",".join(DIST_TAGS),
          config_yaml_bytes=len(snap))
    # [normal_frames]
    t0 = time.perf_counter()
    nf = normal_frames_phase(torch, np, wrappers, dev)
    phase("normal_frames", seconds_total=f"{time.perf_counter() - t0:.1f}")
    launches.update(nf)
    # [video] through the entry point
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    agent = train_cli.launch(["task=Ant", f"num_envs={N_ENVS}",
                              "max_iterations=1", "capture_video=True",
                              "capture_video_freq=16",
                              "capture_video_len=8", "sim_device=cuda:0",
                              "log_interval=1", "experiment=video_ant"])
    vl = {name: w.launches for name, w in wrappers.items()}
    check_launches(vl, DYN, ("contact_solve", "spd_inverse"), "video")
    launches.update(vl)
    vdir = os.path.join(HERE, agent.run_dir, "videos")
    (clip,) = os.listdir(vdir)
    if not os.path.isdir(os.path.join(vdir, clip)):
        raise RuntimeError(f"video {clip}: PNG frames expected (imageio "
                           "is not on the card's machine)")
    frames = sorted(os.listdir(os.path.join(vdir, clip)))
    data = [open(os.path.join(vdir, clip, f), "rb").read() for f in frames]
    differ = all(a != b for a, b in zip(data, data[1:]))
    if len(frames) != 8 or not differ:
        raise RuntimeError(f"video frames {frames} (consecutive differ: "
                           f"{differ})")
    phase("video", envs=N_ENVS, clip=clip, frames=len(frames),
          format=os.path.splitext(frames[0])[1][1:],
          consecutive_differ=differ,
          launches=json.dumps(vl).replace(" ", ""),
          seconds=f"{time.perf_counter() - t0:.1f}")
    # [trace], from its worker (a fresh process)
    tr = finish_worker(workers, "--trace-worker", "trace_names")
    want = [f"ant_step_{i}" for i in range(TRACE_STEPS)] + ["policy"]
    found = {k: sum(c for n, c in tr["kernels"].items() if k in n)
             for k in DYN}
    if sorted(tr["annotate"]) != sorted(want) or not all(found.values()):
        raise RuntimeError(f"trace holds {tr['annotate']} and kernels "
                           f"{tr['kernels']}")
    phase("trace", steps=TRACE_STEPS, events=tr["events"],
          annotate=",".join(tr["annotate"]),
          kernels=json.dumps(found).replace(" ", ""),
          path=os.path.relpath(tr["path"], HERE),
          seconds=f"{tr['seconds']:.1f}")
    # [pbt]
    t0 = time.perf_counter()
    launches.update(pbt_phase(torch, wrappers, dev))
    phase("pbt", seconds=f"{time.perf_counter() - t0:.1f}")
    return launches, nf


def main():
    import torch
    if "--dist-worker" in sys.argv[1:2]:
        return dist_worker(sys.argv[2:])
    if "--trace-worker" in sys.argv[1:2]:
        return trace_worker()
    if "--dryrun-worker" in sys.argv[1:2]:
        return dryrun_worker()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device and does not fall back to the CPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import isaacgymenvs_ma_tpu_torch as port
    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != HERE:
        raise RuntimeError(f"isaacgymenvs_ma_tpu_torch imported from "
                           f"{port.__file__}, not from this checkout")
    from isaacgymenvs_ma_tpu_torch.physics import KERNEL_WRAPPERS, _build
    from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck
    from isaacgymenvs_ma_tpu_torch.physics import controllers as ctl
    from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as dk
    from isaacgymenvs_ma_tpu_torch.physics import spd_kernel as sk
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
    from isaacgymenvs_ma_tpu_torch.utils import parity
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

    clock = PhaseClock()
    # ---- 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=repr(kind), count=torch.cuda.device_count())
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", 0)

    def make(name, kernel_route, n_envs):
        cls, task_cfg, _ = parity.TASKS.get(name) or (
            registry.task_class(name), registry.task_default_config(name),
            None)
        cfg = deep_merge(task_cfg, {"env": {"numEnvs": n_envs}})
        params = parse_sim_params(cfg["sim"])._replace(
            use_contact_kernel=kernel_route)
        return cls(cfg, device=dev, seed=1, sim_params=params)

    clock.lap("device")
    if "--glue-only" in sys.argv[1:]:
        # phase 7 alone: the scenes it runs, built in parallel
        tasks = {"ant": make("Ant", False, N_ENVS)}
        plans = [("ant", tasks["ant"].engine.plan)]
        for name, n in (("Cartpole", 512), ("AnymalTerrain", 8),
                        ("FrankaReachMA", 8), ("ShadowHand", 8),
                        ("HumanoidAMP", 8)):
            plans.append((name, make(name, False, n).engine.plan))
        build_all(_build, plans)
        clock.lap("build")
        glue_phase(torch, np, KERNEL_WRAPPERS, tasks, dev)
        clock.lap("glue")
        return 0
    # ---- 2. build: every distinct kernel and header, compilers in parallel
    tasks = {tag: make(name, route, n) for tag, name, route, _, n in PHASES}
    tasks.update({tag: make(name, True, n) for tag, name, n in TRAIN_ONLY})
    tasks.update({tag: make(name, False, n) for tag, name, n in SAC_TASKS})
    grab = synthetic_grab_call(torch, np, ck, dev)
    dyn_scenes = ("ant", "ball_balance", "franka_reach_ma", "cartpole",
                  "franka_collect_ma", "franka_ppma", "franka_combine_ma",
                  *LOCO_SCENES, "anymal_terrain", *SINGLE_SCENES,
                  "franka_cube_stack2", *HAND_SCENES, *FACTORY_SCENES,
                  "factory_place", "factory_insertion",
                  "industreal_gears_insert", "humanoid_amp_hands",
                  *(tag for tag, _, _ in TRAIN_ONLY + SAC_TASKS))
    b4_scenes = ("ant", "ball_balance", "franka_reach_ma", *GRAB_SCENES,
                 "humanoid", "anymal", "anymal_terrain", "ingenuity",
                 *SINGLE_SCENES, "humanoid_amp")
    build_all(_build, [
        *((scene, tasks[scene].engine.plan) for scene in dyn_scenes),
        *((scene, tasks[scene + "_b4"].engine.cplan) for scene in b4_scenes),
        ("grab", grab[0]),
        *((f"spd n={n}", sk.get_plan(n))
          for n in sorted({6, *(n for _, n, _ in SPD_SEEDED)}))])

    clock.lap("build")
    # ---- 3. kernels against their twins
    q_np, qd_np = generic_ant_state(np, tasks["ant"], seed=7)
    to_bl = lambda x: torch.as_tensor(x, device=dev).t().contiguous()  # noqa: E731
    # Ant keeps fixed bounds; BallBalance's fast-rolling balls and its
    # friction box make float32 alone move the twin: held per env (hold)
    report = {"ant": check_dyn_kernels(torch, dk, tasks["ant"], to_bl(q_np),
                                       to_bl(qd_np), dev, "ant")}
    bb = tasks["ball_balance"]
    st, _ = run_steps(torch, bb, bb.initial_state(), zero_obs(torch, bb, dev),
                      policy(torch, bb, dev), 30)
    gq = torch.Generator(device=dev).manual_seed(11)
    qd_bb = st.sim.qd + torch.randn(st.sim.qd.shape, generator=gq, device=dev)
    report["ball_balance"] = check_dyn_kernels(
        torch, dk, bb, st.sim.q.t().contiguous(), qd_bb.t().contiguous(), dev,
        "ball_balance", ("qdd",))
    for scene, widen in (("ant", False), ("ball_balance", True)):
        call = capture_contact_inputs(torch, ck, tasks[scene + "_b4"], dev, 30)
        report[scene]["contact_solve"] = check_contact_kernel(
            torch, ck, call, scene, widen)
    report["grab"] = {"contact_solve": check_contact_kernel(
        torch, ck, grab, "grab", False)}
    report["franka_reach_ma"], spd_extra = check_franka_kernels(
        torch, dk, sk, ck, ctl, tasks["franka_reach_ma"],
        tasks["franka_reach_ma_b4"], dev)
    report["franka_reach_ma spd"] = spd_extra
    cp = tasks["cartpole"]
    st, _ = run_steps(torch, cp, cp.initial_state(), zero_obs(torch, cp, dev),
                      policy(torch, cp, dev), 30)
    gq = torch.Generator(device=dev).manual_seed(12)
    qd_cp = st.sim.qd + torch.randn(st.sim.qd.shape, generator=gq, device=dev)
    report["cartpole"] = check_dyn_kernels(
        torch, dk, cp, st.sim.q.t().contiguous(), qd_cp.t().contiguous(), dev,
        "cartpole")
    for scene in GRAB_SCENES:
        report[scene] = check_ma_kernels(torch, dk, ck, tasks[scene],
                                         tasks[scene + "_b4"], dev, scene)
    for scene in LOCO_SCENES:
        report[scene] = check_loco_kernels(
            torch, dk, ck, tasks[scene], tasks.get(LOCO_B4.get(scene)), dev,
            scene)
    for scene in SINGLE_SCENES:
        report[scene], extra = check_single_kernels(
            torch, dk, sk, ck, ctl, tasks[scene], tasks[scene + "_b4"], dev,
            scene, parity)
        spd_extra.update({f"{scene} {k}": v for k, v in extra.items()})
    for scene in HAND_SCENES:
        report[scene] = check_hand_kernels(torch, dk, tasks[scene], dev,
                                           scene)
    for scene in FACTORY_SCENES:
        report[scene] = check_factory_kernels(torch, dk, sk, tasks[scene],
                                              dev, scene)
        if "spd_inverse" in report[scene]:
            spd_extra[f"{scene} osc_lambda"] = report[scene].pop(
                "spd_inverse 6")
    # queue B item 7: B2 with per-env mass and shape scales and B3 with the
    # gravity wrench they scale, at Ant-4096 (seeded scales in the ranges of
    # tests/test_dyn_kernel.py:86) and at Trifinger-16384 (the scales its
    # randomizer draws, on a state 30 steps in)
    gs = np.random.default_rng(9)
    ant_t = tasks["ant"]
    nb = ant_t.engine.nb
    t_ = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)  # noqa: E731
    check_scaled_dyn(torch, dk, ant_t, to_bl(q_np), to_bl(qd_np),
                     t_(gs.uniform(0.6, 1.5, (N_ENVS, nb))),
                     t_(gs.uniform(0.7, 1.4, (N_ENVS, nb, 3))), dev, "ant",
                     False)
    for scene in SCALED_SCENES:
        t = tasks[scene]
        st, _ = run_steps(torch, t, t.initial_state(),
                          zero_obs(torch, t, dev), policy(torch, t, dev), 30)
        check_scaled_dyn(torch, dk, t, st.sim.q.t().contiguous(),
                         st.sim.qd.t().contiguous(), st.phys.mass,
                         st.phys.shape, dev, scene, True)
    for scene, r in report.items():
        for name, e in r.items():
            b_ms, b_by = bound(e["bytes"], e["flops"])
            lib = ("" if e.get("library_ms") is None
                   else f" library_ms={e['library_ms']:.5f}")
            phase("kernel", scene=scene, name=name,
                  max_abs_err=f"{e['max_abs_err']:.3g}", ms=f"{e['ms']:.5f}",
                  plain_ms=f"{e['plain_ms']:.5f}", bound_ms=f"{b_ms:.5f}",
                  bound_by=b_by, bytes=e["bytes"], flops=str(e["flops"]) + lib)
    # the team kernels: device time beside the bound and the one-thread
    # kernels' recorded time, ptxas report and launch layout per scene;
    # for B3 also the bound with only H^-1's block entries read
    team_plans = {(scene, name): tasks[scene].engine.plan
                  for scene in dyn_scenes for name in DYN if scene in report}
    team_plans.update({(scene, "contact_solve"): tasks[scene + "_b4"].engine
                       .cplan for scene in b4_scenes if scene in report})
    team_plans[("grab", "contact_solve")] = grab[0]
    for (scene, name), p in team_plans.items():
        e = report[scene][name]
        b_us = bound(e["bytes"], e["flops"])[0] * 1e3
        was = RECORDED_US[(scene, name)]
        lay = p.layout(name)
        px = ptxas_report(p.build_log.get(name, ""), name + "_kernel")
        extra = {}
        if name == "dyn_cached":
            b_blk = bound(e["block_bytes"], e["flops"])[0] * 1e3
            extra = dict(block_bound_us=f"{b_blk:.2f}")
        phase("team_kernel", scene=scene, name=name,
              device_us=f"{e['device_us']:.2f}", bound_us=f"{b_us:.2f}",
              x_bound=f"{e['device_us'] / b_us:.1f}",
              recorded_us="not_measured" if was is None else was,
              speedup="-" if was is None else f"{was / e['device_us']:.2f}",
              regs=px.get("regs"), stack=px.get("stack"),
              spill_st=px.get("spill_st"), spill_ld=px.get("spill_ld"),
              smem_bytes=lay.smem_bytes, team=lay.team, envs=lay.envs,
              blocks_per_sm_by_smem=SM_SMEM // (lay.smem_bytes
                                                + BLOCK_RESERVED),
              **extra)
    # B5 per shape: the OSC inverses and the seeded stacks
    spd_rows = {"osc_mm": report["franka_reach_ma"]["spd_inverse"],
                **{f"{scene} osc_mm": report[scene]["spd_inverse"]
                   for scene in SINGLE_SCENES + FACTORY_SCENES
                   if "spd_inverse" in report[scene]},
                **spd_extra}
    for label, e in spd_rows.items():
        p = sk.get_plan(e["n"])
        lay = p.layout()
        px = ptxas_report(p.build_log.get("spd_inverse", ""),
                          "spd_inverse_kernel")
        b_us = bound(e["bytes"], e["flops"])[0] * 1e3
        phase("spd_kernel", shape=label, n=e["n"],
              device_us=f"{e['device_us']:.2f}", bound_us=f"{b_us:.2f}",
              x_bound=f"{e['device_us'] / b_us:.1f}",
              library_ms=f"{e['library_ms']:.5f}", regs=px.get("regs"),
              stack=px.get("stack"), spill_st=px.get("spill_st"),
              spill_ld=px.get("spill_ld"), smem_bytes=lay.smem_bytes,
              team=lay.team, rows=p.rows, matrices_per_block=lay.envs)
    if "--kernels-only" in sys.argv[1:]:
        clock.lap("kernels")
        return 0

    clock.lap("kernels")
    workers = start_workers()
    # ---- 4. golden JAX captures replayed through the kernels; the B4 route
    # solves all candidate rows uncompacted, so FrankaReachMA has a capture
    # of each route
    for fname, routes in (("ant_golden.npz", (False, True)),
                          ("ball_balance_golden.npz", (False, True)),
                          ("franka_reach_ma_golden.npz", (False,)),
                          ("franka_reach_ma_b4_golden.npz", (True,)),
                          ("cartpole_golden.npz", (False,)),
                          ("franka_collect_ma_golden.npz", (False,)),
                          ("franka_collect_ma_b4_golden.npz", (True,)),
                          ("franka_ppma_golden.npz", (False,)),
                          ("humanoid_golden.npz", (False, True)),
                          ("anymal_golden.npz", (False, True)),
                          ("anymal_terrain_golden.npz", (False, True)),
                          ("ingenuity_golden.npz", (False, True)),
                          ("quadcopter_golden.npz", (False,)),
                          ("franka_reach_golden.npz", (False, True)),
                          ("franka_cabinet_golden.npz", (False, True)),
                          ("franka_cabinet_b4_golden.npz", (True,)),
                          ("franka_cube_stack_golden.npz", (False,)),
                          ("franka_cube_stack2_golden.npz", (False,)),
                          ("trifinger_golden.npz", (False,)),
                          ("trifinger_b4_golden.npz", (True,)),
                          ("allegro_kuka_golden.npz", (False,)),
                          ("allegro_kuka_b4_golden.npz", (True,)),
                          ("allegro_kuka_two_arms_golden.npz", (False,)),
                          ("shadow_hand_golden.npz", (False,)),
                          ("allegro_hand_golden.npz", (False,)),
                          ("shadow_hand_openai_ff_golden.npz", (False,)),
                          ("allegro_hand_lstm_golden.npz", (False,)),
                          ("allegro_hand_dextreme_manual_dr_golden.npz",
                           (False,)),
                          ("allegro_hand_dextreme_adr_golden.npz",
                           (False,)),
                          *((f, (False,)) for f in (
                              "factory_task_nut_bolt_pick_golden.npz",
                              "factory_task_nut_bolt_place_golden.npz",
                              "factory_task_nut_bolt_screw_golden.npz",
                              "factory_task_gears_golden.npz",
                              "factory_task_insertion_golden.npz",
                              "indust_real_task_pegs_insert_golden.npz",
                              "indust_real_task_gears_insert_golden.npz")),
                          ("humanoid_amp_golden.npz", (False, True)),
                          ("humanoid_amp_hands_golden.npz", (False,))):
        path = os.path.join(HERE, "tests", "data", "torch_port", fname)
        name = str(np.load(path)["task"])
        tol = parity.TOLERANCES[name]
        for kernel_route in routes:
            e = parity.replay(path, dev, use_contact_kernel=kernel_route)
            if not e.finite:
                raise RuntimeError(f"{fname} replay produced non-finite "
                                   "values")
            for k, bound_k in tol.items():
                errs = getattr(e, k)
                if not (errs <= bound_k).all():
                    raise RuntimeError(
                        f"{fname} replay (B4 {kernel_route}) {k} per-step "
                        f"errors {errs} exceed {bound_k}")
            # a one-step capture (AnymalTerrain's) is held against the
            # reference's own one-ulp spread (parity.replay)
            most = (0 if e.raw is None
                    else parity.ONE_STEP_RESET_MISMATCHES)
            if (e.reset_mismatches > most).any() or (
                    e.wild_envs is not None and (e.wild_envs > 4).any()):
                raise RuntimeError(f"{fname} replay reset mismatches "
                                   f"{e.reset_mismatches} (envs not held: "
                                   f"{e.wild_envs})")
            extra = {}
            if e.raw is not None:
                extra = dict(raw_max_err="/".join(
                    f"{k}:{max(e.raw[k]):.2g}" for k in e.raw),
                    envs_not_held="/".join(str(v) for v in e.wild_envs),
                    reset_mismatches="/".join(
                        str(v) for v in e.reset_mismatches))
            if e.traj_raw is not None:
                # held beyond four times the reference's own trajectory
                # spread (the cube-stack captures, ROADMAP C9)
                extra = dict(raw_max_err="/".join(
                    f"{k}:{max(e.traj_raw[k]):.2g}" for k in e.traj_raw),
                    widening_last="/".join(
                        f"{k}:{e.traj_widening[k][-1]:.2g}"
                        for k in e.traj_widening))
            if "grab_envs" in np.load(path):
                # half the envs start holding (each agent its cube, or the
                # cabinet's handle): a live grab per agent in step 1, and
                # grabs live in every step
                cap = np.load(path)
                agents = cap["actions"].shape[1] // cap["init_q"].shape[0]
                held = agents * len(cap["grab_envs"])
                if e.grabs_live[0] != held or not (e.grabs_live > 0).all():
                    raise RuntimeError(f"{fname} replay grabs live per step "
                                       f"{e.grabs_live}")
                extra.update(grabs_live="/".join(
                    f"{v:.0f}" for v in e.grabs_live))
            phase("golden", task=name, b4=kernel_route, steps=len(e.q),
                  **{f"{k}_err": "/".join(f"{v:.2g}" for v in getattr(e, k))
                     for k in tol}, **extra)

    clock.lap("golden")
    # ---- restitution and limit shifts: the engine step on the card
    # against the CPU twins, the bounce target live, the route rule
    restitution_phase(torch, np, tasks, dev)
    clock.lap("restitution")
    # ---- the Factory engine features: one Pick-128 step on the card
    # against the CPU twins
    factory_engine_phase(torch, tasks["factory_pick"], dev)
    clock.lap("factory_engine")
    # ---- 5. main path: each phase with the counts set to 0 just before it
    total = {name: 0 for name in KERNEL_WRAPPERS}
    scene_launches = collections.defaultdict(collections.Counter)
    for tag, name, kernel_route, steps, n_envs in PHASES:
        task = tasks[tag]
        # a requested kernel route is B4, except where masses are split;
        # at Dextreme the route of the call with the step's own scales
        route = (task.engine.route_for(task.initial_state().phys)
                 if name in DEXTREME else task.engine.contact_route)
        if kernel_route and route != ("loop" if name in MASS_SPLIT + FACTORY
                                      else "b4"):
            raise RuntimeError(f"{tag} took the contact route {route}")
        expected = tuple(k for k in DYN if k not in NEVER.get(name, ())) + (
            ("contact_solve",) if route == "b4" else ())
        if name in OSC_TASKS:
            expected += ("spd_inverse",)
        forbidden = [k for k in KERNEL_WRAPPERS if k not in expected]
        lift, reads0 = [], getattr(task, "branch_reads", 0)
        if name == "FactoryTaskNutBoltPick":
            # the close-and-lift epilogue: each call's lift success share
            # (read after the phase), on the card
            evaluate = task.evaluate_lift

            def counted_lift(st, _evaluate=evaluate):
                out = _evaluate(st)
                lift.append(out.mean())
                return out

            task.evaluate_lift = counted_lift
        r = main_phase(torch, KERNEL_WRAPPERS, task, dev, steps, expected,
                       forbidden)
        if name == "FactoryTaskNutBoltPick":
            del task.evaluate_lift
            if not lift:
                raise RuntimeError(f"{tag} ran no close-and-lift epilogue")
        scene_launches[tag.replace("_b4", "")].update(r["launches"])
        n_b5 = r["launches"]["spd_inverse"]
        if name in OSC_TASKS and n_b5 != 2 * steps:
            raise RuntimeError(f"OSC launched B5 {n_b5} times in {steps} "
                               "steps, not twice a step")
        for k, c in r["launches"].items():
            total[k] += c
        rows_per_s = task.rl_games_batch * steps / r["seconds"]
        agents = ({} if task.num_agents == 1 else dict(
            agents=task.num_agents, agent_steps_per_s=f"{rows_per_s:.1f}"))
        if task.engine.grabs:
            agents["grab_live_share"] = f"{r['grab_share']:.6f}"
        phase("main", phase=tag, envs=n_envs, steps=steps,
              contact_route=route, seconds=f"{r['seconds']:.4f}",
              env_steps_per_s=f"{n_envs * steps / r['seconds']:.1f}",
              **agents, stream_ms_per_step=f"{r['stream_ms']:.4f}",
              resets=r["resets"],
              launches=json.dumps(r["launches"]).replace(" ", ""),
              host_waits_per_step=sum(r["host_waits"].values()),
              wait_at=json.dumps(dict(r["host_waits"])).replace(" ", ""))
        if tag == "trifinger":
            dr_stats(torch, task, dev)
        if name in MASS_SPLIT:
            hand_stats(torch, task, dev, tag)
        if name in DEXTREME:
            dextreme_stats(torch, task, dev, tag)
        if name in FACTORY:
            factory_stats(task, lift, reads0, MAIN_WARMUP + steps + 1)
        if tag == "humanoid_amp":
            amp_main = dict(r, steps=steps)
            amp_rsi = amp_rsi_check(torch, task, dev)
    # the dict-observation shim over Dextreme-ADR
    shim_phase(torch, tasks["allegro_hand_dextreme_adr"], dev)

    clock.lap("main")
    # ---- 6. train: PPO epochs on the main phases' tasks, then Cartpole
    # learning through the train entry point
    from isaacgymenvs_ma_tpu_torch import train as train_cli
    from isaacgymenvs_ma_tpu_torch.learning.amp import AMPAgent
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.hrl import (
        HRLTaskWrapper, build_llc_from_checkpoint)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu_torch.learning.sac import SACAgent
    for tag, scene, config, warm, epochs in TRAIN_RUNS:
        task = tasks[scene]
        expected = tuple(k for k in DYN if k not in NEVER.get(
            type(task).__name__, ())) + (
                ("spd_inverse",) if type(task).__name__ in OSC_TASKS else ())
        forbidden = [k for k in KERNEL_WRAPPERS if k not in expected]
        tcfg = train_default_config(config)
        if tag == "train_franka_collect_ma" and task.num_obs != 28:
            raise RuntimeError(f"FrankaCollectMA obs width {task.num_obs}")
        agent = PPOAgent(task, tcfg, seed=42)
        rows, launches = train_run(torch, KERNEL_WRAPPERS, agent, warm, epochs,
                                   expected, forbidden)
        steps = agent.horizon * epochs
        n_b5 = launches["spd_inverse"]
        if "spd_inverse" in expected and n_b5 != 2 * steps:
            raise RuntimeError(f"OSC launched B5 {n_b5} times in {steps} "
                               "steps, not twice a step")
        for k, c in launches.items():
            total[k] += c
        extra = {}
        if getattr(task, "use_adr", False):
            extra["adr_npd"] = (
                f"{float(task.adr.npd(agent.env_state.task.adr)):.6f}")
        report_ppo(tag, task, agent, rows, launches, epochs, **extra)

    # the AMP learner on HumanoidAMP
    tag, scene, config = AMP_RUN
    task = tasks[scene]
    loop_only = [k for k in KERNEL_WRAPPERS if k not in DYN]
    agent = AMPAgent(task, train_default_config(config), seed=42)
    rows, launches = train_run(torch, KERNEL_WRAPPERS, agent, 1, 1, DYN,
                               loop_only)
    for k, c in launches.items():
        total[k] += c
    report_ppo(tag, task, agent, rows, launches, 1)
    m = rows[-1]["m"]
    disc = {k: m[k] for k in ("disc_loss", "disc_bce", "disc_grad_penalty",
                              "disc_acc_agent", "disc_acc_demo",
                              "disc_reward")}
    if agent.replay_n != 2 * agent.amp_batch:
        raise RuntimeError(f"AMP replay holds {agent.replay_n} transitions "
                           f"after two epochs of {agent.amp_batch}")
    rsi_share = amp_main["resets"] / (amp_main["steps"] * task.num_envs)
    phase("amp", run=tag, envs=task.num_envs,
          rsi_reset_share=f"{rsi_share:.6f}",
          rsi_state_err=f"{amp_rsi['err']:.3g}",
          rsi_stray_share=f"{amp_rsi['stray']:.6f}",
          disc_reward_mean=f"{disc['disc_reward']:.6g}",
          **{k: f"{v:.6g}" for k, v in disc.items() if k != "disc_reward"},
          replay_n=agent.replay_n,
          replay_fill=f"{agent.replay_n / agent.replay_size:.6f}",
          amp_batch=agent.amp_batch)

    # SAC on AntSAC and HumanoidSAC
    for tag, scene, config in SAC_RUNS:
        task = tasks[scene]
        agent = SACAgent(task, train_default_config(config), seed=42)
        rows, launches = sac_run(torch, KERNEL_WRAPPERS, agent, 1, 1, DYN,
                                 loop_only)
        for k, c in launches.items():
            total[k] += c
        for i, r in enumerate(rows):
            m, sec = r["m"], r["seconds"]
            steps = agent.steps_per_epoch
            phase("train", run=tag, epoch=i + 1, envs=task.num_envs,
                  network="TanhGaussianActor+TwinQ", steps=steps,
                  updates=r["updates"], seconds=f"{sec:.4f}",
                  device_ms=f"{r['device_ms']:.3f}",
                  host_syncs=r["host_syncs"],
                  sync_at=json.dumps(dict(r["sync_at"])).replace(" ", ""),
                  env_steps_per_s=f"{task.num_envs * steps / sec:.1f}",
                  **{k: f"{m[k]:.6g}" for k in (
                      "critic_loss", "actor_loss", "alpha", "mean_return")})
        m = rows[-1]["m"]
        fill = min(agent.buf_n, agent.replay_size)
        phase("sac", run=tag, envs=task.num_envs, env_steps=agent.step,
              seed_steps=agent.num_seed_steps, alpha=f"{m['alpha']:.6g}",
              replay_rows=fill,
              replay_fill=f"{fill / agent.replay_size:.6f}",
              critic_loss=f"{m['critic_loss']:.6g}",
              actor_loss=f"{m['actor_loss']:.6g}",
              launches=json.dumps(launches).replace(" ", ""))

    # PPO on the HRL wrapper over HumanoidAMP, a fresh LLC
    tag, scene = HRL_RUN
    task = tasks[scene]
    llc, latent = build_llc_from_checkpoint(task, HRL_LLC)
    hrl = HRLTaskWrapper(task, llc, latent, HRL_LLC_STEPS)
    tcfg = train_default_config(HRL_CONFIG)
    tcfg["params"]["algo"]["name"] = "a2c_continuous"
    agent = PPOAgent(hrl, tcfg, seed=42)
    rows, launches = train_run(torch, KERNEL_WRAPPERS, agent, 1, 1, DYN,
                               loop_only)
    for k, c in launches.items():
        total[k] += c
    report_ppo(tag, hrl, agent, rows, launches, 1)
    inner = hrl_inner_steps(torch, hrl, agent)
    sec = rows[-1]["seconds"]
    phase("hrl", run=tag, envs=task.num_envs, latent_dim=latent,
          llc_units=json.dumps(HRL_LLC["units"]).replace(" ", ""),
          llc_steps=HRL_LLC_STEPS, inner_steps_per_outer_step=inner,
          train_config=f"{HRL_CONFIG}(a2c_continuous)",
          outer_steps_per_s=f"{task.num_envs * agent.horizon / sec:.1f}",
          inner_steps_per_s=(
              f"{task.num_envs * agent.horizon * inner / sec:.1f}"))
    if inner != HRL_LLC_STEPS:
        raise RuntimeError(f"HRL ran {inner} inner steps an outer step")

    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    agent = train_cli.launch([
        "task=Cartpole", "num_envs=512", f"max_iterations={LEARN_EPOCHS}",
        "sim_device=cuda:0", "log_interval=1",
        f"train.params.config.score_to_win={LEARN_BAR}"])
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in KERNEL_WRAPPERS.items()}
    ret = float(agent.mean_return)
    if not ret > LEARN_BAR:
        raise RuntimeError(f"Cartpole-512 mean return {ret} after "
                           f"{agent.epoch} epochs, not above {LEARN_BAR}")
    check_launches(launches, DYN, ("contact_solve", "spd_inverse"),
                   "learn_cartpole")
    for k, c in launches.items():
        total[k] += c
    phase("train", run="learn_cartpole", passed_at_epoch=agent.epoch,
          mean_return=f"{ret:.2f}", seconds=f"{seconds:.2f}",
          launches=json.dumps(launches).replace(" ", ""))

    clock.lap("train")
    # ---- 7. glue: data parallelism, the entry point's flags, profiling,
    # PBT, terrain normal frames
    glue, nf_launches = glue_phase(torch, np, KERNEL_WRAPPERS, tasks, dev,
                                   workers)
    for k, c in glue.items():
        total[k] += c
    clock.lap("glue")
    kernels = []
    rows = [(name, JSON_SCENE[name], total[name]) for name in KERNELS]
    rows += [(name, scene, scene_launches[scene][name])
             for scene in GRAB_SCENES + LOCO_SCENES + SINGLE_SCENES
             + HAND_SCENES + FACTORY_SCENES for name in report[scene]]
    # FrankaCubeStack2 runs FrankaCubeStack's kernels (the same scene and
    # contact plan): its rows carry those checks and its own launches
    report["franka_cube_stack2"] = report["franka_cube_stack"]
    rows += [(name, "franka_cube_stack2",
              scene_launches["franka_cube_stack2"][name])
             for name in ("fk_motion", "dyn_forward", "dyn_cached",
                          "spd_inverse")]
    # Dextreme-ManualDR runs the ADR scene's kernels (the same scene): its
    # rows carry those checks and its own launches
    report["allegro_hand_dextreme_manual_dr"] = report[
        "allegro_hand_dextreme_adr"]
    rows += [(name, "allegro_hand_dextreme_manual_dr",
              scene_launches["allegro_hand_dextreme_manual_dr"][name])
             for name in DYN]
    # HumanoidAMPHands runs HumanoidAMP's kernels (the same scene): its
    # rows carry those checks and its own launches
    report["humanoid_amp_hands"] = report["humanoid_amp"]
    rows += [(name, "humanoid_amp_hands",
              scene_launches["humanoid_amp_hands"][name]) for name in DYN]
    # AnymalTerrain runs Anymal's kernels (the same scene and contact
    # plan): its rows carry Anymal's checks and its own launches
    report["anymal_terrain"] = report["anymal"]
    rows += [(name, "anymal_terrain", scene_launches["anymal_terrain"][name])
             for name in ("fk_motion", "dyn_forward", "contact_solve")]
    # AnymalTerrain with terrain normal frames (phase 7) runs Anymal's B1
    # and B2 on the loop: its rows carry those checks and its launches
    report["anymal_terrain_normal_frames"] = report["anymal"]
    rows += [(name, "anymal_terrain_normal_frames", nf_launches[name])
             for name in ("fk_motion", "dyn_forward")]
    for name, scene, launches in rows:
        source, replaces = KERNELS[name]
        e = report[scene][name]
        b_ms, b_by = bound(e["bytes"], e["flops"])
        kernels.append(dict(
            name=name, scene=scene, route="cuda", source=source,
            replaces=replaces, launches=launches,
            max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=e.get("library_ms")))
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
