"""Where the time goes in a PyTorch port task step, or a PPO epoch, on one
GPU.

    python3 scripts/profile_torch_ant.py
        [--task Ant|BallBalance|FrankaReachMA|Cartpole|FrankaCollectMA|
                FrankaPPMA|FrankaCombineMA|Humanoid|Anymal|AnymalTerrain|
                Ingenuity|Quadcopter|FrankaReach|FrankaCabinet|
                FrankaCubeStack|FrankaCubeStack2|Trifinger|AllegroKuka|
                AllegroKukaTwoArms|ShadowHand|AllegroHand|
                ShadowHandOpenAI_FF|AllegroHandLSTM|
                AllegroHandDextremeManualDR|AllegroHandDextremeADR|
                FactoryTaskNutBoltPick|FactoryTaskNutBoltPlace|
                FactoryTaskNutBoltScrew|FactoryTaskGears|
                FactoryTaskInsertion|IndustRealTaskPegsInsert|
                IndustRealTaskGearsInsert|HumanoidAMP|HumanoidAMPHands]
        [--contact-kernel] [--normal-frames]
        [--envs N] [--steps 20] [--train] [--table PATH]

Runs the port's step of the task (Ant by default, at its configuration's
env count unless ``--envs``; ``--contact-kernel`` routes the contact loop
through kernel B4, except at the hands, whose mass splitting keeps them on
the batched loop, as does Dextreme-ADR's restitution; the route printed is
``engine.route_for`` of the scales the task's first state hands the
engine; ``--normal-frames`` turns on the engine's terrain normal frames,
as chip_smoke.py's ``[normal_frames]`` phase runs AnymalTerrain) with
tanh(obs @ W) actions, as chip_smoke.py does, under
torch.profiler after a warm-up, and prints: host wall time per step, device
kernel time per step (the sum over CUDA kernels), the device busy share
(kernel time / wall time), kernel launches per step, the top kernels by
device time and the port's kernels B1-B5.  B5's launches are also reported
per matrix size: the OSC of the Franka tasks and of FactoryTaskNutBoltScrew
inverts the arm mass matrices (n = 7) and then J M^-1 J^T (n = 6) every
step, so in time order its launches alternate between the two.  ``--table`` writes torch.profiler's full table
to PATH.

``--train`` profiles one PPO epoch (``learning/ppo.py``; the AMP
learner's, ``learning/amp.py``, at HumanoidAMP, its update window then
including the discriminator step) of the task with its train config
instead, after one warm-up epoch, in two windows: the
rollout (policy forward + ``task.step`` over the horizon, then GAE) and
the update (normalisers, minibatch forward/backward and Adam); each
window's lines are per epoch, not per step.
"""
import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(torch, profile, ProfilerActivity, fn, calls, head, table, unit):
    """Run ``fn`` ``calls`` times under torch.profiler and print host wall
    time, device kernel time, busy share and launches per call, the top
    kernels and the port's kernels B1-B5; returns the CUDA events."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: the optimizer's user annotations also show on the
    # device timeline, as spans over its kernels
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("Optimizer.")]
    dev_us = sum(e.device_time_total for e in events)
    if table:
        os.makedirs(os.path.dirname(os.path.abspath(table)), exist_ok=True)
        with open(table, "a") as f:
            f.write(f"== {head}\n" + prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=100) + "\n")
    print(f"{head} wall_ms_per_{unit}={wall / calls * 1e3:.3f} "
          f"device_kernel_ms_per_{unit}={dev_us / calls / 1e3:.3f} "
          f"device_busy_share={dev_us / 1e6 / wall:.4f} "
          f"kernels_per_{unit}={len(events) / calls:.1f}")
    by_name = {}
    for e in events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"  {t / calls / 1e3:8.4f} ms/{unit} {c / calls:8.1f} "
              f"launches/{unit}  {name[:90]}")
    # the port's own kernels (B1-B5): device time per launch
    for kname in ("fk_motion_kernel", "dyn_forward_kernel",
                  "dyn_cached_kernel", "contact_solve_kernel",
                  "spd_inverse_kernel"):
        hits = [(t, c) for n, (t, c) in by_name.items() if kname in n]
        t = sum(h[0] for h in hits)
        c = sum(h[1] for h in hits)
        print(f"  port kernel {kname}: launches/{unit}={c / calls:.1f} "
              f"us/launch={t / max(c, 1):.2f}")
    return events


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="Ant",
                    choices=("Ant", "BallBalance", "FrankaReachMA",
                             "Cartpole", "FrankaCollectMA", "FrankaPPMA",
                             "FrankaCombineMA", "Humanoid", "Anymal",
                             "AnymalTerrain", "Ingenuity", "Quadcopter",
                             "FrankaReach", "FrankaCabinet",
                             "FrankaCubeStack", "FrankaCubeStack2",
                             "Trifinger", "AllegroKuka",
                             "AllegroKukaTwoArms", "ShadowHand",
                             "AllegroHand", "ShadowHandOpenAI_FF",
                             "AllegroHandLSTM", "AllegroHandDextremeManualDR",
                             "AllegroHandDextremeADR",
                             "FactoryTaskNutBoltPick",
                             "FactoryTaskNutBoltPlace",
                             "FactoryTaskNutBoltScrew", "FactoryTaskGears",
                             "FactoryTaskInsertion",
                             "IndustRealTaskPegsInsert",
                             "IndustRealTaskGearsInsert", "HumanoidAMP",
                             "HumanoidAMPHands"))
    ap.add_argument("--contact-kernel", action="store_true",
                    help="run the contact loop through kernel B4")
    ap.add_argument("--normal-frames", action="store_true",
                    help="contact frames from the terrain's normals")
    ap.add_argument("--envs", type=int, default=None,
                    help="envs (default: the task configuration's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--train", action="store_true",
                    help="profile one PPO epoch: rollout, then update")
    ap.add_argument("--table", default=None,
                    help="write the profiler's full table to this file")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    from isaacgymenvs_ma_tpu_torch.utils.parity import TASKS

    dev = torch.device("cuda", 0)
    cls, task_cfg, _ = TASKS[args.task]
    cfg = deep_merge(task_cfg, {"env": {"numEnvs": args.envs
                                        or task_cfg["env"]["numEnvs"]}})
    params = parse_sim_params(cfg["sim"])._replace(
        use_contact_kernel=args.contact_kernel,
        terrain_normal_frames=args.normal_frames)
    task = cls(cfg, device=dev, seed=1, sim_params=params)
    head = (f"task={args.task} contact_kernel={args.contact_kernel} "
            f"normal_frames={args.normal_frames} "
            f"route={task.engine.route_for(task.initial_state().phys)} "
            f"envs={task.num_envs} agents={task.num_agents}")
    if args.train:
        from isaacgymenvs_ma_tpu_torch.learning.configs import (
            train_default_config)
        from isaacgymenvs_ma_tpu_torch.learning.amp import AMPAgent
        from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
        tcfg = train_default_config(args.task)
        amp = tcfg["params"]["algo"]["name"] == "amp_continuous"
        agent = (AMPAgent if amp else PPOAgent)(task, tcfg, seed=1)
        agent.init()
        agent.train_epoch()                 # warm-up
        head += (f" horizon={agent.horizon} minibatches="
                 f"{agent.num_minibatches} mini_epochs="
                 f"{agent.cfg.mini_epochs} per=epoch")
        box = {}

        def rollout():
            roll, last_obs, _ = agent._rollout()
            roll = agent._transform_rewards(roll)
            box["gae"] = (roll, *agent._gae(roll, last_obs))

        def update():
            agent._update(*box["gae"])
            if amp:
                agent._disc_phase()

        windows = (("rollout", rollout), ("update", update))
        for label, fn in windows:
            report(torch, profile, ProfilerActivity, fn, 1,
                   f"{head} window={label}", args.table, label)
        return 0
    W = torch.randn((task.num_obs, task.num_actions), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0)) * 0.1
    state = task.initial_state()
    obs = torch.zeros((task.rl_games_batch, task.num_obs), device=dev)
    for _ in range(20):
        state, res = task.step(state, torch.tanh(obs @ W))
        obs = res.obs
    box = {"state": state, "obs": obs}

    def step():
        box["state"], res = task.step(box["state"], torch.tanh(box["obs"] @ W))
        box["obs"] = res.obs

    events = report(torch, profile, ProfilerActivity, step, args.steps,
                    f"{head} steps={args.steps}", args.table, "step")
    b5 = sorted((e for e in events if "spd_inverse_kernel" in e.name),
                key=lambda e: e.time_range.start)
    if b5:
        for i, n in enumerate((7, 6)):
            us = [e.device_time_total for e in b5[i::2]]
            print(f"  port kernel spd_inverse_kernel n={n}: "
                  f"launches/step={len(us) / args.steps:.1f} "
                  f"us/launch={sum(us) / max(len(us), 1):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
