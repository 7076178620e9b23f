"""Time kernels B1 (fk_motion) and B3 (dyn_cached) under several launch
layouts on one GPU: team lanes per env and threads per block.

    python3 scripts/time_team_layouts.py

For each scene (Ant and BallBalance at 4096 envs, FrankaReachMA at 8192)
on a state 10 steps in: the device time per launch by CUPTI, alone
(chip_smoke.device_us), of each variant, its max abs error against the
plain twin and ptxas's registers and spill, one ``[layout]`` line each.
The layouts the port uses are those of ``DynPlan.layout``; this script
shows what the others cost.
"""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel -> (team, threads) variants per scene
VARIANTS = {
    "fk_motion": [(4, 128), (4, 256), (8, 256)],
    "dyn_cached": [(16, 128), (16, 256), (16, 512), (32, 128), (32, 256),
                   (32, 512)],
}
SCENES = {"ant": ("Ant", 4096), "ball_balance": ("BallBalance", 4096),
          "franka_reach_ma": ("FrankaReachMA", 8192)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from isaacgymenvs_ma_tpu_torch.physics import _build
    from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as dk
    from isaacgymenvs_ma_tpu_torch.utils import parity
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

    dev = torch.device("cuda", 0)
    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)

    def variant_plan(engine, name, team, threads):
        """A plan of its own whose kernel ``name`` runs ``team`` lanes an
        env in blocks of ``threads`` (its per-env shared memory as the
        port's layout has it), or None where a block would not fit."""
        p = dk.DynPlan(engine)
        p.kernel_names = (name,)
        lay = p.layout(name)
        lay.team, lay.envs = team, threads // team
        lay.smem_bytes = 4 * lay.shared + lay.envs * 4 * lay.floats
        if lay.smem_bytes > dk.MAX_SMEM_BYTES:
            return None
        port_layout = p.layout
        p.layout = lambda n="dyn_forward": lay if n == name else port_layout(n)
        return p, lay

    for scene, (tname, n) in SCENES.items():
        cls, cfg, _ = parity.TASKS[tname]
        task = cls(deep_merge(cfg, {"env": {"numEnvs": n}}), device=dev,
                   seed=1)
        st, _ = cs.run_steps(torch, task, task.initial_state(),
                             cs.zero_obs(torch, task, dev),
                             cs.policy(torch, task, dev), 10)
        base = task.engine.plan
        consts = base.consts(dev)
        q_bl = st.sim.q.t().contiguous()
        qd_bl = st.sim.qd.t().contiguous()
        bx, bq, S = dk._fk_motion_bl(base, q_bl)
        g = torch.Generator(device=dev).manual_seed(3)
        rhs = torch.randn((base.nv, n), generator=g, device=dev)
        diag = (task.engine.dof_armature[:, None] + 0.1).expand(
            base.nv, n).contiguous()
        _, hinv, io = dk.dyn_full_bl(base, consts, bx, bq, S, qd_bl, rhs,
                                     diag)
        fg = task.engine.gravity_wrench(
            bx.permute(2, 0, 1), bq.permute(2, 0, 1)).permute(1, 2, 0) \
            .contiguous()
        cargs = (S, qd_bl, rhs, io, hinv, fg)
        ref_c = dk.dyn_cached_bl(base, consts, *cargs)
        plans, seen = [], set()
        for name, vs in VARIANTS.items():
            for team, threads in vs:
                v = variant_plan(task.engine, name, team, threads)
                if v is not None and (name, v[0].header()) not in seen:
                    seen.add((name, v[0].header()))
                    plans.append((name, *v))
        for finish in [_build.build(p, wait=False) for _, p, _ in plans]:
            finish()
        for name, p, lay in plans:
            px = cs.ptxas_report(p.build_log[name], name + "_kernel")
            if name == "fk_motion":
                run = lambda: dk.fk_motion(p, q_bl)  # noqa: E731
                err = max(float((a - b).abs().max())
                          for a, b in zip(run(), (bx, bq, S)))
            else:
                run = lambda: dk.dyn_cached(p, *cargs)  # noqa: E731
                err = float((run() - ref_c).abs().max())
            us = cs.device_us(torch, run, name + "_kernel")
            cs.phase("layout", scene=scene, kernel=name, team=lay.team,
                     envs=lay.envs, threads=lay.team * lay.envs,
                     smem=lay.smem_bytes,
                     regs=px.get("regs"), spill=px.get("spill_st"),
                     device_us=f"{us:.2f}", max_abs_err=f"{err:.2g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
