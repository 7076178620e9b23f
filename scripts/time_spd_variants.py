"""Time kernel B5 (csrc/spd_inverse.cu) against variants of itself on one
GPU: alone at every size chip_smoke.py holds B5 at, and inside the
FrankaReachMA-8192 step at its two OSC sizes.

    python3 scripts/time_spd_variants.py

Each variant is made from the port's source by replacing one part of it,
so it differs from the kernel the port builds in nothing else:

- ``port``        the kernel as built;
- ``shared_row``  the pivot row handed to the team through its slot in
                  shared memory and ``__syncwarp``, not by warp shuffle;
- ``no_fma``      each update rounded twice, as the twin does (mul, sub):
                  the kernel then gives the twin's float32 result bit for
                  bit;
- ``odd_rows``    the matrices staged at row stride odd(n) (and one float
                  more a matrix), 4 bytes a copy through a per-element
                  index map;
- ``direct``      no staging: each lane reads its rows from device memory
                  and writes them back there;
- ``copy``        no sweep: the staging and the store alone, the floor the
                  kernel's memory traffic sets (its output is H, not H^-1,
                  so it is timed alone only).

Alone: seeded SPD stacks (chip_smoke.seeded_spd), device us per launch by
CUPTI (chip_smoke.device_us, twice), max abs error against the plain twin,
ptxas's registers and spill: one ``[variant]`` line each.  In the step:
each variant's libraries for n = 7 and n = 6 serve the port's B5 plans in
turn, three rounds in alternating order, 10 profiled steps each; B5's
launches alternate between the arm mass matrices (n = 7) and J M^-1 J^T
(n = 6), reported apart: one ``[variant_step]`` line each.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((16384, 7), (16384, 6), (4096, 14), (1024, 30), (256, 48))
STEP_ENVS = 8192


def part(src, start, end):
    """The text of ``src`` from ``start`` up to ``end`` (each once)."""
    for anchor in (start, end):
        if src.count(anchor) != 1:
            raise RuntimeError(f"spd_inverse.cu: {anchor!r} not found once")
    return src[src.index(start):src.index(end)]


def swap(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError(f"spd_inverse.cu: {old!r} not found once")
    return src.replace(old, new)


def variants(src):
    """{name: (source, shared bytes a matrix or None for the port's)}."""
    stage = part(src, "  const bool quads =", "  const int lane = wl % TEAM")
    store = part(src, "  __syncwarp();\n  if (quads) {", "}\n\n}  // namespace")
    load_row = "M[t][j] = live && r < N ? mine[r * N + j] : 0.0f;"
    store_row = "for (int j = 0; j < N; ++j) mine[r * N + j] = M[t][j];"
    out = {"port": (src, None)}
    shuffle = part(src, "#pragma unroll\n    for (int j = 0; j < N; ++j)\n"
                   "      row[j] = __shfl_sync", "    const float inv_d")
    out["shared_row"] = (swap(src, shuffle, """\
    if (lane == k % TEAM) {
#pragma unroll
      for (int j = 0; j < N; ++j) mine[k * N + j] = M[k / TEAM][j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < N; ++j) row[j] = mine[k * N + j];
    if (k == N - 1) __syncwarp();
"""), None)
    out["no_fma"] = (swap(src, "fmaf(-col, row[j], M[t][j])",
                          "__fsub_rn(M[t][j], __fmul_rn(col, row[j]))"), None)
    odd = swap(src, 'static_assert(B5_FLOATS == ELEMS, "matrices lie in '
               'shared memory as in H");', """\
constexpr int RS = N | 1, PADDED = (N * RS) | 1;
__device__ __forceinline__ int slot(int e) {
  const int m = e / ELEMS, r = e - m * ELEMS;
  const int i = r / N;
  return m * PADDED + i * RS + (r - i * N);
}""")
    odd = swap(odd, "float* wtile = tile + warp * WARP_ELEMS;",
               "float* wtile = tile + warp * MPW * PADDED;")
    odd = swap(odd, stage, """\
  for (int e = wl; e < total; e += 32)
    __pipeline_memcpy_async(wtile + slot(e), src + e, sizeof(float));
  team::stage_wait();
  __syncwarp();

""")
    odd = swap(odd, "float* mine = wtile + mat * ELEMS;",
               "float* mine = wtile + mat * PADDED;")
    odd = swap(odd, load_row,
               "M[t][j] = live && r < N ? mine[r * RS + j] : 0.0f;")
    odd = swap(odd, store_row,
               "for (int j = 0; j < N; ++j) mine[r * RS + j] = M[t][j];")
    odd = swap(odd, store, """\
  __syncwarp();
  for (int e = wl; e < total; e += 32) dst[e] = wtile[slot(e)];
""")
    out["odd_rows"] = (odd, "padded")
    direct = swap(src, stage, "")
    direct = swap(direct, "float* mine = wtile + mat * ELEMS;",
                  "const float* mine = src + mat * ELEMS;\n"
                  "  float* mine_out = dst + mat * ELEMS;")
    direct = swap(direct, load_row,
                  "M[t][j] = live && r < N ? __ldg(mine + r * N + j) : 0.0f;")
    direct = swap(direct, store_row,
                  "for (int j = 0; j < N; ++j) mine_out[r * N + j] = M[t][j];")
    out["direct"] = (swap(direct, store, ""), None)
    sweep = part(src, "#pragma unroll\n  for (int k = 0; k < N; ++k) {",
                 "  // each lane writes back only")
    out["copy"] = (swap(src, sweep, ""), None)
    return out


ALONE_ONLY = ("copy",)


def header(plan, smem):
    """The port's header of ``plan``; for the padded variant with the
    shared memory of its padded matrices."""
    h = plan.header()
    if smem != "padded":
        return h
    lay = plan.layout()
    padded = (plan.n * (plan.n | 1)) | 1
    return h.replace(f"B5_SMEM_BYTES = {lay.smem_bytes};",
                     f"B5_SMEM_BYTES = {4 * lay.envs * padded};")


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from isaacgymenvs_ma_tpu_torch.physics import _build
    from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as dk
    from isaacgymenvs_ma_tpu_torch.physics import spd_kernel as sk
    from isaacgymenvs_ma_tpu_torch.utils import parity
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

    dev = torch.device("cuda", 0)
    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)
    src = (_build.CSRC / "spd_inverse.cu").read_text()
    found = variants(src)
    procs = {}
    for name, (text, smem) in found.items():
        for _, n in SIZES:
            d = _build.BUILD_ROOT / f"spd_variant_{name}_n{n}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "scene.h").write_text(header(sk.get_plan(n), smem))
            (d / "spd_inverse.cu").write_text(text)
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-include",
                   str(d / "scene.h"), "-I", str(_build.CSRC), "-o",
                   str(d / "libspd_inverse.so"), str(d / "spd_inverse.cu")]
            procs[(name, n)] = (d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs, logs = {}, {}
    for key, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(d / "libspd_inverse.so"))
        lib.spd_inverse_launch.argtypes = _build._ARGTYPES["spd_inverse"]
        lib.spd_inverse_launch.restype = ctypes.c_int
        libs[key], logs[key] = lib, log

    def launcher(key):
        plan = sk.SpdPlan(key[1])
        plan.libs["spd_inverse"] = libs[key]

        def run(H):
            out = torch.empty_like(H)
            dk._launch(plan, "spd_inverse", H.device, dk._ptr(H),
                       dk._ptr(out), ctypes.c_int(H.shape[0]))
            return out
        return run

    for B, n in SIZES:
        H = cs.seeded_spd(torch, B, n, 21 + n, dev)
        ref = dk.sweep_inverse_bl(H.permute(1, 2, 0).contiguous()
                                  ).permute(2, 0, 1)
        for name in found:
            run = launcher((name, n))
            err = float((run(H) - (H if name in ALONE_ONLY else ref))
                        .abs().max())
            us = [cs.device_us(torch, lambda: run(H), "spd_inverse_kernel")
                  for _ in range(2)]
            px = cs.ptxas_report(logs[(name, n)], "spd_inverse_kernel")
            cs.phase("variant", shape=f"({B},{n},{n})", variant=name,
                     device_us="/".join(f"{u:.2f}" for u in us),
                     max_abs_err=f"{err:.3g}", regs=px.get("regs"),
                     spill_st=px.get("spill_st"), spill_ld=px.get("spill_ld"))

    cls, cfg, _ = parity.TASKS["FrankaReachMA"]
    task = cls(deep_merge(cfg, {"env": {"numEnvs": STEP_ENVS}}), device=dev,
               seed=1)
    act = cs.policy(torch, task, dev)
    state, obs = cs.run_steps(torch, task, task.initial_state(),
                              cs.zero_obs(torch, task, dev), act, 10)
    names = [name for name in found if name not in ALONE_ONLY]
    for rnd, order in enumerate((names, names[::-1], names)):
        for name in order:
            for n in (6, 7):
                sk.get_plan(n).libs["spd_inverse"] = libs[(name, n)]
            state, obs = cs.run_steps(torch, task, state, obs, act, 3)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, obs = cs.run_steps(torch, task, state, obs, act, 10)
                torch.cuda.synchronize()
            b5 = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "spd_inverse_kernel" in e.name),
                        key=lambda e: e.time_range.start)
            us = [sum(e.device_time_total for e in b5[i::2])
                  / max(len(b5[i::2]), 1) for i in (0, 1)]
            cs.phase("variant_step", round=rnd, variant=name,
                     n7_us=f"{us[0]:.2f}", n6_us=f"{us[1]:.2f}",
                     launches=len(b5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
