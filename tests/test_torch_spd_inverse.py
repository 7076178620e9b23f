"""Port parity of the batched SPD inverse (kernel B5's path) on the CPU.

``isaacgymenvs_ma_tpu_torch.physics.engine.spd_inverse`` against the JAX
package on the same seeded SPD matrices (A A^T + 3 I, as
tests/test_contact_opt.py:88-89), for n in {1, 2, 3, 6, 7, 14, 30, 48}
(30: the JAX kernel's own measured size, engine.py:249-250; 48: two rows
a lane of kernel B5's team):

* against the JAX sweep ``_sweep_inverse_batchlast`` (the body of the TPU
  kernel B5 replaces): rtol 1e-5, atol 1e-6.  For n >= 3 the port runs the
  same sweep in float32 (the twin); n = 1 and n = 2 are closed forms.
* against the JAX ``spd_inverse`` as it runs on the CPU (the recursive
  2x2-block Schur form for n >= 3): rtol = atol = 1e-4, since the two
  algorithms round differently.

The kernel itself is held against its twin on the card by chip_smoke.py;
here: the wrapper's CPU dispatch, B5's launch layout (a team of lanes per
matrix, a lane per row) and per-size header, the registration of B5 and
that a missing nvcc raises.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import (
    _sweep_inverse_batchlast as jsweep, spd_inverse as jspd_inverse)
from isaacgymenvs_ma_tpu_torch.physics import KERNEL_WRAPPERS, _build
from isaacgymenvs_ma_tpu_torch.physics import spd_kernel
from isaacgymenvs_ma_tpu_torch.physics.engine import spd_inverse

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

SIZES = [1, 2, 3, 6, 7, 14, 30, 48]


def spd_batch(n, B=32, seed=0):
    rng = np.random.default_rng(seed + n)
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    return (A @ np.swapaxes(A, 1, 2)
            + 3.0 * np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_spd_inverse_matches_jax_sweep(n):
    H = spd_batch(n)
    ref = np.moveaxis(np.asarray(jsweep(jnp.asarray(np.moveaxis(H, 0, -1)))),
                      -1, 0)
    got = spd_inverse(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_spd_inverse_matches_jax_cpu_schur(n):
    H = spd_batch(n)
    ref = np.asarray(jspd_inverse(jnp.asarray(H)))
    got = spd_inverse(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got @ H, np.broadcast_to(np.eye(n), H.shape),
                               atol=1e-4)


def test_spd_inverse_keeps_leading_batch_dims():
    H = spd_batch(7, B=12).reshape(3, 4, 7, 7)
    got = spd_inverse(torch.as_tensor(H))
    assert got.shape == (3, 4, 7, 7)
    flat = spd_inverse(torch.as_tensor(H.reshape(12, 7, 7)))
    torch.testing.assert_close(got.reshape(12, 7, 7), flat, rtol=0, atol=0)


def test_sweep_wrapper_runs_the_twin_on_cpu():
    """CPU tensors go to the twin and launch nothing; a non-square or
    unbatched input raises."""
    H = torch.as_tensor(spd_batch(6))
    before = spd_kernel.sweep_inverse.launches
    got = spd_kernel.sweep_inverse(H)
    assert spd_kernel.sweep_inverse.launches == before
    ref = spd_kernel.sweep_inverse_bl(H.permute(1, 2, 0)).permute(2, 0, 1)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        spd_kernel.sweep_inverse(H[:, :, :5])
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        spd_kernel.sweep_inverse(H[0])


def test_b5_plan_header_and_registration():
    """One plan per matrix size, its size baked in; B5 is registered with
    the wrappers and the ctypes signatures (device, H, out, B, stream)."""
    p7 = spd_kernel.get_plan(7)
    assert spd_kernel.get_plan(7) is p7 and p7.n == 7
    assert "constexpr int N = 7;" in p7.header()
    assert "constexpr int N = 14;" in spd_kernel.get_plan(14).header()
    assert p7.kernel_names == ("spd_inverse",)
    assert KERNEL_WRAPPERS["spd_inverse"] is spd_kernel.sweep_inverse
    assert len(_build._ARGTYPES["spd_inverse"]) == 5
    assert (_build.lib_dir("spd_inverse", p7.header())
            != _build.lib_dir("spd_inverse", spd_kernel.get_plan(6).header()))


# n -> (team, rows a lane, matrices per 256-thread block)
B5_LAYOUTS = {3: (8, 1, 32), 6: (8, 1, 32), 7: (8, 1, 32), 14: (16, 1, 16),
              30: (32, 1, 8), 48: (32, 2, 8)}


@pytest.mark.parametrize("n", sorted(B5_LAYOUTS))
def test_b5_layout(n):
    """B5's launch layout from ``KernelLayout``: a team of the power of two
    >= n lanes (8 to 32), as many matrices as 256 threads hold, each in
    shared memory as in H (n^2 floats, no padding); the header bakes it in;
    every row of the matrix is owned by exactly one lane, row r by lane
    r % team, at most ``rows`` rows a lane."""
    plan = spd_kernel.SpdPlan(n)
    lay = plan.layout()
    team, rows, mats = B5_LAYOUTS[n]
    assert (lay.team, plan.rows, lay.envs) == (team, rows, mats)
    assert lay.team * lay.envs == 256
    assert lay.offsets == {} and lay.floats == n * n
    assert lay.shared == 0 and lay.smem_bytes == 4 * lay.envs * lay.floats
    h = plan.header()
    for line in (f"constexpr int N = {n};",
                 f"constexpr int B5_ROWS = {rows};",
                 f"constexpr int B5_TEAM = {team};",
                 f"constexpr int B5_ENVS = {mats};",
                 f"constexpr int B5_FLOATS = {lay.floats};",
                 f"constexpr int B5_SMEM_BYTES = {lay.smem_bytes};"):
        assert line in h
    lanes = plan.lane_rows()
    assert len(lanes) == team
    assert sorted(r for owned in lanes for r in owned) == list(range(n))
    assert max(len(owned) for owned in lanes) == rows
    for lane, owned in enumerate(lanes):
        assert all(r % team == lane for r in owned)
    # above 48 KB the launch opts in to dynamic shared memory (n = 48)
    assert (lay.smem_bytes > 48 * 1024) == (n == 48)


def test_b5_build_without_nvcc_raises(monkeypatch):
    """``_build.build`` takes a B5 plan as far as the compiler and raises
    there without nvcc; nothing falls back to the twin."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(spd_kernel.SpdPlan(9))
