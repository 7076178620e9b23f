"""Port parity: isaacgymenvs_ma_tpu_torch.ops.{maths,rng} against the JAX
package's ops on the same seeded numpy inputs (atol 1e-5, f32)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.ops import maths as jm
from isaacgymenvs_ma_tpu.ops import rng as jrng
from isaacgymenvs_ma_tpu_torch.ops import maths as tm
from isaacgymenvs_ma_tpu_torch.ops import rng as trng

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

N = 64
_rng = np.random.default_rng(1234)


def _quat(n=N):
    q = _rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vec(n=N, k=3, scale=1.0):
    return (scale * _rng.normal(size=(n, k))).astype(np.float32)


def _ang(n=N):
    return _rng.uniform(-3.0, 3.0, size=(n,)).astype(np.float32)


# (name, input builder); every input is a float32 numpy array
CASES = {
    "normalize": lambda: (_vec(k=4),),
    "tensor_clamp": lambda: (_vec(), np.float32(-0.3), np.float32(0.4)),
    "scale": lambda: (_vec(), _vec() - 2.0, _vec() + 2.0),
    "unscale": lambda: (_vec(), np.full((N, 3), -2, np.float32),
                        np.full((N, 3), 3, np.float32)),
    "scale_transform": lambda: (_vec(), np.float32(-2.0), np.float32(3.0)),
    "unscale_transform": lambda: (_vec(), np.float32(-2.0), np.float32(3.0)),
    "normalize_angle": lambda: (_vec(k=1, scale=6.0),),
    "quat_mul": lambda: (_quat(), _quat()),
    "quat_conjugate": lambda: (_quat(),),
    "quat_unit": lambda: (_vec(k=4),),
    "quat_apply": lambda: (_quat(), _vec()),
    "quat_rotate_inverse": lambda: (_quat(), _vec()),
    "quat_from_angle_axis": lambda: (_ang(), _vec()),
    "quat_to_rotmat": lambda: (_quat(),),
    "quat_diff_rad": lambda: (_quat(), _quat()),
    "axisangle2quat": lambda: (np.concatenate(
        [_vec(n=N - 2), np.zeros((2, 3), np.float32)]),),
    "quat_from_euler_xyz": lambda: (_ang(), _ang(), _ang()),
    "quat_to_tan_norm": lambda: (_quat(),),
    "quat_to_exp_map": lambda: (_quat(),),
    "exp_map_to_quat": lambda: (_vec(),),
    "calc_heading": lambda: (_quat(),),
    "calc_heading_quat": lambda: (_quat(),),
    "calc_heading_quat_inv": lambda: (_quat(),),
    "slerp": lambda: (_quat(), _quat(),
                      _rng.uniform(0, 1, (N, 1)).astype(np.float32)),
    "get_euler_xyz": lambda: (_quat(),),
    "tf_inverse": lambda: (_quat(), _vec()),
    "tf_apply": lambda: (_quat(), _vec(), _vec()),
    "tf_combine": lambda: (_quat(), _vec(), _quat(), _vec()),
    "quat_axis": lambda: (_quat(),),
}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(o) for o in out]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_maths_matches_jax(name):
    args = CASES[name]()
    ref = getattr(jm, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tm, name)(*(torch.as_tensor(a) for a in args))
    for r, g in zip(_flat(ref), _flat(got), strict=True):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5, err_msg=name)


def test_locomotion_helpers_match_jax():
    """compute_heading_and_up + compute_rot, the Ant observation helpers."""
    q, inv = _quat(), np.tile(np.array([0, 0, 0, 1], np.float32), (N, 1))
    to_t = _vec(scale=10.0)
    v0 = np.array([1.0, 0.0, 0.0], np.float32)
    v1 = np.array([0.0, 0.0, 1.0], np.float32)
    ref = jm.compute_heading_and_up(jnp.asarray(q), jnp.asarray(inv),
                                    jnp.asarray(to_t), v0, v1, 2)
    got = tm.compute_heading_and_up(torch.as_tensor(q), torch.as_tensor(inv),
                                    torch.as_tensor(to_t), v0, v1, 2)
    for r, g in zip(ref, got, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    vel, ang, tgt, pos = _vec(), _vec(), _vec(scale=100.0), _vec()
    ref = jm.compute_rot(*(jnp.asarray(a) for a in (q, vel, ang, tgt, pos)))
    got = tm.compute_rot(*(torch.as_tensor(a) for a in (q, vel, ang, tgt, pos)))
    for r, g in zip(ref, got, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_get_axis_params_matches_jax():
    assert tm.get_axis_params(0.44, 2) == list(jm.get_axis_params(0.44, 2))


def test_rng_seed_semantics():
    for args in ((5,), (5, 3), (-1, 0, True), (7, 2, True)):
        assert trng.make_seed(*args) == jrng.make_seed(*args)


def test_rng_generator_draws():
    """Explicit generators: same seed -> same draws; range and shape hold."""
    a = trng.rand_float(trng.make_generator(3, "cpu"), -0.2, 0.2, (64, 8))
    b = trng.rand_float(trng.make_generator(3, "cpu"), -0.2, 0.2, (64, 8))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= -0.2 and float(a.max()) < 0.2
    d = trng.random_dir_2(trng.make_generator(4, "cpu"), (32,))
    assert d.shape == (32, 2)
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=-1).numpy(),
                               1.0, atol=1e-6)
