"""The port's motion library (isaacgymenvs_ma_tpu_torch/learning/motion_lib.py)
against the JAX package's, on the six clips both packages ship.

The banks (numpy at load, the root rotation slerped at float32) are held at
1e-6; the state fetch and the transition pairs on the same motion ids and
times at 1e-6 (measured on the CPU: 1.2e-7 on the banks, <= 4.8e-7 on the
fetched states).  The JAX sampler draws ids by ``jax.random.categorical``,
the port's by the inverse CDF of the weights: their streams differ, so
the ids and times are drawn once from the JAX keys and handed to both, and
the port's sampler is held to the weights by its distribution.
"""
import glob
import os

import jax
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.learning.motion_lib import MotionLib as JMotionLib
from isaacgymenvs_ma_tpu_torch.learning.motion_lib import MotionLib

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(HERE, "isaacgymenvs_ma_tpu", "data", "motions")
PORT_DIR = os.path.join(HERE, "isaacgymenvs_ma_tpu_torch", "data", "motions")
CLIPS = sorted(os.path.basename(f)
               for f in glob.glob(os.path.join(JAX_DIR, "*.npy")))
DT = 0.0166 * 2          # HumanoidAMP's control dt (controlFrequencyInv 2)
TOL = 1e-6


@pytest.fixture(scope="module")
def libs():
    """Both libraries over the walk, run and hop clips, weighted 1 : 2 : 3
    (a padded multi-clip bank)."""
    names = ["amp_humanoid_walk.npy", "amp_humanoid_run.npy",
             "amp_humanoid_hop.npy"]
    w = [1.0, 2.0, 3.0]
    j = JMotionLib([(os.path.join(JAX_DIR, n), x) for n, x in zip(names, w)],
                   dt=DT)
    p = MotionLib([(os.path.join(PORT_DIR, n), x) for n, x in zip(names, w)],
                  dt=DT, device="cpu")
    return j, p


def test_clips_are_byte_equal_copies():
    assert len(CLIPS) == 6
    assert sorted(os.listdir(PORT_DIR)) == CLIPS
    for name in CLIPS:
        with open(os.path.join(JAX_DIR, name), "rb") as a, \
                open(os.path.join(PORT_DIR, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("clip", CLIPS)
def test_bank_matches_jax(clip):
    j = JMotionLib(os.path.join(JAX_DIR, clip), dt=DT)
    p = MotionLib(os.path.join(PORT_DIR, clip), dt=DT, device="cpu")
    for f in j.data._fields:
        want = np.asarray(getattr(j.data, f))
        got = getattr(p.data, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=f)


def test_missing_clip_raises():
    with pytest.raises(FileNotFoundError):
        MotionLib(os.path.join(PORT_DIR, "no_such_clip.npy"), dt=DT,
                  device="cpu")


def _jax_ids_times(j, key, n, truncate=0.0):
    k1, k2 = jax.random.split(key)
    ids = j.sample_motions(k1, n)
    return ids, j.sample_time(k2, ids, truncate_t=truncate)


def test_padded_bank_and_weights(libs):
    j, p = libs
    for f in j.data._fields:
        np.testing.assert_allclose(getattr(p.data, f).numpy(),
                                   np.asarray(getattr(j.data, f)), rtol=0,
                                   atol=TOL, err_msg=f)
    # the run clip is the shortest: its rows past its end repeat its last
    n_run = int(p.data.num_frames[1])
    assert n_run < p.data.root_pos.shape[1]
    assert torch.equal(p.data.dof_pos[1, n_run:],
                       p.data.dof_pos[1, n_run - 1].expand_as(
                           p.data.dof_pos[1, n_run:]))


def test_motion_state_matches_jax(libs):
    """get_motion_state on JAX-drawn ids and times, past a clip's end
    and at its start too."""
    j, p = libs
    ids, times = _jax_ids_times(j, jax.random.PRNGKey(5), 256)
    times = np.asarray(times).copy()
    times[:8] = 0.0
    times[8:16] += 100.0           # clamped to the last interval
    ref = j.get_motion_state(ids, times)
    got = p.get_motion_state(torch.as_tensor(np.array(ids)),
                             torch.as_tensor(times))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    # the walk clip's root stays at standing heights (tests/test_amp.py)
    z = got["root_pos"][:, 2]
    assert (z > 0.3).all() and (z < 1.6).all()


def test_state_pairs_match_jax(libs):
    j, p = libs
    key = jax.random.PRNGKey(9)
    s0, s1 = j.sample_state_pairs(key, 64, DT)
    ids, times = _jax_ids_times(j, key, 64, truncate=DT)
    g0, g1 = p.sample_state_pairs(
        64, DT, draws=(torch.as_tensor(np.array(ids)),
                       torch.as_tensor(np.array(times))))
    for ref, got in ((s0, g0), (s1, g1)):
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=0, atol=TOL, err_msg=k)


def test_sampler_distribution(libs):
    """200,000 ids from the inverse CDF: each clip's share within 0.005 of
    its normalised weight (4.5 standard errors of the largest share); the
    times uniform in [0, length - truncate), each tenth of the span within
    0.005 of its 0.1 (7.5 standard errors)."""
    _, p = libs
    g = torch.Generator().manual_seed(0)
    ids = p.sample_motions(200_000, g)
    share = torch.bincount(ids, minlength=3).double() / ids.numel()
    np.testing.assert_allclose(share.numpy(), [1 / 6, 2 / 6, 3 / 6],
                               atol=0.005)
    t = p.sample_time(ids, g, truncate_t=DT)
    span = (p.data.length_s[ids] - DT)
    u = (t / span).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(np.histogram(u, bins=10, range=(0, 1))[0]
                               / u.size, 0.1, atol=0.005)
