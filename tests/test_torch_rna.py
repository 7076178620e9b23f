"""The port's Random Network Adversary
(isaacgymenvs_ma_tpu_torch/utils/rna_util.py) against the JAX package's
(isaacgymenvs_ma_tpu/utils/rna_util.py): the forward pass with the JAX
network's flax parameters carried across by
``convert.rna_state_dict_from_jax`` (1e-5), and ``refresh`` with the JAX
refresh's uniforms injected (exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.utils.rna_util import (
    RandomNetworkAdversary as JRNA)
from isaacgymenvs_ma_tpu_torch.convert import rna_state_dict_from_jax
from isaacgymenvs_ma_tpu_torch.utils.rna_util import RandomNetworkAdversary

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


@pytest.fixture(scope="module")
def rna_pair():
    """Dextreme's RNA (16 dofs in, 16 actions, two layers of 256) in both
    packages with the JAX one's parameters (``PRNGKey(97)``, as the task
    draws them)."""
    j = JRNA(num_obs=16, num_actions=16, units=(256, 256))
    st = j.init(jax.random.PRNGKey(97))
    t = RandomNetworkAdversary(16, 16, units=(256, 256))
    t.load_state_dict(rna_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, st.params)))
    return j, st, t


def test_forward_matches_jax(rna_pair):
    j, st, t = rna_pair
    obs = np.random.default_rng(0).uniform(-1, 1, (64, 16)).astype(
        np.float32)
    want = np.asarray(j(st, jnp.asarray(obs)))
    masks = tuple(torch.tensor(np.asarray(m)) for m in st.masks)
    got = t(torch.as_tensor(obs), masks)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert got.shape == (64, 16) and float(got.abs().max()) <= 1.0
    # the masks gate the hidden units: all-ones masks change the output
    ones = tuple(torch.ones(256) for _ in range(2))
    assert not torch.allclose(t(torch.as_tensor(obs), ones), got)


def test_refresh_with_injected_uniforms(rna_pair):
    j, st, t = rna_pair
    fresh = j.refresh(st)
    _, *ks = jax.random.split(st.key, 3)
    u = tuple(torch.tensor(np.asarray(jax.random.uniform(k, (256,))))
              for k in ks)
    got = t.refresh(u=u)
    for a, b in zip(got, fresh.masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert set(np.unique(a.numpy())) <= {0.0, 2.0}


def test_generator_weights_and_masks_are_seeded():
    """Without the JAX parameters the weights come from the task's
    generator: LeCun-normal kernels, zero biases, the same for the same
    seed; the masks keep about half the units."""
    def build(seed):
        t = RandomNetworkAdversary(16, 16, units=(256, 256))
        g = torch.Generator().manual_seed(seed)
        t.init_weights(g)
        return t, t.refresh(g)
    (a, ma), (b, mb) = build(3), build(3)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))
    w0 = a.fc[0].weight
    assert abs(float(w0.std()) - (1 / 16) ** 0.5) < 0.03
    assert float(w0.abs().max()) <= 2.0 * (1 / 16) ** 0.5 / 0.8796 + 1e-6
    assert float(a.out.bias.abs().max()) == 0.0
    assert 0.35 < float((ma[0] > 0).float().mean()) < 0.65
