"""Port reward reductions (plain version of the K3 kernel) vs tapnet_tpu.

`tapnet_torch.ops.reward.heightmap_reductions` on CPU tensors runs its plain
version, the one the CUDA kernel is held to on the card. It must be
bit-equal to the JAX kernel in interpret mode, and `batched_reward_terms` /
`batched_reward` bit-equal to the JAX env's `reward_terms` / rewards on
random-policy rollouts of three configs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_batch
from tapnet_tpu.ops import heightmap_reductions as jax_reductions
from tapnet_torch.ops import reward as RW


@pytest.mark.parametrize("shape", [(4, 1, 10, 1), (16, 2, 8, 8),
                                   (3, 3, 5, 7)])
def test_reductions_match_jax_kernel(shape):
    x = jax.random.randint(jax.random.key(0), shape, 0, 100, dtype=jnp.int32)
    mx_j, sm_j = jax_reductions(x, interpret=True)
    mx, sm = RW.heightmap_reductions(torch.from_numpy(np.array(x)))
    assert mx.dtype == sm.dtype == torch.int32
    np.testing.assert_array_equal(mx.numpy(), np.asarray(mx_j))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(sm_j))


@pytest.mark.parametrize("name", ["2d-basic", "3d-basic", "multi-container"])
def test_batched_reward_terms_match_env(name):
    cfg = CONFIGS[name]
    B = 16
    key = jax.random.key(0)
    batch = sample_batch(key, B, cfg)
    states, _, rewards = JE.rollout_batch(batch, jax.random.split(key, B),
                                          cfg, policy="random")
    want = jax.vmap(lambda s, i: jnp.stack(JE.reward_terms(s, i, cfg)))(
        states, batch)
    t = lambda x: torch.from_numpy(np.array(x))
    got = RW.batched_reward_terms(t(states.heightmap), t(states.placements),
                                  t(batch.dims))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  np.asarray(want))
    r = RW.batched_reward(t(states.heightmap), t(states.placements),
                          t(batch.dims), cfg.reward_terms)
    np.testing.assert_array_equal(r.numpy(), np.asarray(rewards))


def test_empty_heightmaps():
    hm = torch.zeros((4, 2, 8, 8), dtype=torch.int32)
    placements = torch.full((4, 10, 6), -1, dtype=torch.int32)
    dims = torch.ones((4, 10, 3), dtype=torch.int32)
    terms = RW.batched_reward_terms(hm, placements, dims)
    assert all((v == 0).all() for v in terms)
    assert (RW.batched_reward(hm, placements, dims, ("C", "P", "S"))
            == 0).all()


def test_wrong_dtype_raises():
    with pytest.raises(TypeError):
        RW.heightmap_reductions(torch.zeros((2, 1, 4, 1)))
