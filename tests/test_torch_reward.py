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


# ---- the fused reward (one launch on the card): its plain version against
# the JAX package's Pallas kernel in interpret mode, bit for bit

def _np_i32(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _fused_vs_jax(hm, plc, dims, terms_cfg):
    """fused_reward on CPU tensors (the plain version) against
    tapnet_tpu.ops.pallas_reward in interpret mode: maxh, under, the five
    terms and the reward, bit-equal."""
    from tapnet_tpu.ops.pallas_reward import (batched_reward,
                                              batched_reward_terms)
    maxh, under, terms, rew = RW.fused_reward(hm, plc, dims, terms_cfg)
    j = [jnp.asarray(_np_i32(x)) for x in (hm, plc, dims)]
    mx_j, sm_j = jax_reductions(j[0], interpret=True)
    np.testing.assert_array_equal(maxh.numpy(), np.asarray(mx_j))
    np.testing.assert_array_equal(under.numpy(), np.asarray(sm_j))
    terms_j = batched_reward_terms(*j, interpret=True)
    for a, b in zip(terms, terms_j):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rew_j = np.asarray(batched_reward(*j, terms_cfg, interpret=True))
    assert rew.dtype == torch.float32
    np.testing.assert_array_equal(rew.numpy().view(np.int32),
                                  rew_j.view(np.int32))
    for a, b in zip(RW.batched_reward_terms(hm, plc, dims), terms):
        assert torch.equal(a, b)
    assert torch.equal(RW.batched_reward(hm, plc, dims, terms_cfg), rew)
    return terms


def _port_rollout(cfg, B, seed, policy="random"):
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.env.sampler import sample_batch
    inst = sample_batch(R.key(seed), B, cfg)
    state, _, _ = E.rollout_batch(inst, R.split(R.key(seed + 1), B), cfg,
                                  policy)
    return state, inst


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_reward_matches_jax_kernel(name):
    from tapnet_torch import CONFIGS as TCONFIGS
    cfg = TCONFIGS[name]
    state, inst = _port_rollout(cfg, 16, 5)
    _fused_vs_jax(state.heightmap, state.placements, inst.dims,
                  cfg.reward_terms)
    # the configured order and a subset of the terms
    _fused_vs_jax(state.heightmap, state.placements, inst.dims, ("S", "C"))


def test_fused_reward_zero_heightmaps():
    hm = torch.zeros((6, 2, 8, 8), dtype=torch.int32)
    plc = torch.full((6, 10, 6), -1, dtype=torch.int32)
    dims = torch.ones((6, 10, 3), dtype=torch.int32)
    terms = _fused_vs_jax(hm, plc, dims, ("C", "P", "S"))
    assert all((t == 0).all() for t in terms)


def test_fused_reward_capped_partial_plans():
    """Under a tight cap blocks stay unplaced: placements hold -1 rows."""
    from tapnet_torch import TAPConfig
    cfg = TAPConfig(num_containers=2, container_width=6, container_height=8,
                    target_width=6, target_height=3, allow_rot=True)
    state, inst = _port_rollout(cfg, 24, 9, "first")
    unplaced = state.placements[:, :, 0] < 0
    assert unplaced.any() and (~unplaced).any()
    _fused_vs_jax(state.heightmap, state.placements, inst.dims,
                  cfg.reward_terms)


def test_fused_reward_checks_operands():
    hm = torch.zeros((2, 1, 4, 1), dtype=torch.int32)
    plc = torch.full((2, 3, 6), -1, dtype=torch.int32)
    dims = torch.ones((2, 3, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        RW.fused_reward(hm, plc.long(), dims)
    with pytest.raises(ValueError):
        RW.fused_reward(hm, plc, dims, ("C", "X"))
