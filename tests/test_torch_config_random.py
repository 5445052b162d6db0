"""The port's configs and threefry stream against the JAX package.

Every config must be field-equal to tapnet_tpu.config.CONFIGS; threefry
split / fold_in / bits bit-equal to jax.random (partitionable threefry, the
JAX default here); uniform bit-equal; gumbel within 2 ulp (log may round
differently).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tapnet_tpu import config as JC
from tapnet_torch import config as TC
from tapnet_torch import random as R

SEEDS = [0, 1, 7, 123, 2**31 - 1, 4_000_000_000]


def test_configs_field_equal():
    assert list(TC.CONFIGS) == list(JC.CONFIGS)
    for name, cfg in TC.CONFIGS.items():
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(JC.CONFIGS[name])), name
        j = JC.CONFIGS[name]
        for prop in ("num_rot", "rot_axes", "split_axes", "num_actions",
                     "height_cap", "reward_terms", "placement_rule",
                     "placement_variant"):
            assert getattr(cfg, prop) == getattr(j, prop), (name, prop)
        a = np.arange(cfg.num_actions)
        for x, y in zip(cfg.decompose_action(a), j.decompose_action(a)):
            np.testing.assert_array_equal(x, y)


def test_config_validation():
    with pytest.raises(ValueError):
        TC.TAPConfig(dim=4)
    with pytest.raises(ValueError):
        TC.TAPConfig(reward_type="C+C-lb-soft")


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_threefry_bit_equal():
    assert jax.config.jax_threefry_partitionable
    for seed in SEEDS:
        jk, tk = jax.random.key(seed), R.key(seed)
        np.testing.assert_array_equal(tk.numpy(), _kd(jk))
        np.testing.assert_array_equal(R.split(tk, 37).numpy(),
                                      _kd(jax.random.split(jk, 37)))
        for d in (0, 5, 10**6):
            np.testing.assert_array_equal(R.fold_in(tk, d).numpy(),
                                          _kd(jax.random.fold_in(jk, d)))
        np.testing.assert_array_equal(
            R.bits(tk, (4, 9)).numpy(),
            np.asarray(jax.random.bits(jk, (4, 9), dtype=np.uint32)))
        np.testing.assert_array_equal(
            R.uniform(tk, (300,)).numpy(),
            np.asarray(jax.random.uniform(jk, (300,))))


def test_batched_keys_bit_equal():
    """Batched key ops (leading axes) as the sampler and rollout use them."""
    jks = jax.random.split(jax.random.key(3), 64)
    tks = torch.from_numpy(_kd(jks))
    want = jax.vmap(lambda k: jax.random.key_data(
        jax.random.split(jax.random.fold_in(k, 17), 3)))(jks)
    np.testing.assert_array_equal(R.split(R.fold_in(tks, 17), 3).numpy(),
                                  np.asarray(want).astype(np.int64))
    want_bits = jax.vmap(lambda k: jax.random.bits(k, dtype=np.uint32))(jks)
    np.testing.assert_array_equal(R.bits(tks).numpy(), np.asarray(want_bits))


def test_gumbel_within_2_ulp():
    """Each of gumbel's two logs within 2 ulp of JAX's; the outer log's
    result then moves by at most its own 2 ulp plus the inner error carried
    through d(-log L) = -dL / L."""
    tiny = float(np.finfo(np.float32).tiny)
    for seed in SEEDS[:4]:
        jk, tk = jax.random.key(seed), R.key(seed)
        u = np.asarray(jax.random.uniform(jk, (4000,), minval=tiny))
        np.testing.assert_array_equal(
            R.uniform(tk, (4000,), minval=tiny).numpy(), u)
        inner_j = np.asarray(-jax.numpy.log(u))
        inner_t = (-torch.log(torch.from_numpy(np.array(u)))).numpy()
        assert np.all(np.abs(inner_t - inner_j) <= 2 * np.spacing(inner_j))
        want = np.asarray(jax.random.gumbel(jk, (4000,)))
        got = R.gumbel(tk, (4000,)).numpy()
        bound = (2 * np.spacing(np.abs(want))
                 + 2 * np.spacing(inner_j) / inner_j)
        assert np.all(np.abs(got - want) <= bound), seed
