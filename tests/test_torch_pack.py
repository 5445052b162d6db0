"""The slice as a whole: tapnet_torch.pack() vs tapnet_tpu.pack().

2d-basic, hidden 48, batch 64, the same instances (JAX sampler), the same
weights (flax init_params through convert.py) and the same seed on both
sides, the port on its CPU reference path. Sampled and best-of-K decodes
must give equal actions, placements and heightmaps and rewards within 1e-6;
greedy too, since both sides take the lowest index on exact ties. The fused
rollout paths (the kernels' plain versions on CPU tensors) must reproduce
the JAX trajectories as well. The same three policies on a rolling config
(12 blocks of which 6-12 are real, window 4, rotation), where both sides
decode through the windowed head.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tapnet_tpu
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.train import rollout as JRO
import tapnet_torch
from tapnet_torch.convert import actor_from_flax
from tapnet_torch.train import rollout as RO
from tapnet_torch.types import Instance

HIDDEN, B = 48, 64


@pytest.fixture(scope="module")
def setup():
    jcfg = tapnet_tpu.CONFIGS["2d-basic"]
    cfg = tapnet_torch.CONFIGS["2d-basic"]
    key = jax.random.key(21)
    flax_params = jax_init_params(key, jcfg, HIDDEN)["actor"]
    instances = jax_sample_batch(jax.random.key(22), B, jcfg)
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            HIDDEN)
    inst_np = Instance(*(np.array(x) for x in instances))
    return jcfg, cfg, flax_params, instances, actor, inst_np


ROLLING = dict(num_blocks=12, min_blocks=6, container_width=8,
               container_height=12, target_width=8, window=4, allow_rot=True)


@pytest.fixture(scope="module")
def rolling_setup():
    jcfg = tapnet_tpu.TAPConfig(**ROLLING)
    cfg = tapnet_torch.TAPConfig(**ROLLING)
    flax_params = jax_init_params(jax.random.key(31), jcfg, HIDDEN)["actor"]
    instances = jax_sample_batch(jax.random.key(32), 32, jcfg)
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            HIDDEN)
    return (jcfg, cfg, flax_params, instances, actor,
            Instance(*(np.array(x) for x in instances)))


def _key(seed):
    k = jax.random.key(seed)
    return k, torch.from_numpy(
        np.asarray(jax.random.key_data(k)).astype(np.int64))


def _assert_plans_equal(got, want, cfg, n):
    np.testing.assert_array_equal(got.actions, np.asarray(want.actions))
    np.testing.assert_array_equal(got.states.placements,
                                  np.asarray(want.states.placements))
    np.testing.assert_array_equal(got.states.heightmap,
                                  np.asarray(want.states.heightmap))
    np.testing.assert_allclose(got.rewards, np.asarray(want.rewards),
                               rtol=1e-6, atol=1e-6)
    assert len(got) == n
    for i in range(n):
        assert ([dataclasses.astuple(s) for s in got.steps(i)]
                == [dataclasses.astuple(s) for s in want.steps(i)])
        assert got.complete(i)


@pytest.mark.parametrize("policy", ["greedy", "sample", "best"])
def test_pack_matches_jax(setup, policy):
    jcfg, cfg, flax_params, instances, actor, inst_np = setup
    jkey, tkey = _key(5)
    with jax.default_matmul_precision("highest"):
        want = tapnet_tpu.pack(instances, jcfg, actor_params=flax_params,
                               hidden=HIDDEN, policy=policy, key=jkey,
                               n_samples=4)
    got = tapnet_torch.pack(inst_np, cfg, actor, policy=policy, key=tkey,
                            n_samples=4, device="cpu")
    _assert_plans_equal(got, want, cfg, B)


@pytest.mark.parametrize("policy", ["greedy", "sample", "best"])
def test_pack_rolling_matches_jax(rolling_setup, policy):
    jcfg, cfg, flax_params, instances, actor, inst_np = rolling_setup
    jkey, tkey = _key(6)
    with jax.default_matmul_precision("highest"):
        want = tapnet_tpu.pack(instances, jcfg, actor_params=flax_params,
                               hidden=HIDDEN, policy=policy, key=jkey,
                               n_samples=4)
    got = tapnet_torch.pack(inst_np, cfg, actor, policy=policy, key=tkey,
                            n_samples=4, device="cpu")
    _assert_plans_equal(got, want, cfg, 32)
    n_total = np.asarray(instances.n_total)
    assert n_total.min() < cfg.num_blocks       # ragged block counts
    assert [len(got.steps(i)) for i in range(32)] == list(n_total)


@pytest.mark.parametrize("path", ["step_kernel", "actor_kernel"])
def test_fused_rollout_paths_match_jax(setup, path):
    """The fused rollouts, kernels' plain versions on CPU tensors, sampled
    decode: record and final state equal to the JAX general path."""
    jcfg, cfg, flax_params, instances, actor, inst_np = setup
    jkeys = jax.random.split(jax.random.key(9), B)
    tkeys = torch.from_numpy(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    with jax.default_matmul_precision("highest"):
        s_j, r_j, lp_j = JRO.rollout_batch_record(
            flax_params, instances, jkeys, jcfg, hidden=HIDDEN,
            step_kernel=False, actor_kernel=False)
    s_t, r_t, lp_t = RO.rollout_batch_record(
        actor, Instance(*(torch.from_numpy(x) for x in inst_np)), tkeys,
        cfg, **{path: True})
    for f in r_t._fields:
        np.testing.assert_array_equal(getattr(r_t, f).numpy(),
                                      np.asarray(getattr(r_j, f)), err_msg=f)
    for f in s_t._fields:
        np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                      np.asarray(getattr(s_j, f)), err_msg=f)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j),
                               rtol=1e-5, atol=1e-5)


def test_heuristic_policies_raise(setup):
    """The heuristic policies need no actor and give the JAX package's
    plans; what raises is an unknown policy and a learned policy without an
    actor (ValueError)."""
    jcfg, cfg, _, instances, _, inst_np = setup
    jkey, tkey = _key(17)
    for policy in ("first", "random"):
        want = tapnet_tpu.pack(instances, jcfg, policy=policy, key=jkey,
                               prefer_fused=False)
        got = tapnet_torch.pack(inst_np, cfg, policy=policy, key=tkey,
                                device="cpu")
        _assert_plans_equal(got, want, cfg, B)
    with pytest.raises(ValueError):
        tapnet_torch.pack(inst_np, cfg, policy="second", device="cpu")
    with pytest.raises(ValueError, match="needs an actor"):
        tapnet_torch.pack(inst_np, cfg, policy="greedy", device="cpu")


def test_policy_rollout_single_instance_matches_jax(setup):
    jcfg, cfg, flax_params, instances, actor, inst_np = setup
    jkey, tkey = _key(13)
    inst0 = jax.tree.map(lambda x: x[3], instances)
    with jax.default_matmul_precision("highest"):
        s_j, a_j, r_j, lp_j = JRO.policy_rollout(flax_params, inst0, jkey,
                                                 jcfg, hidden=HIDDEN)
    s_t, a_t, r_t, lp_t = RO.policy_rollout(
        actor, Instance(*(x[3] for x in inst_np)), tkey, cfg)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(s_t.placements.numpy(),
                                  np.asarray(s_j.placements))
    np.testing.assert_allclose(float(r_t), float(r_j), rtol=1e-6)
    np.testing.assert_allclose(float(lp_t), float(lp_j), rtol=1e-5,
                               atol=1e-5)
