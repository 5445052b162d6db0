"""The port's CPU oracle (`tapnet_torch.oracle`, the executable spec of
SPEC.md) against the JAX package's (`tapnet_tpu.oracle`) and against the
port's batched env.

Integer results must be bit-equal: generated instances (six CONFIGS x 2
seeds, and flat instances in a 3D frame), the precomputed threefry draws,
and first/random rollouts (actions, masks, final heightmaps and
placements, the integer reward terms and the float reward). The port's
oracle also equals `env.core.rollout_batch` on the same instances and keys
(the integer results bit-equal, the float reward within 1e-5, as the JAX
package's tests/test_parity.py holds its oracle to its env).
"""

import jax
import numpy as np
import pytest
import torch

from tapnet_tpu import oracle as JO
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.oracle.rollout import rollout_rbits as jrollout_rbits
from tapnet_torch import oracle as O
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.oracle.generator import mix_flat
from tapnet_torch.oracle.rollout import rollout_rbits
from tapnet_torch.types import Instance

SEEDS = (0, 5)


def _equal_instances(a, b, msg=""):
    for name, x, y in zip(Instance._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), f"{msg} {name}"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_instance_matches_jax(name):
    for seed in SEEDS:
        _equal_instances(O.generate_instance(R.key(seed), CONFIGS[name]),
                         JO.generate_instance(jax.random.key(seed),
                                              JCONFIGS[name]), seed)


def test_flat_instances_and_mix_draw_match_jax():
    from tapnet_tpu.oracle.generator import mix_flat as jmix_flat

    name = "multi-container"
    for seed in SEEDS:
        got = O.generate_instance(R.key(seed), CONFIGS[name], flat=True)
        _equal_instances(got, JO.generate_instance(
            jax.random.key(seed), JCONFIGS[name], flat=True), seed)
        assert (got.dims[:, 1] == 1).all()
    for seed in range(6):
        for p2d in (0.0, 0.3, 0.5, 1.0):
            assert mix_flat(R.key(seed), p2d) == jmix_flat(
                jax.random.key(seed), p2d)


def test_rollout_rbits_match_jax():
    for name in ("2d-basic", "2d-rolling"):
        for seed in SEEDS:
            got = rollout_rbits(R.key(seed), CONFIGS[name])
            want = jrollout_rbits(jax.random.key(seed), JCONFIGS[name])
            assert got.dtype == want.dtype == np.uint32
            assert np.array_equal(got, want)


@pytest.mark.parametrize("policy", ["first", "random"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_oracle_rollout_matches_jax(name, policy):
    cfg, jcfg = CONFIGS[name], JCONFIGS[name]
    seed = 3
    inst = O.generate_instance(R.key(seed), cfg)
    env, actions, masks = O.oracle_rollout(inst, cfg, policy, key=R.key(seed))
    jenv, jactions, jmasks = JO.oracle_rollout(
        JO.generate_instance(jax.random.key(seed), jcfg), jcfg, policy,
        key=jax.random.key(seed))
    assert np.array_equal(actions, jactions)
    assert np.array_equal(masks, jmasks)
    for field in ("heightmap", "packed", "placements", "t"):
        assert np.array_equal(getattr(env.state, field),
                              getattr(jenv.state, field)), field
    assert env.reward_ints() == jenv.reward_ints()
    assert env.reward_fractions() == jenv.reward_fractions()
    assert env.reward() == jenv.reward()
    if policy == "random":   # the precomputed stream is the inline one
        _, a2, _ = O.oracle_rollout(inst, cfg, policy,
                                    rbits=rollout_rbits(R.key(seed), cfg))
        assert np.array_equal(a2, actions)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_oracle_matches_the_ports_batched_env(name):
    cfg = CONFIGS[name]
    B = 3
    key = R.key(11)
    batch = sample_batch(key, B, cfg)
    keys = R.split(key, B)
    for policy in ("first", "random"):
        state, actions, rewards = E.rollout_batch(batch, keys, cfg, policy)
        terms = torch.stack(list(E.reward_terms(state, batch, cfg)), 1)
        rbits = E.policy_bits(keys, cfg, policy).numpy().astype(np.uint32)
        for b in range(B):
            inst = Instance(*(np.asarray(x[b]) for x in batch))
            env, acts, _ = O.oracle_rollout(inst, cfg, policy,
                                            rbits=rbits[b])
            assert np.array_equal(acts, actions[b].numpy()), (policy, b)
            assert np.array_equal(env.state.heightmap,
                                  state.heightmap[b].numpy())
            assert np.array_equal(env.state.placements,
                                  state.placements[b].numpy())
            assert np.array_equal(env.state.packed, state.packed[b].numpy())
            assert env.reward_ints() == tuple(int(v) for v in terms[b])
            # the oracle rounds the float64 sum of the float32 terms, the
            # env sums in float32: 1e-5, as tests/test_parity.py holds it
            assert abs(env.reward() - float(rewards[b])) < 1e-5
