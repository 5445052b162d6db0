"""The port's C++ env tier (`tapnet_torch.native`) against the JAX
package's (`tapnet_tpu.native`) and the port's oracle, bit for bit.

The port keeps a byte-for-byte copy of `tapenv.cc` and builds it with g++
into `tapnet_torch/_build/`; it must build here (g++ is on PATH), so these
tests run rather than skip. On the same instances (the port's sampler) and
draws: actions, heightmaps, placements, packed flags and the five integer
reward terms equal to the JAX package's binding on every CONFIG for
`random` and on two for `first`, on a hard variant with a finite height,
and equal to the port's oracle instance by instance; a `replay` of the
actions reproduces the rollout.
"""

import os

import numpy as np
import pytest
import torch

from tapnet_tpu import native as jnative
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_torch import native
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.oracle import oracle_rollout
from tapnet_torch.types import Instance

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HARD = dict(reward_type="C+P-lb-hard", allow_rot=True, target_height=6,
            container_height=12)


def test_native_builds_its_own_copy():
    assert native.is_available()
    src = os.path.join(ROOT, "tapnet_torch", "native", "tapenv.cc")
    ref = os.path.join(ROOT, "tapnet_tpu", "native", "tapenv.cc")
    with open(src, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    lib = str(native._target())
    assert os.path.exists(lib)
    assert os.path.dirname(lib) == os.path.join(ROOT, "tapnet_torch",
                                                "_build")


def _run_both(cfg, jcfg, policy, B=8, seed=17):
    key = R.key(seed)
    batch = sample_batch(key, B, cfg)
    rbits = (E.policy_bits(R.split(key, B), cfg, "random").numpy()
             if policy == "random" else None)
    got = native.rollout_batch(batch, cfg, policy, rbits=rbits)
    np_batch = Instance(*(x.numpy() for x in batch))
    want = jnative.rollout_batch(
        np_batch, jcfg, policy,
        rbits=None if rbits is None else rbits.astype(np.uint32))
    return batch, rbits, got, want


def _assert_same(got, want):
    (s1, a1, t1), (s2, a2, t2) = got, want
    assert np.array_equal(a1, a2)
    assert np.array_equal(t1, t2)
    for field in ("heightmap", "packed", "placements", "t"):
        x, y = getattr(s1, field), getattr(s2, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("name,policy", [(n, "random") for n in CONFIGS]
                         + [("2d-basic", "first"), ("3d-basic", "first")])
def test_native_matches_jax_native(name, policy):
    _, _, got, want = _run_both(CONFIGS[name], JCONFIGS[name], policy)
    _assert_same(got, want)


def test_native_hard_variant_and_finite_height():
    batch, rbits, got, want = _run_both(TAPConfig(**HARD),
                                        JTAPConfig(**HARD), "random", B=16,
                                        seed=23)
    _assert_same(got, want)
    assert (got[0].heightmap <= 6).all()


@pytest.mark.parametrize("name,policy", [("2d-basic", "random"),
                                         ("2d-rot", "first"),
                                         ("multi-container-capped", "random"),
                                         ("hard", "random")])
def test_native_matches_the_ports_oracle(name, policy):
    cfg = TAPConfig(**HARD) if name == "hard" else CONFIGS[name]
    key = R.key(5)
    B = 4
    batch = sample_batch(key, B, cfg)
    rbits = E.policy_bits(R.split(key, B), cfg, policy).numpy()
    state, actions, terms = native.rollout_batch(batch, cfg, policy,
                                                 rbits=rbits)
    for b in range(B):
        inst = Instance(*(np.asarray(x[b]) for x in batch))
        env, acts, _ = oracle_rollout(inst, cfg, policy,
                                      rbits=rbits[b].astype(np.uint32))
        assert np.array_equal(acts, actions[b])
        assert np.array_equal(env.state.heightmap, state.heightmap[b])
        assert np.array_equal(env.state.placements, state.placements[b])
        assert env.reward_ints() == tuple(int(v) for v in terms[b])


def test_native_replay_reproduces_the_rollout():
    cfg = CONFIGS["3d-basic"]
    key = R.key(2)
    batch = sample_batch(key, 6, cfg)
    rbits = E.policy_bits(R.split(key, 6), cfg, "random")
    s1, a1, t1 = native.rollout_batch(batch, cfg, "random", rbits=rbits)
    s2, a2, t2 = native.rollout_batch(batch, cfg, "replay",
                                      actions=torch.from_numpy(a1))
    assert np.array_equal(a1, a2) and np.array_equal(t1, t2)
    assert np.array_equal(s1.heightmap, s2.heightmap)
    with pytest.raises(ValueError):
        native.rollout_batch(batch, cfg, "random")
