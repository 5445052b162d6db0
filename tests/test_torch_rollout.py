"""The port's one-instance rollout and generic determinism assert against
tapnet_tpu's.

`tapnet_torch.env.core.rollout` against the jitted `tapnet_tpu.env.core.
rollout` on the six CONFIGS x {first, random}, two seeds each: the
instance made from one seed by both samplers (bit-equal), then the final
state, the actions and the reward bit for bit, and the port's rollout
equal to its own `rollout_batch` row. `utils.debug.assert_deterministic`
passes on a deterministic function and raises the JAX package's
AssertionError on one that is not.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tapnet_tpu
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_instance as jax_sample_instance
from tapnet_tpu.utils import debug as JD
import tapnet_torch
from tapnet_torch import random as R
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_instance
from tapnet_torch.types import Instance
from tapnet_torch.utils import debug as D


def one_instance(cfg, seed):
    """The port's instance of `key(seed)`: a batch of one, squeezed."""
    key = R.key(seed)
    return Instance(*(x[0] for x in sample_instance(key[None], cfg))), key


@functools.lru_cache(maxsize=None)
def jax_rollouts(name):
    """key -> (the JAX instance of the key, {policy: E.rollout(...)}), one
    jit per config for both policies."""
    jcfg = tapnet_tpu.CONFIGS[name]

    def run(key):
        inst = jax_sample_instance(key, jcfg)
        return inst, {p: JE.rollout(inst, key, jcfg, policy=p)
                      for p in ("first", "random")}

    return jax.jit(run)


def _equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert np.array_equal(got, want), (name, got, want)


@pytest.mark.parametrize("name,policy", list(itertools.product(
    tapnet_torch.CONFIGS, ("first", "random"))))
def test_rollout_matches_jax(name, policy):
    cfg = tapnet_torch.CONFIGS[name]
    for seed in (0, 1):
        jinst, runs = jax_rollouts(name)(jax.random.key(seed))
        tinst, tkey = one_instance(cfg, seed)
        for f in Instance._fields:
            _equal(f"instance {f}", getattr(tinst, f).numpy(),
                   getattr(jinst, f))
        jstate, jactions, jreward = runs[policy]
        state, actions, reward = E.rollout(tinst, tkey, cfg, policy)
        for f in state._fields:
            _equal(f"{name} {policy} seed {seed} state {f}",
                   getattr(state, f).numpy(), getattr(jstate, f))
        _equal(f"{name} {policy} actions", actions.numpy(), jactions)
        _equal(f"{name} {policy} reward", reward.numpy(), jreward)
        # a batch of one, squeezed: the row of rollout_batch
        bstate, bactions, breward = E.rollout_batch(
            Instance(*(x[None] for x in tinst)), tkey[None], cfg, policy)
        for f in state._fields:
            _equal(f"batch row {f}", getattr(state, f),
                   getattr(bstate, f)[0])
        _equal("batch row actions", actions, bactions[0])
        _equal("batch row reward", reward, breward[0])


def test_rollout_records_no_op_as_minus_one():
    """Under a tight cap blocks strand: the empty mask's step is -1 in both
    packages."""
    kw = dict(target_height=3, reward_type="C+P-lb-soft")
    cfg, jcfg = (tapnet_torch.TAPConfig(**kw), tapnet_tpu.TAPConfig(**kw))
    tinst, tkey = one_instance(cfg, 3)
    jkey = jax.random.key(3)
    _, actions, _ = E.rollout(tinst, tkey, cfg, "random")
    _, jactions, _ = JE.rollout(jax_sample_instance(jkey, jcfg), jkey, jcfg,
                                policy="random")
    assert (actions == -1).any()
    _equal("capped actions", actions.numpy(), jactions)


def test_assert_deterministic():
    cfg = tapnet_torch.CONFIGS["2d-rot"]
    tinst, tkey = one_instance(cfg, 0)
    D.assert_deterministic(E.rollout, tinst, tkey, cfg, "random", runs=3)
    D.assert_deterministic(lambda: {"a": torch.ones(2), "b": None,
                                    "c": (1.5, np.arange(3))})

    calls = itertools.count()
    with pytest.raises(AssertionError) as got:
        D.assert_deterministic(
            lambda: (torch.zeros(2), torch.full((2,), float(next(calls)))),
            runs=3)
    jcalls = itertools.count()
    with pytest.raises(AssertionError) as want:
        JD.assert_deterministic(
            lambda: (jnp.zeros(2), jnp.full((2,), float(next(jcalls)))),
            runs=3)
    assert str(got.value) == str(want.value) == (
        "non-deterministic result: run 1 vs run 2 differ")
    # a dtype change is a difference too
    flip = itertools.count()
    with pytest.raises(AssertionError):
        D.assert_deterministic(lambda: torch.zeros(
            2, dtype=torch.float32 if next(flip) == 0 else torch.float64))
