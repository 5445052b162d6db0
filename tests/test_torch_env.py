"""The port's sampler and env against tapnet_tpu.env.

sample_batch bit-equal on all six configs; reset / action_mask / step /
reward_terms bit-equal along first-fit trajectories driven by the same
actions (every config uses the lb rule); reward within 1e-7.
"""

import jax
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.types import Instance

B = 32


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sampler_and_env_bit_equal(name):
    cfg, jcfg = CONFIGS[name], JCONFIGS[name]
    jinst = jax_sample_batch(jax.random.key(5), B, jcfg)
    tinst = sample_batch(R.key(5), B, cfg)
    for f in Instance._fields:
        np.testing.assert_array_equal(getattr(tinst, f).numpy(),
                                      np.asarray(getattr(jinst, f)),
                                      err_msg=f)

    reset = jax.jit(jax.vmap(lambda i: JE.reset(i, jcfg)))
    mask_fn = jax.jit(jax.vmap(lambda s, i: JE.action_mask(s, i, jcfg)))
    step_fn = jax.jit(jax.vmap(lambda s, a, i: JE.step(s, a, i, jcfg)))
    terms_fn = jax.jit(jax.vmap(lambda s, i: JE.reward_terms(s, i, jcfg)))
    reward_fn = jax.jit(jax.vmap(lambda s, i: JE.reward(s, i, jcfg)))

    js, ts = reset(jinst), E.reset(tinst, cfg)
    steps = min(cfg.num_blocks, 20)
    for t in range(steps + 1):
        for f in ts._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{f} at step {t}")
        for got, want in zip(E.reward_terms(ts, tinst, cfg),
                             terms_fn(js, jinst)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(E.reward(ts, tinst, cfg).numpy(),
                                   np.asarray(reward_fn(js, jinst)),
                                   rtol=1e-7, atol=1e-7)
        if t == steps:
            break
        jm = np.asarray(mask_fn(js, jinst))
        np.testing.assert_array_equal(E.action_mask(ts, tinst, cfg).numpy(),
                                      jm)
        a = np.where(jm.any(1), jm.argmax(1), -1).astype(np.int32)
        js = step_fn(js, a, jinst)
        ts = E.step(ts, torch.from_numpy(a), tinst, cfg)
