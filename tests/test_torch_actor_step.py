"""Port actor_select_step (plain version) vs the JAX actor_select_step kernel.

`tapnet_torch.ops.actor_step.actor_select_step_ref` — the plain PyTorch
version the CUDA kernel is held to on the card — against
`tapnet_tpu.ops.pallas_actor_step.actor_select_step(..., interpret=True)`
for one sampled decode step at hidden 48, batch 128, on the same weights
(flax init_params through convert.py) and the same mid-rollout state:
integer outputs bit-equal, logits and logp within rtol = atol = 1e-5
(accumulation order, SPEC.md §12 tier 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.ops import pallas_actor_step as JAS
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.convert import actor_from_flax
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.models.features import static_tokens
from tapnet_torch.models.tapnet import embed_static_T
from tapnet_torch.ops import actor_step as AS

HIDDEN, B = 48, 128


def _operands(cfg, actor, seed=5):
    """Batch-last operands of one decode step from a mid-rollout state."""
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    R_, A = cfg.num_rot, cfg.num_actions
    T = N * R_
    inst = sample_batch(R.key(seed), B, cfg)
    state = E.reset(inst, cfg)
    rng = np.random.default_rng(seed)
    prev = np.full((B,), -1, np.int32)
    for _ in range(N // 2):
        mask = E.action_mask(state, inst, cfg).numpy()
        u = rng.random(mask.shape) * mask
        prev = np.where(mask.any(1), u.argmax(1), -1).astype(np.int32)
        state = E.step(state, torch.from_numpy(prev), inst, cfg)
    static = static_tokens(inst, cfg)
    static_t4 = static.permute(2, 1, 0).reshape(4, T * B)
    with torch.no_grad():
        se_htb = embed_static_T(actor, static_t4).reshape(-1, T, B)
    upm, rotm = AS.precedence_bitmasks(inst, cfg)
    ops = [
        np.full((1, 1), (N // 2) / N, np.float32),
        state.packed.T.int().numpy(),
        state.heightmap.permute(1, 2, 3, 0).reshape(C * W, D, B).numpy(),
        state.placements.permute(1, 2, 0).reshape(N * 6, B).numpy(),
        prev[None],
        inst.dims[:, :, 0].T.numpy(), inst.dims[:, :, 1].T.numpy(),
        inst.dims[:, :, 2].T.numpy(),
        upm.numpy(), rotm.numpy(), AS.fits_planes(inst, cfg).numpy(),
        rng.gumbel(size=(A, B)).astype(np.float32),
        se_htb.permute(1, 0, 2).numpy(), se_htb.mean(1).numpy(),
        static_t4.reshape(4, T, B).numpy(), static.mean(1).T.numpy()]
    return [np.ascontiguousarray(o) for o in ops]


@pytest.mark.parametrize("name", ["2d-basic", "2d-rot"])
def test_actor_select_step_ref_matches_jax_kernel(name):
    cfg, jcfg = CONFIGS[name], JCONFIGS[name]
    flax_params = jax_init_params(jax.random.key(3), jcfg, HIDDEN)["actor"]
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            HIDDEN)
    ops = _operands(cfg, actor)
    with jax.default_matmul_precision("highest"):
        want = JAS.actor_select_step(
            *(jnp.asarray(o) for o in ops),
            JAS.head_operands(flax_params, jcfg, jnp.float32),
            cfg=jcfg, temperature=0.7, interpret=True)
    got = AS.actor_select_step(
        *(torch.from_numpy(o) for o in ops), AS.head_operands(actor, cfg),
        cfg, temperature=0.7)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for label, w, g in zip(labels, want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, label
        if label in ("logits", "logp"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=label)
        else:
            np.testing.assert_array_equal(g, w, err_msg=label)
    assert (got[3].numpy() >= 0).all()


def test_window_and_two_limbs_raise():
    assert not AS.eligible(CONFIGS["2d-rolling"])
    assert AS.eligible(CONFIGS["2d-basic"])
    with pytest.raises(NotImplementedError):
        AS._check_cfg(CONFIGS["2d-rolling"])
    with pytest.raises(NotImplementedError):
        AS._check_cfg(TAPConfig(num_blocks=34, min_blocks=20,
                                container_width=8, container_height=40,
                                target_width=8))
