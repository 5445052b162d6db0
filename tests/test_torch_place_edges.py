"""Edge cases of select + place against the JAX package.

K1, K2 and K4 split the argmax and the candidate scan over a tile's warps
and join the partial winners; these are the inputs where such a split can
go wrong: equal lb keys and duplicate score rows (the lowest index at the
max), mcs candidates with equal exact scores (ties to the lowest key), the
hard lb variant with no stable candidate, a 16 x 16 target (W*D = 256), 62
blocks (two precedence limbs) under a window, 16 (rotation, container)
pairs, a tight cap that strands blocks, and a batch of 37 (not a multiple
of a tile). `tapnet_torch.ops.policy_step.select_place_ref` and
`tapnet_torch.ops.env.fused_rollout_batch_ref`, the plain versions the
kernels are held to on the card (`chip_smoke.py` phase 19, on the same
configs), must give the JAX package's results bit for bit: its
`select_place` body as a jitted function and its general rollout
(`tapnet_tpu.env.core.rollout_batch`).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.env import core as JE
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.ops import pallas_policy_step as JPS
from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.ops import env as OE
from tapnet_torch.ops import policy_step as PS
from tapnet_torch.types import Instance

B = 37
CONFIGS = {
    "2d-basic": dict(),
    "2d-lb-hard": dict(allow_rot=True, reward_type="C+P+S-lb-hard"),
    "2d-mcs-soft": dict(reward_type="C+P+S-mcs-soft"),
    "3d-mcs-hard": dict(dim=3, container_width=6, container_depth=6,
                        container_height=6, target_width=6, target_depth=6,
                        num_containers=2, reward_type="C+P+S-mcs-hard"),
    "3d-16x16": dict(dim=3, container_width=16, container_depth=16,
                     container_height=16, target_width=16, target_depth=16,
                     num_containers=8, allow_rot=True),
    "2d-62-window": dict(num_blocks=62, min_blocks=40, container_width=16,
                         container_height=40, target_width=16, window=6,
                         allow_rot=True),
    "2d-rc16-capped": dict(num_containers=8, container_height=30,
                           allow_rot=True, target_height=9),
    "2d-capped-tight": dict(target_height=3, reward_type="C+P-lb-soft"),
}


@functools.cache
def _jax_select_place(name):
    return jax.jit(functools.partial(JPS.select_place,
                                     JTAPConfig(**CONFIGS[name])))


def _operands(cfg, inst, state, score):
    """Batch-last numpy operands of select_place at `state`."""
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    mask = E.action_mask(state, inst, cfg).T.int()
    score = np.where(mask.numpy() == 1, score, np.float32(-1e9))
    ops = (score, mask.numpy(), state.packed.T.int().numpy(),
           state.heightmap.permute(1, 2, 3, 0).reshape(C * W, D, -1).numpy(),
           state.placements.permute(1, 2, 0).reshape(N * 6, -1).numpy(),
           *(inst.dims[:, :, k].T.int().numpy() for k in range(3)))
    return [np.ascontiguousarray(x) for x in ops]


def _assert_select_place(name, cfg, ops):
    want = _jax_select_place(name)(*ops)
    got = PS.select_place_ref(cfg, *(torch.from_numpy(x) for x in ops))
    for label, w, g in zip(("packed", "hm", "plc", "act"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(
            g.shape), err_msg=f"{name} {label}")
    return got


@pytest.mark.parametrize("name", list(CONFIGS))
def test_select_place_edges_match_jax(name):
    """Two steps: from the empty state (every offset lands at 0: equal
    landing heights everywhere, equal mcs scores) with every score row
    duplicated from its neighbour, then after N/2 random steps."""
    cfg = TAPConfig(**CONFIGS[name])
    inst = sample_batch(R.key(5), B, cfg)
    state = E.reset(inst, cfg)
    rng = np.random.default_rng(6)
    A = cfg.num_actions
    score = rng.standard_normal((A, B)).astype(np.float32)
    score[1::2] = score[0::2][:A // 2]
    got = _assert_select_place(name, cfg, _operands(cfg, inst, state, score))
    if cfg.target_height == 0:
        assert (got[3].numpy() >= 0).all()
    for _ in range(cfg.num_blocks // 2):
        mask = E.action_mask(state, inst, cfg).numpy()
        u = rng.random(mask.shape) * mask
        a = np.where(mask.any(1), u.argmax(1), -1).astype(np.int32)
        state = E.step(state, torch.from_numpy(a), inst, cfg)
    score = rng.standard_normal((A, B)).astype(np.float32)
    _assert_select_place(name, cfg, _operands(cfg, inst, state, score))


def test_select_place_hard_without_stable_candidate():
    """lb-hard where no offset is stable (heights alternate 5, 0 under a
    2-wide block: the top cell never spans the centre): the soft winner;
    and where some offset is stable: the stable one."""
    name = "2d-lb-hard"
    cfg = TAPConfig(**CONFIGS[name])
    N, W = cfg.num_blocks, cfg.target_width
    inst = sample_batch(R.key(8), B, cfg)
    state = E.reset(inst, cfg)
    hm = np.zeros((B, 1, W, 1), np.int32)
    hm[:, 0, 0::2, 0] = 5
    hm[B // 2:, 0, 4:7, 0] = 5  # a flat top 3 wide: stable offsets
    dims = inst.dims.clone()
    dims[:, :, 0] = 2  # width 2, unrotated
    dims[:, :, 2] = 3  # height 3 (rotation makes it 3 wide)
    inst = inst._replace(dims=dims)
    state = state._replace(heightmap=torch.from_numpy(hm))
    score = np.full((cfg.num_actions, B), -5.0, np.float32)
    score[0] = 1.0  # block 0, unrotated
    ops = _operands(cfg, inst, state, score)
    ops[0], ops[1] = score, np.ones_like(ops[1])  # whatever precedence says
    got = _assert_select_place(name, cfg, ops)
    stable = got[2].numpy()[5]  # block 0's stable flag
    assert (stable[:B // 2] == 0).all() and (stable[B // 2:] == 1).all()
    assert (got[3].numpy() == 0).all()


def _jax_inputs(jcfg, seed):
    key = jax.random.key(seed)
    jinst = jax_sample_batch(key, B, jcfg)
    jkeys = jax.random.split(key, B)
    tinst = Instance(*(torch.from_numpy(np.array(x)) for x in jinst))
    tkeys = torch.from_numpy(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    return jinst, jkeys, tinst, tkeys


@pytest.mark.parametrize("name,policy", [
    ("2d-mcs-soft", "first"), ("2d-62-window", "random"),
    ("2d-rc16-capped", "first"), ("2d-capped-tight", "random")])
def test_fused_rollout_edges_match_jax(name, policy):
    cfg, jcfg = TAPConfig(**CONFIGS[name]), JTAPConfig(**CONFIGS[name])
    assert OE.eligible(cfg)
    jinst, jkeys, tinst, tkeys = _jax_inputs(jcfg, seed=12)
    s_j, a_j, _ = JE.rollout_batch(jinst, jkeys, jcfg, policy=policy)
    s_t, a_t, _ = OE.fused_rollout_batch_ref(tinst, tkeys, cfg, policy)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j),
                                  err_msg=f"{name} actions")
    for f in s_t._fields:
        np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                      np.asarray(getattr(s_j, f)),
                                      err_msg=f"{name} {f}")
    if cfg.target_height > 0:
        assert (a_t.numpy() < 0).any()  # the cap strands blocks
