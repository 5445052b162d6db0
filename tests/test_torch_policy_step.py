"""Port select_step (plain version) vs the JAX select_step kernel.

`tapnet_torch.ops.policy_step.select_place_ref` — the plain PyTorch version
the CUDA kernel is held to on the card — must give every output of
`tapnet_tpu.ops.pallas_policy_step.select_step(..., interpret=True)` bit for
bit: one step at batch 128 from a mid-rollout state, with the same seeded
scores and masks on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.ops import pallas_policy_step as JPS
from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.ops import policy_step as PS

CAPPED_HARD = dict(allow_rot=True, target_height=12,
                   reward_type="C+P+S-lb-hard")
CASES = {
    "2d-basic": (CONFIGS["2d-basic"], JCONFIGS["2d-basic"]),
    "2d-rot": (CONFIGS["2d-rot"], JCONFIGS["2d-rot"]),
    "3d-basic": (CONFIGS["3d-basic"], JCONFIGS["3d-basic"]),
    "2d-capped-hard": (TAPConfig(**CAPPED_HARD), JTAPConfig(**CAPPED_HARD)),
}


def _mid_rollout_state(cfg, B, seed):
    """Instances and a state after N/2 random feasible steps."""
    inst = sample_batch(R.key(seed), B, cfg)
    state = E.reset(inst, cfg)
    rng = np.random.default_rng(seed)
    for _ in range(cfg.num_blocks // 2):
        mask = E.action_mask(state, inst, cfg).numpy()
        u = rng.random(mask.shape) * mask
        a = np.where(mask.any(1), u.argmax(1), -1).astype(np.int32)
        state = E.step(state, torch.from_numpy(a), inst, cfg)
    return inst, state


@pytest.mark.parametrize("name", list(CASES))
def test_select_place_ref_matches_jax_kernel(name):
    cfg, jcfg = CASES[name]
    B = 128
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    inst, state = _mid_rollout_state(cfg, B, seed=7)
    mask = E.action_mask(state, inst, cfg).T.int().contiguous()     # [A, B]
    rng = np.random.default_rng(11)
    logits = rng.standard_normal(mask.shape).astype(np.float32)
    # ties: duplicate every other logit row so lowest-index argmax matters
    logits[1::2] = logits[0::2][:logits[1::2].shape[0]]
    score = np.where(mask.numpy() == 1, logits, np.float32(-1e9))
    ops = dict(
        score=score,
        mask=mask.numpy(),
        packed=state.packed.T.int().numpy(),
        hm=state.heightmap.permute(1, 2, 3, 0).reshape(C * W, D, B).numpy(),
        plc=state.placements.permute(1, 2, 0).reshape(N * 6, B).numpy(),
        dims_w=inst.dims[:, :, 0].T.numpy(),
        dims_d=inst.dims[:, :, 1].T.numpy(),
        dims_h=inst.dims[:, :, 2].T.numpy())
    ops = {k: np.ascontiguousarray(v) for k, v in ops.items()}

    want = JPS.select_step(*(jnp.asarray(v) for v in ops.values()),
                           cfg=jcfg, interpret=True)
    got = PS.select_step(*(torch.from_numpy(v) for v in ops.values()),
                         cfg=cfg)
    for label, w, g in zip(("packed", "hm", "plc", "act"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=label)
    # the step really placed blocks
    assert (got[3].numpy() >= 0).any()


def test_mcs_raises():
    """Under the mcs rule nothing raises: on an empty state with an empty
    mask the step is a no-op (act -1, nothing written), and the kernels'
    EnvCfg carries the rule and the reward-term set. The rule itself is
    held to the JAX kernel in tests/test_torch_mcs.py."""
    cfg = TAPConfig(reward_type="C+P+S-mcs-soft")
    z = torch.zeros((cfg.num_actions, 4))
    zi = torch.zeros((cfg.num_blocks, 4), dtype=torch.int32)
    hm = torch.zeros((10, 1, 4), dtype=torch.int32)
    plc = torch.full((60, 4), -1, dtype=torch.int32)
    packed, hm_n, plc_n, act = PS.select_step(
        z, z.int(), zi, hm, plc, zi + 1, zi + 1, zi + 1, cfg=cfg)
    assert (act == -1).all() and torch.equal(hm_n, hm)
    assert torch.equal(plc_n, plc) and torch.equal(packed, zi)
    assert PS.env_ints(cfg)[-2:] == [1, 7]
    assert PS.env_ints(TAPConfig(reward_type="P+S-lb-hard"))[-2:] == [0, 6]
