"""Port actor_select_step (plain versions) vs the JAX actor_select_step kernel.

`tapnet_torch.ops.actor_step.actor_select_step_ref` — the plain PyTorch
version of the full mode the CUDA kernel is held to on the card — against
`tapnet_tpu.ops.pallas_actor_step.actor_select_step(..., interpret=True)`
for one sampled decode step at hidden 48, batch 128, on the same weights
(flax init_params through convert.py) and the same mid-rollout state:
integer outputs bit-equal, logits and logp within rtol = atol = 1e-5
(accumulation order, SPEC.md §12 tier 2). The same on a rolling config
(12 blocks, window 4, rotation) and on a two-limb one (34 blocks, window 6):
the window rank, flag bit 3, the windowed mask and the second precedence
limb against the Pallas kernel, one step each.

The decode loop's mode, `actor_select_step_live_ref` (token work on the
live columns only, no logits): the live-column rule on a hand-built mask;
against the full plain version on 2d-basic, the 12-block rolling config
and a two-container mcs config (integer outputs equal, logp within 1e-6);
against the Pallas kernel on the same inputs (integer outputs equal, logp
within 1e-5 relative); and a whole sampled rollout of the 12-block config
through `rollout_batch_record(actor_kernel=True)`, which runs that mode,
on both sides (12 interpret-mode steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.config import TAPConfig as JTAPConfig
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.train import rollout as JRO
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
from tapnet_torch.train import rollout as RO
from tapnet_torch.types import Instance

HIDDEN, B = 48, 128
ROLLING = {
    "rolling-small": dict(num_blocks=12, min_blocks=6, container_width=8,
                          container_height=12, target_width=8, window=4,
                          allow_rot=True),
    "two-limb": dict(num_blocks=34, min_blocks=20, container_width=8,
                     container_height=40, target_width=8, window=6),
}


# two containers under the mcs rule
CUSTOM = dict(ROLLING, **{"mcs-2c": dict(num_containers=2,
                                         container_height=20, allow_rot=True,
                                         reward_type="C+P+S-mcs-soft")})


def _configs(name):
    if name in CUSTOM:
        return TAPConfig(**CUSTOM[name]), JTAPConfig(**CUSTOM[name])
    return CONFIGS[name], JCONFIGS[name]


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


def _port_ops(ops):
    """The port's operands from the JAX kernel's: se [T, h, B] as the rows
    [B, T, h]."""
    t = [torch.from_numpy(o) for o in ops]
    t[12] = t[12].permute(2, 0, 1).contiguous()
    return t


@pytest.mark.parametrize("name", ["2d-basic", "2d-rot", "rolling-small",
                                  "two-limb"])
def test_actor_select_step_ref_matches_jax_kernel(name):
    cfg, jcfg = _configs(name)
    flax_params = jax_init_params(jax.random.key(3), jcfg, HIDDEN)["actor"]
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            HIDDEN)
    ops = _operands(cfg, actor)
    with jax.default_matmul_precision("highest"):
        want = JAS.actor_select_step(
            *(jnp.asarray(o) for o in ops),
            JAS.head_operands(flax_params, jcfg, jnp.float32),
            cfg=jcfg, temperature=0.7, interpret=True)
    got = AS.actor_select_step(*_port_ops(ops), AS.head_operands(actor, cfg),
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
    if cfg.min_blocks == cfg.num_blocks:
        assert (got[3].numpy() >= 0).all()
    else:   # ragged block counts: the shortest instances are done
        assert (got[3].numpy() >= 0).any()
    if cfg.window > 0:   # window bits: accessible blocks, at most `window`
        flags = got[4].numpy()
        assert (((flags >> 3) & 1).sum(0) <= cfg.window).all()
        assert (((flags >> 3) & 1) <= ((flags >> 1) & 1)).all()
    assert ops[8].shape[0] == AS._num_limbs(cfg.num_blocks) * cfg.num_blocks


def test_live_columns_rule():
    """Columns: (instance, token) pairs whose mask allows the token in some
    container, by instance then token; an instance without a valid action
    has none."""
    cfg = TAPConfig(num_blocks=3, min_blocks=3, container_width=4,
                    container_height=4, target_width=4, allow_rot=True,
                    num_containers=2)
    T_, C = 6, 2
    mask = torch.zeros((T_, C, 3), dtype=torch.int32)
    mask[4, :, 0] = mask[1, :, 0] = 1       # instance 0: tokens 1, 4
    mask[0, :, 2] = 1                       # instance 2: token 0
    b, t = AS.live_columns(mask.reshape(T_ * C, 3), cfg)
    assert b.tolist() == [0, 0, 2] and t.tolist() == [1, 4, 0]


def _plain_ops(name, seed=5):
    cfg, _ = _configs(name)
    actor = actor_from_flax(jax.tree.map(np.asarray, jax_init_params(
        jax.random.key(3), _configs(name)[1], HIDDEN)["actor"]), cfg, HIDDEN)
    return cfg, actor, _operands(cfg, actor, seed)


@pytest.mark.parametrize("name", ["2d-basic", "rolling-small", "mcs-2c"])
def test_live_ref_matches_full_ref(name):
    """The decode loop's mode against the full plain version on the same
    inputs: integer outputs equal, logp within 1e-6, no logits."""
    cfg, actor, ops = _plain_ops(name)
    ops = _port_ops(ops)
    params = AS.head_operands(actor, cfg)
    full = AS.actor_select_step_ref(*ops, params, cfg, temperature=0.7)
    live = AS.actor_select_step(*ops, params, cfg, temperature=0.7,
                                logits=False)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for label, f, g in zip(labels, full, live):
        if label == "logits":
            assert g is None
        elif label == "logp":
            np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=0,
                                       atol=1e-6)
        else:
            assert torch.equal(g, f), label
    # some instances act, and most tokens are dead
    b, _ = AS.live_columns(full[5], cfg)
    assert 0 < b.numel() < ops[1].shape[1] * cfg.num_blocks * cfg.num_rot


@pytest.mark.parametrize("name", ["2d-basic", "rolling-small", "mcs-2c"])
def test_live_ref_matches_jax_kernel(name):
    cfg, jcfg = _configs(name)
    flax_params = jax_init_params(jax.random.key(3), jcfg, HIDDEN)["actor"]
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            HIDDEN)
    ops = _operands(cfg, actor, seed=7)
    with jax.default_matmul_precision("highest"):
        want = JAS.actor_select_step(
            *(jnp.asarray(o) for o in ops),
            JAS.head_operands(flax_params, jcfg, jnp.float32),
            cfg=jcfg, temperature=1.0, interpret=True)
    got = AS.actor_select_step_live_ref(*_port_ops(ops),
                                        AS.head_operands(actor, cfg), cfg)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for label, w, g in zip(labels, want, got):
        if label == "logits":
            assert g is None
        elif label == "logp":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=label)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=label)


def test_rolling_rollout_matches_jax_kernel_rollout(monkeypatch):
    """A whole sampled rollout of the 12-block rolling config, hidden 32:
    the port's actor-fused path (plain K2 on CPU tensors, in the decode
    loop's live-column mode, every step) vs the JAX actor-fused path with
    the Pallas kernel in interpret mode."""
    live_steps = []
    live_ref = AS.actor_select_step_live_ref
    monkeypatch.setattr(AS, "actor_select_step_live_ref", lambda *a, **k: (
        live_steps.append(1), live_ref(*a, **k))[1])
    cfg, jcfg = _configs("rolling-small")
    hidden = 32
    params = jax_init_params(jax.random.key(4), jcfg, hidden)["actor"]
    instances = jax_sample_batch(jax.random.key(5), B, jcfg)
    jkeys = jax.random.split(jax.random.key(6), B)
    with jax.default_matmul_precision("highest"):
        s_j, r_j, lp_j = jax.jit(lambda p, i, k: JRO.rollout_batch_record(
            p, i, k, jcfg, hidden=hidden, actor_kernel=True,
            interpret=True))(params, instances, jkeys)
    actor = actor_from_flax(jax.tree.map(np.asarray, params), cfg, hidden)
    t = lambda x: torch.from_numpy(np.array(x))
    keys = torch.from_numpy(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    s_t, r_t, lp_t = RO.rollout_batch_record(
        actor, Instance(*(t(x) for x in instances)), keys, cfg,
        actor_kernel=True)
    for f in r_t._fields:
        np.testing.assert_array_equal(getattr(r_t, f).numpy(),
                                      np.asarray(getattr(r_j, f)), err_msg=f)
    for f in s_t._fields:
        np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                      np.asarray(getattr(s_j, f)), err_msg=f)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-4,
                               atol=1e-4)
    assert len(live_steps) == cfg.num_blocks


@pytest.mark.parametrize("live", [False, True])
def test_hidden_256_matches_jax_kernel(live):
    """Hidden 256, the widest the CUDA kernel covers (its head runs once
    over the tile on the weight ring there): the plain full mode (logits and logp
    within 1e-5) and the plain live mode (logp within 1e-5 relative, no
    logits) against the Pallas kernel in interpret mode on one sampled
    2d-basic step at batch 128; integer outputs bit-equal."""
    cfg, jcfg = _configs("2d-basic")
    hidden = 256
    assert AS.eligible(cfg, hidden) and AS.eligible(cfg, hidden,
                                                    torch.bfloat16)
    flax_params = jax_init_params(jax.random.key(3), jcfg, hidden)["actor"]
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg,
                            hidden)
    ops = _operands(cfg, actor, seed=7)
    temperature = 1.0 if live else 0.7
    with jax.default_matmul_precision("highest"):
        want = JAS.actor_select_step(
            *(jnp.asarray(o) for o in ops),
            JAS.head_operands(flax_params, jcfg, jnp.float32),
            cfg=jcfg, temperature=temperature, interpret=True)
    ref = AS.actor_select_step_live_ref if live else AS.actor_select_step_ref
    got = ref(*_port_ops(ops), AS.head_operands(actor, cfg), cfg,
              temperature=temperature)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for label, w, g in zip(labels, want, got):
        if label == "logits" and live:
            assert g is None
        elif label in ("logits", "logp"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6 if live else 1e-5,
                                       err_msg=label)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=label)
    assert (got[3].numpy() >= 0).all()


def test_window_and_two_limbs_raise():
    """Coverage of the actor kernel: rolling windows and two limbs are in
    (they no longer raise), a finite cap and N > 62 are out, as in the JAX
    kernel."""
    two_limb = TAPConfig(**ROLLING["two-limb"])
    for cfg in (CONFIGS["2d-basic"], CONFIGS["2d-rolling"], two_limb,
                CONFIGS["multi-container"]):
        assert AS.eligible(cfg)
        AS._check_cfg(cfg)
        assert AS.eligible(cfg) == JAS.eligible(
            JTAPConfig(**{f: getattr(cfg, f) for f in
                          cfg.__dataclass_fields__}))
    assert AS._num_limbs(31) == 1 and AS._num_limbs(32) == 2
    assert AS._num_limbs(62) == 2
    too_many = TAPConfig(num_blocks=63, min_blocks=20, container_width=8,
                         container_height=40, target_width=8)
    for cfg in (CONFIGS["multi-container-capped"], too_many):
        assert not AS.eligible(cfg)
        with pytest.raises(NotImplementedError):
            AS._check_cfg(cfg)
    assert AS.smem_bytes(CONFIGS["2d-rolling"], 128) <= AS.SMEM_LIMIT


def _smem_rule(cfg, h, dtype):
    """csrc/actor_step.cu's shared-memory plan written out, in bytes: the
    float regions (Wp, W8, b8, v, the C queries, the scores, the encoder's
    [feature][instance] arrays, the token view) and the ints behind them.
    Up to hidden 128 the head's arrays hold the tile's 32 instances (row
    stride 33) and a token group is 64 columns; the float32 token view
    also holds a weight slice of 64 rows of h; the bfloat16 instantiation
    holds Wp as bfloat16 rows of 40 (20 h floats), and its token view holds
    x8 [8][G], h1 [32][G+4] and dyn [G][h+4], or two weight slabs of h x 72
    bfloat16 beside the B operand as bfloat16 pairs (k of W*D + 2 or 3h +
    8 padded to 16, rows of 40 words). Above 128 (`layout_wh`) the queries
    still hold 32 instances; the encoder view X [max(W*D + 2, h + 8)][33]
    and e1 [h][33] (bfloat16: copies of 32 bfloat16 a row, X's rows padded
    to 16); a token group is 32 columns; the token view holds the weight
    ring's 3 stages of 16 h floats; then 9 words of the ring's mbarriers
    and counts and 32 query columns."""
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD = cfg.target_width * cfg.target_depth
    T, L = N * R, (N + 30) // 31
    up4 = lambda x: (x + 3) // 4 * 4
    bf = dtype == torch.bfloat16
    wide = h > 128
    g = 32 if wide else 64
    rows = max((N + 2 * L * N + R * N) * 32,             # phase 0's rows
               (13 + 8 * 16 + C * WD + 3 * N) * 32)      # phase 3's
    tok = 8 * g + 32 * (g + 4) + g * (h + 4) if bf else 40 * g
    if wide:
        xr = max(WD + 2, h + 8)
        enc = ((xr + 15) // 16 * 16 + h) * 16 if bf else up4((xr + h) * 33)
        view = max(tok, 3 * 16 * h, rows)
        tail = up4(9 + 32)
    else:
        k = max(WD + 2, 3 * h + 8)
        enc = up4((WD + 4 * h + 10) * 33)
        view = max(tok, 72 * h + (k + 15) // 16 * 8 * 40 if bf else 64 * h,
                   rows)
        tail = 0
    floats = (up4(20 * h if bf else 32 * h) + 256 + 32 + up4(h)
              + up4(C * h * 33) + T * C * 32 + enc + view + tail)
    ints = 17 * 32 + 2 + 32 * T
    return 4 * (floats + ints)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [32, 64, 96, 128, 160, 192, 224, 256])
def test_smem_plan_and_eligible(h, dtype):
    """`smem_bytes(cfg, h, dtype)` is the plan written out above on the six
    CONFIGS, and `eligible(cfg, h, dtype)` is the config rule (unbounded
    height, N <= 62, C <= 4, W*D <= 256) with a block within 227 KB: every
    config but the capped one at every width up to 256 in both dtypes. The
    float32 plan at 128 is unchanged (142,680 B at 2d-basic, 178,552 B at
    2d-rolling); at 256 the widest block is K2 f32 on multi-container."""
    for name, cfg in CONFIGS.items():
        smem = AS.smem_bytes(cfg, h, dtype)
        assert smem == _smem_rule(cfg, h, dtype), name
        fits = smem <= 232448
        assert AS.eligible(cfg, h, dtype) == (
            cfg.target_height == 0 and cfg.num_blocks <= 62
            and cfg.num_containers <= 4
            and cfg.target_width * cfg.target_depth <= 256 and fits), name
        assert AS.eligible(cfg, h, dtype) == (name != "multi-container-capped")
    if h == 128 and dtype == torch.float32:
        assert AS.smem_bytes(CONFIGS["2d-basic"], h) == 142680
        assert AS.smem_bytes(CONFIGS["2d-rolling"], h) == 178552
    if h == 256:
        assert max(AS.smem_bytes(c, h, dtype) for c in CONFIGS.values()) \
            == AS.smem_bytes(CONFIGS["multi-container"], h, dtype)
