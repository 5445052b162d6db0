"""K2 and K5 at every hidden width 1-512, held on the CPU.

The kernels take the hidden widths that are multiples of 32 up to 256 and
of 64 up to 512 (`actor_step.kernel_width`; above 256 the WX form of the
head, csrc/geo.cuh). Any other width runs on operands padded with zeros
to the next of them: the rollout pads se, ctx and the head operands once
(`pad_head`, `pad_hidden`), `ReplayLogp` once a call, and slices the
gradients back. Inside K2 and K5 the head is affine maps, ReLU and tanh
with no normalisation over the hidden axis (the token encoder's LayerNorm
runs before them), so a padded unit is exactly 0 everywhere. Here (the
hidden-512 train step against the JAX package's plain path is
tests/test_torch_hidden_512_jax.py; hidden 48 against the JAX kernels
tests/test_torch_hidden_any_jax.py and
tests/test_torch_hidden_any_k5b_jax.py):

1. the plain K2 (both modes) and the plain K5 (forward and backward, both
   schedules) on padded against unpadded operands at hidden 48 and 100,
   on 2d-basic and a 12-block rolling config, batch 16: integer outputs
   equal, logits and logp within 1e-6 relative, every gradient of a pad
   exactly 0 and the sliced gradients within 2e-6 of the unpadded ones
   (scaled by their leaf's max magnitude: at hidden 48 they are
   bit-equal, at 100 float32 sums of 100 and of 128 terms in PyTorch's
   blocking differ by up to 1.3e-6);
2. the plan mirrors at every h = 32..512 step 32, the six CONFIGS and
   both dtypes: every eligible width's plan (at its kernel width) within
   SMEM_LIMIT, and with 1-4 containers the widths whose plan does not fit
   pinned (`MISSES`): above 256 every one fits, since the WX plan keeps
   the queries, dq and the float encoder view in device memory.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.models.features import static_tokens
from tapnet_torch.models.tapnet import embed_static_T, init_params
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.ops import replay as RP
from tapnet_torch.train import rollout as RO

BF = torch.bfloat16
ROLLING = TAPConfig(num_blocks=12, min_blocks=6, container_width=8,
                    container_height=12, target_width=8, window=4,
                    allow_rot=True)
CASES = [(name, h) for name in ("2d-basic", "rolling-12") for h in (48, 100)]


def _cfg(name):
    return ROLLING if name == "rolling-12" else CONFIGS[name]


def _close(got, want, what, tol=2e-6):
    """|got - want| within tol of want's max magnitude."""
    scale = float(want.abs().max()) + 1e-12
    err = float((got - want).abs().max()) / scale
    assert err <= tol, (what, err)


def _record(cfg, h, B=16, seed=7):
    actor = init_params(seed, cfg, h, "cpu")
    inst = sample_batch(R.key(seed + 1), B, cfg)
    with torch.no_grad():
        _, rec, _ = RO.rollout_batch_record(
            actor, inst, R.split(R.key(seed + 2), B), cfg, temperature=0.8)
    return actor, inst, rec


def _k2_operands(actor, cfg, B=16, seed=5):
    """The operands of one decode step from a mid-rollout state (random
    valid actions), as the decode loop builds them, unpadded."""
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    Tk, A = N * cfg.num_rot, cfg.num_actions
    inst = sample_batch(R.key(seed), B, cfg)
    state = E.reset(inst, cfg)
    rng = np.random.default_rng(seed)
    prev = torch.full((B,), -1, dtype=torch.int32)
    for _ in range(N // 2):
        mask = E.action_mask(state, inst, cfg).numpy()
        u = rng.random(mask.shape) * mask
        prev = torch.from_numpy(
            np.where(mask.any(1), u.argmax(1), -1).astype(np.int32))
        state = E.step(state, prev, inst, cfg)
    static = static_tokens(inst, cfg)
    static_t4 = static.permute(2, 1, 0).reshape(4, Tk * B)
    with torch.no_grad():
        se_htb = embed_static_T(actor, static_t4).reshape(-1, Tk, B)
    upm, rotm = AS.precedence_bitmasks(inst, cfg)
    return (torch.full((1, 1), (N // 2) / N),
            state.packed.T.int().contiguous(),
            state.heightmap.permute(1, 2, 3, 0).reshape(C * W, D, B)
            .contiguous(),
            state.placements.permute(1, 2, 0).reshape(N * 6, B).contiguous(),
            prev[None].contiguous(),
            *(inst.dims[:, :, i].T.contiguous() for i in range(3)),
            upm, rotm, AS.fits_planes(inst, cfg),
            torch.from_numpy(rng.gumbel(size=(A, B)).astype(np.float32)),
            se_htb.permute(2, 1, 0).contiguous(),
            se_htb.mean(1).contiguous(),
            static_t4.reshape(4, Tk, B).contiguous(),
            static.mean(1).T.contiguous(), AS.head_operands(actor, cfg))


def _pads_zero(padded, h):
    """Every pad of `pad_head`'s layout exactly 0 in the 11 padded
    gradients: they equal their own slice padded back with zeros."""
    hk = padded[8].shape[0]
    back = AS.pad_head(AS.unpad_head(padded, h), hk)
    for i, (a, b) in enumerate(zip(padded, back)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("name, h", CASES)
def test_padded_k2_equals_unpadded(name, h):
    cfg = _cfg(name)
    actor = init_params(7, cfg, h, "cpu")
    hk = AS.kernel_width(h)
    assert hk > h and hk % 32 == 0
    ops = _k2_operands(actor, cfg)
    pad = list(ops)
    pad[12] = AS.pad_hidden(ops[12], hk, 2)
    pad[13] = AS.pad_hidden(ops[13], hk, 0)
    pad[16] = AS.pad_head(ops[16], hk)
    assert pad[16][8].shape == (hk, 3 * hk + 8)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for ref in (AS.actor_select_step_ref, AS.actor_select_step_live_ref):
        want = ref(*ops, cfg, temperature=0.8)
        got = ref(*pad, cfg, temperature=0.8)
        for label, w, g in zip(labels, want, got):
            if w is None:
                assert g is None
            elif label in ("logits", "logp"):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                           atol=1e-6, err_msg=label)
            else:
                assert torch.equal(g, w), label


@pytest.mark.parametrize("name, h", CASES)
def test_padded_k5_equals_unpadded(name, h):
    cfg = _cfg(name)
    actor, inst, rec = _record(cfg, h)
    hk = AS.kernel_width(h)
    with torch.no_grad():
        data, se, ctx, params = RO.replay_operands(actor, inst, rec, cfg,
                                                   grad=False)
    flags, hms, masks, acts, statp, statm = data
    sp, cp, pp = RP._padded(se, ctx, params)
    assert sp.shape[1] == cp.shape[0] == pp[8].shape[0] == hk
    B = acts.shape[1]
    dlp = torch.linspace(-1.0, 1.0, B)
    if RP._steps_grid(cfg):
        prev = RP._prev_rows(acts)
        fwd = lambda s, c, p: RP.replay_logp_fwd_steps_ref(
            flags, hms, masks, acts, prev, s, c, statp, statm, p, cfg, 0.8)
        bwd = lambda s, c, p: RP.replay_logp_bwd_steps_ref(
            dlp, flags, hms, masks, acts, prev, s, c, statp, statm, p, cfg,
            0.8)
    else:
        fwd = lambda s, c, p: RP.replay_logp_fwd_ref(
            flags, hms, masks, acts, s, c, statp, statm, p, cfg, 0.8)
        bwd = lambda s, c, p: RP.replay_logp_bwd_ref(
            dlp, flags, hms, masks, acts, s, c, statp, statm, p, cfg, 0.8)
    np.testing.assert_allclose(fwd(sp, cp, pp).numpy(),
                               fwd(se, ctx, params).numpy(), rtol=1e-6,
                               atol=1e-6)
    dse, dctx, dp = bwd(se, ctx, params)
    dse_p, dctx_p, dp_p = bwd(sp, cp, pp)
    assert not dse_p[:, h:].any() and not dctx_p[h:].any()
    _pads_zero(dp_p, h)
    _close(dse_p[:, :h], dse, "d_se")
    _close(dctx_p[:h], dctx, "d_ctx")
    for i, (g, w) in enumerate(zip(AS.unpad_head(dp_p, h), dp)):
        assert g.shape == w.shape, i
        _close(g, w, f"d_params[{i}]")


def test_replay_function_pads_and_slices():
    """`ReplayLogp` at hidden 48 (the kernel path rehearsed on CPU tensors):
    the value and every actor gradient of the general replay."""
    cfg = CONFIGS["2d-basic"]
    actor, inst, rec = _record(cfg, 48)
    got = []
    for kernel in (True, False):
        actor.zero_grad(set_to_none=True)
        lp = RO.replay_logp_sum(actor, inst, rec, cfg, 0.8, kernel=kernel)
        lp.sum().backward()
        got.append((lp.detach(), {n: p.grad.clone() for n, p in
                                  actor.named_parameters()}))
    (lp_k, g_k), (lp_g, g_g) = got
    np.testing.assert_allclose(lp_k.numpy(), lp_g.numpy(), rtol=1e-5,
                               atol=1e-5)
    for n in g_g:
        assert g_k[n].shape == g_g[n].shape, n
        _close(g_k[n], g_g[n], n, tol=5e-5)


# ------------------------------------------------------------------ #
# the plan mirrors over every width

# (config, containers): the widths of 32..512 (step 32) whose plan does not
# fit a block, K2's then K5's, per dtype; every other (config, containers,
# width) fits. All of them lie at or below 256: the WX plan (288-512)
# holds neither the C queries nor the float encoder view.
MISSES = {
    torch.float32: {
        ("2d-basic", 3): ([256], []), ("2d-basic", 4): ([224, 256], []),
        ("2d-rot", 3): ([224, 256], []), ("2d-rot", 4): ([224, 256], []),
        ("3d-basic", 3): ([224, 256], []),
        ("3d-basic", 4): ([128, 192, 224, 256], []),
        ("2d-rolling", 2): ([224, 256], [256]),
        ("2d-rolling", 3): ([128, 192, 224, 256], [128, 256]),
        ("2d-rolling", 4): ([128, 160, 192, 224, 256], [128, 224, 256]),
        ("multi-container", 3): ([224, 256], []),
        ("multi-container", 4): ([128, 192, 224, 256], [])},
    BF: {
        ("2d-basic", 4): ([256], []), ("2d-rot", 4): ([128, 256], []),
        ("3d-basic", 4): ([128, 224, 256], []),
        ("2d-rolling", 2): ([], [256]),
        ("2d-rolling", 3): ([128, 224, 256], [128, 256]),
        ("2d-rolling", 4): ([128, 192, 224, 256], [128, 224, 256]),
        ("multi-container", 4): ([128, 224, 256], [])}}


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_plans_fit_every_eligible_width(dtype):
    widths = range(32, 513, 32)
    for name, cfg in CONFIGS.items():
        for h in widths:
            hk = AS.kernel_width(h)
            assert AS.eligible(cfg, h, dtype) == AS._covers_config(cfg)
            assert RP.eligible(cfg, h, dtype), (name, h)
            assert AS.smem_bytes(cfg, hk, dtype) <= AS.SMEM_LIMIT
            assert RP.smem_bytes(cfg, hk, True, dtype=dtype) <= RP.SMEM_LIMIT
            assert RP.smem_bytes(cfg, hk, False, dtype=dtype) \
                <= RP.smem_bytes(cfg, hk, True, dtype=dtype)
        for C in range(1, AS.MAX_C + 1):
            c = dataclasses.replace(cfg, num_containers=C)
            k2, k5 = MISSES[dtype].get((name, C), ([], []))
            if AS._covers_config(c):
                assert [h for h in widths if not AS.eligible(c, h, dtype)] \
                    == k2, (name, C)
            assert [h for h in widths if not RP.eligible(c, h, dtype)] \
                == k5, (name, C)
    for h in (544, 576, 1024):  # past the kernels: the fallbacks
        assert not AS.eligible(CONFIGS["2d-basic"], h, dtype)
        assert not RP.eligible(CONFIGS["2d-basic"], h, dtype)


def test_kernel_widths_and_geometry():
    assert [AS.kernel_width(h) for h in (1, 32, 33, 48, 100, 256, 257, 288,
                                         320, 321, 448, 480, 512)] == \
        [32, 32, 64, 64, 128, 256, 320, 320, 320, 384, 448, 512, 512]
    assert AS.geometry(512) == {"tp": 16, "lp": 17, "g": 16, "ks": 16,
                                "nh": 2}
    assert AS.geometry(256)["nh"] == 1 and AS.geometry(128)["tp"] == 32
    # the WX scratch and the backward's device scratch at 2d-rolling,
    # hidden 512, batch 4096 (PERF.md §6's figures)
    sb = RP.scratch_bytes(CONFIGS["2d-rolling"], 4096, 512)
    assert sb["records"] == 3376742400 and sb["d_se_partials"] == 1677721600
    assert sum(v for k, v in sb.items() if k != "chunks") < 8e9
    assert RP.grad_outer_smem(512) == RP.grad_outer_smem(256)
    assert RP.grad_outer_bf16_plan(512) == RP.grad_outer_bf16_plan(256)
