"""The bfloat16 replay kernels above hidden 128, held on the CPU through
what they rest on.

Above hidden 128 the bfloat16 replay instantiations (csrc/replay.cu with
csrc/ring_bf16.cuh) keep no float copies of the encoder/query
activations between their phases: A/B writes q, qin, e1 and feats to the
half-width record and D reads q and e1 back, which is exact only if each
is a bfloat16 value. They read the weights as ring slabs that the wrapper
lays out (`ops.replay.ring_operands`), swizzled so that ldmatrix meets no
bank conflict. Here:

1. the plain bf16 replay's q, qin, e1 and feats at hidden 160 and 256
   (2d-basic and a small rolling config, batch 32) are bfloat16 values;
2. a model of the kernel's slab addressing (ring_bf16.cuh `ldsm_slab`)
   reads every weight back from `ring_operands`, zeros past K, and the
   rows of each ldmatrix matrix of a slab and of a B-operand copy
   (`xs_at`) fall in 8 different bank groups;
3. the Python mirrors of the plan: `record_floats` with its q part,
   `scratch_bytes` at 2d-rolling, batch 4096, and `smem_bytes` of every
   CONFIG at 160-256 under SMEM_LIMIT, the 2d-rolling figure at 256
   pinned;
4. the plain bf16 K5, both schedules, against the Pallas bf16 replay
   kernels (interpret mode, compiled strict as tests/test_torch_bf16.py
   runs them) on JAX's own operands at hidden 160 on 2d-basic, within that
   file's K5 tolerances. Batch 128: the Pallas replay tiles the batch by
   at least 128 lanes, and a smaller batch leaves it lanes it fills with
   NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.env.sampler import sample_batch as jax_sample_batch
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.ops import pallas_replay as JPR
from tapnet_tpu.train import rollout as JRO
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.models.tapnet import init_params
from tapnet_torch.ops import replay as RP
from tapnet_torch.ops.actor_step import head_operands

BF = torch.bfloat16
JBF = jnp.bfloat16
WIDE = (160, 192, 224, 256)
ROLLING_SMALL = TAPConfig(num_blocks=12, min_blocks=6, container_width=8,
                          container_height=12, target_width=8, window=4,
                          allow_rot=True)
K5_VALUE_TOL = 1e-4  # as tests/test_torch_bf16.py: the value, relative
K5_GRAD_TOL = 1e-2   # ... each gradient, of its max magnitude


def _exact_bf16(x, what):
    assert bool(torch.isfinite(x).all()), what
    assert torch.equal(x, x.bfloat16().float()), what


@pytest.mark.parametrize("h", [160, 256])
@pytest.mark.parametrize("name", ["2d-basic", "rolling-small"])
def test_plain_bf16_activations_are_bfloat16(name, h):
    """Every step's q, qin, e1 and feats of the plain bf16 replay are
    bfloat16 values held as float32: the half-width record keeps them
    exactly, so D's reads of q and e1 give what A/B computed."""
    cfg = CONFIGS[name] if name in CONFIGS else ROLLING_SMALL
    dev = torch.device("cpu")
    actor = init_params(0, cfg, h, dev)
    ops, _ = CS.replay_operands(actor, cfg, 32, dev, 10, 1.0, dtype=BF)
    flags, hms, _, acts, _, ctx, _, statm, params = ops
    prev = RP._prev_rows(acts)
    for k in range(cfg.num_blocks):
        _, _, qs, sv = RP._head_queries(cfg, k, flags[k], hms[k], prev[k],
                                        ctx, statm, params)
        for c, (q, (feats, e1), qin) in enumerate(
                zip(qs, sv["hm"], sv["qins"])):
            for what, x in (("q", q), ("qin", qin), ("e1", e1),
                            ("feats", feats)):
                _exact_bf16(x, f"step {k} container {c} {what}")
        assert bool((qs[0] != 0).any())


def _slab_element(slabs, i, r, kk, rk=RP.RING_K):
    """W[r, i rk + kk] as the kernel addresses it in slab i of a matrix of
    M rows (ring_bf16.cuh `ldsm_slab`: chunk kk / 8 of row r at
    r rk + 8 (chunk ^ ((r >> 1) & 3)))."""
    M = slabs.shape[-2]
    ch = kk // 8
    off = i * M * rk + r * rk + 8 * (ch ^ ((r >> 1) & 3)) + kk % 8
    return slabs.reshape(-1)[off]


@pytest.mark.parametrize("name", ["2d-basic", "multi-container"])
@pytest.mark.parametrize("h", [160, 256])
def test_ring_slabs_hold_the_weights(h, name):
    """`ring_operands`' slabs of W1, W2, Wq, Wq^T's three [h, h] blocks and
    W2^T: the kernel's addressing reads every weight back, and zeros where
    K is padded to RING_K; bfloat16 above hidden 128 only (W*D + 2 = 12 on
    2d-basic, 66 on multi-container)."""
    cfg, cpu = CONFIGS[name], torch.device("cpu")
    params = head_operands(init_params(0, cfg, h, cpu), cfg, BF)
    w1, w2, wq = params[3], params[5], params[8]
    wqT = wq.T[:3 * h]
    want = [w1, w2, wq, *(wqT[u * h:(u + 1) * h] for u in range(3)), w2.T]
    slabs = RP.ring_operands(params, h)
    got = list(slabs[:3]) + list(slabs[3].chunk(3)) + [slabs[4]]
    for g, w in zip(got, want):
        M, K = w.shape
        ns = -(-K // RP.RING_K)
        assert g.numel() == ns * M * RP.RING_K and g.dtype == BF
        wp = torch.nn.functional.pad(w, (0, ns * RP.RING_K - K))
        back = torch.stack([torch.stack([
            _slab_element(g.view(ns, M, RP.RING_K), i, r, kk)
            for i in range(ns) for kk in range(RP.RING_K)])
            for r in range(M)])
        assert torch.equal(back, wp)
    assert all(t.data_ptr() % 16 == 0 for t in slabs)
    f32 = head_operands(init_params(0, cfg, h, cpu), cfg)
    small = head_operands(init_params(0, cfg, 128, cpu), cfg, BF)
    assert all(t.numel() == 0 for t in RP.ring_operands(f32, h))
    assert all(t.numel() == 0 for t in RP.ring_operands(small, 128))


def test_swizzles_meet_no_bank_conflict():
    """The 8 row addresses of each ldmatrix matrix fall in 8 different
    16-byte bank groups: a slab's (rows of 32 bfloat16, chunk ch of row r
    at ch ^ ((r >> 1) & 3)) and a B-operand copy's (rows of 16, chunk c of
    row k at c ^ ((k >> 2) & 1), ring_bf16.cuh `xs_at`)."""
    for r0 in range(0, 256, 8):
        for ch in range(4):
            groups = {(r * 64 + 16 * (ch ^ ((r >> 1) & 3))) // 16 % 8
                      for r in range(r0, r0 + 8)}
            assert len(groups) == 8
        for c in range(2):
            groups = {(k * 32 + 16 * (c ^ ((k >> 2) & 1))) // 16 % 8
                      for k in range(r0, r0 + 8)}
            assert len(groups) == 8


@pytest.mark.parametrize("h", WIDE)
def test_wide_bf16_plan_and_records(h):
    """Above 128 the bfloat16 record holds q too (half width, as qin, e1
    and feats), `scratch_bytes` sizes the 2d-rolling records from it, and
    every CONFIG's bfloat16 plan fits a block in both directions and
    schedules (the forward holds d_prev and dq as the backward does)."""
    tp, FQ = 16, 3 * h + 8
    for cfg in CONFIGS.values():
        WD2 = cfg.target_width * cfg.target_depth + 2
        assert RP.record_floats(cfg, h, BF) == \
            2 * (3 * h * tp + (FQ + h + WD2 + h) * tp // 2)
        assert RP.eligible(cfg, h, BF)
        for bwd in (False, True):
            for steps in (False, True):
                assert RP.smem_bytes(cfg, h, bwd, steps, BF) <= \
                    RP.SMEM_LIMIT
        assert RP.smem_bytes(cfg, h, False, dtype=BF) == \
            RP.smem_bytes(cfg, h, True, dtype=BF)
    rolling = CONFIGS["2d-rolling"]
    s = RP.scratch_bytes(rolling, 4096, h, BF)
    assert s["records"] == 4 * 128 * 2 * 25 * RP.record_floats(rolling, h,
                                                               BF)
    if h == 256:  # the ring's plan; the records grow by q (~1.06 GB before)
        assert RP.smem_bytes(rolling, h, True, dtype=BF) == 222760
        assert s["records"] == 1_164_083_200


def _port(x):
    """A JAX operand as a torch tensor in its dtype (bfloat16 exact)."""
    if x.dtype == JBF:
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(BF)
    return torch.from_numpy(np.array(x))


def test_plain_k5_bf16_matches_jax_kernels_at_hidden_160():
    """The plain bf16 K5 (monolithic and step-grid) at hidden 160 against
    the Pallas bf16 replay on JAX's own operands of a bf16 rollout (batch
    128, 2d-basic): the value within K5_VALUE_TOL, each of the 13
    gradients within K5_GRAD_TOL of its largest magnitude."""
    h, B = 160, 128
    cfg, jcfg = CONFIGS["2d-basic"], JCONFIGS["2d-basic"]
    params = jax.jit(jax_init_params, static_argnums=(1, 2))(
        jax.random.key(3), jcfg, h)
    inst = jax.jit(jax_sample_batch, static_argnums=(1, 2))(
        jax.random.key(4), B, jcfg)
    keys = jax.random.split(jax.random.key(5), B)
    got = {}

    def capture(statics, diff, data):
        got.update(statics=statics, diff=diff, data=data)
        return jnp.zeros(data[3].shape[1:], jnp.float32)

    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        _, record, _ = jax.jit(lambda p, i, k: JRO.rollout_batch_record(
            p, i, k, jcfg, hidden=h, dtype=JBF, step_kernel=False,
            actor_kernel=False))(params["actor"], inst, keys)
        mp.setattr(JPR, "replay_logp_fused", capture)
        JRO._replay_logp_kernel(params["actor"], inst, record, jcfg, h, 1.0,
                                JBF, interpret=True)
    statics, diff, data = got["statics"], got["diff"], got["data"]
    dlp = jnp.asarray(np.random.default_rng(7).uniform(-1, 1, B),
                      jnp.float32)

    def value_and_grad(d, g):
        lp, vjp = jax.vjp(lambda x: JPR.replay_logp_fused(statics, x, data),
                          d)
        return lp, vjp(g)[0]

    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        # the step-grid schedule: XLA:CPU has no bf16 x bf16 -> f32 dot
        # for the monolithic one (tests/test_torch_bf16.py)
        mp.setattr(JPR, "_steps_grid", lambda c: True)
        lp_j, grads_j = jax.jit(value_and_grad).lower(diff, dlp).compile(
            compiler_options={"xla_allow_excess_precision": False})(diff,
                                                                    dlp)
    (jp, jse, jctx) = diff
    flags, hms, masks, acts, prev, statp, statm, _ = (_port(x) for x in data)
    cast = lambda x: _port(x).to(BF if x.dtype == JBF else torch.float32)
    # (the operands keep JAX's dtypes: bfloat16 but v, float32)
    se, ctx, statp, statm = (cast(x) for x in (jse, jctx, data[5], data[6]))
    hp = tuple(cast(p) for p in jp)
    dl = torch.from_numpy(np.array(dlp))
    want = [grads_j[1], grads_j[2], *grads_j[0]]
    lpj = np.asarray(lp_j)
    for steps in (False, True):
        if steps:
            lp = RP.replay_logp_fwd_steps_ref(flags, hms, masks, acts, prev,
                                              se, ctx, statp, statm, hp, cfg)
            out = RP.replay_logp_bwd_steps_ref(dl, flags, hms, masks, acts,
                                               prev, se, ctx, statp, statm,
                                               hp, cfg)
        else:
            lp = RP.replay_logp_fwd_ref(flags, hms, masks, acts, se, ctx,
                                        statp, statm, hp, cfg)
            out = RP.replay_logp_bwd_ref(dl, flags, hms, masks, acts, se,
                                         ctx, statp, statm, hp, cfg)
        verr = float(np.abs(lp.numpy() - lpj).max() / np.abs(lpj).max())
        assert verr <= K5_VALUE_TOL, (steps, verr)
        grads = [g.to(x.dtype) for g, x in zip((out[0], out[1], *out[2]),
                                               (se, ctx, *hp))]
        for i, (g, w) in enumerate(zip(grads, want)):
            w = np.asarray(jnp.asarray(w, jnp.float32))
            e = float(np.abs(g.float().numpy() - w).max()
                      / (np.abs(w).max() + 1e-9))
            assert e <= K5_GRAD_TOL, (steps, i, e)

