"""K2 above hidden 128 (the WH instantiations of csrc/actor_step.cu), held
on the CPU through what the card's body rests on.

Above hidden 128 the kernel's head runs once over a block's 32 instances.
A step streams only W1, W2 and Wq' (Wq's enc and dsum columns, `wq_prime`)
through a ring of bulk copies, laid out once per rollout by `ring_slabs`,
and starts each query accumulator at the step-invariant part that
`query_parts` makes once per rollout: Wq_ctx ctx and Wq_emb E. Here:

1. that split, `query_parts_ref` plus Wq' [enc, dsum], equals the JAX
   kernel's query (tapnet_tpu/ops/pallas_actor_step.py:243, `mm(wqt, qin)`
   cast to the compute dtype, plus the bias) on seeded operands at hidden
   160 and 256: float32 within 1e-5 under highest matmul precision,
   bfloat16 within one bfloat16 ulp (JAX compiled with excess precision
   off, as tests/test_torch_bf16.py runs its bf16 kernels);
2. the plain full and live modes of K2 at hidden 160 and 256 against the
   Pallas kernel in interpret mode on one sampled 2d-basic step: integer
   outputs bit-equal, logits and logp within 1e-5. Batch 128: the JAX
   kernel tiles the batch by 128 lanes and asserts a multiple of 128;
3. `eligible(cfg, h, dtype)` holds for every shipped config the config
   rule covers (all but the capped one), every h of 160-256, both dtypes;
   with more containers than shipped (up to the rule's 4) the plan runs
   out of shared memory at the widest widths, where `FIRST_MISS` pins;
4. a model of the kernel's slab addressing (ring_bf16.cuh `ldsm_slab` in
   bfloat16; in float32 KR rows of W1^T and the 3xTF32 A-fragment order
   of W2 and Wq') reads every weight of W1, W2 and Wq' back from
   `ring_slabs`, zeros past K, and the rows of each ldmatrix matrix of the
   [K16][32] B-operand copies (`xs32_at`) fall in 8 different bank
   groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_tpu.config import CONFIGS as JCONFIGS
from tapnet_tpu.models.tapnet import init_params as jax_init_params
from tapnet_tpu.ops import pallas_actor_step as JAS
from tapnet_torch.config import CONFIGS
from tapnet_torch.convert import actor_from_flax
from tapnet_torch.ops import actor_step as AS

from test_torch_actor_step import _operands, _port_ops

BF = torch.bfloat16
WIDE = (160, 192, 224, 256)


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (float32 array; the normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [160, 256])
def test_query_split_equals_jax_query(h, dtype):
    B, A = 32, 20
    rng = np.random.default_rng(h)
    jdt = jnp.dtype(dtype)
    cast = lambda x: np.asarray(jnp.asarray(x, jnp.float32).astype(jdt))
    wq = cast(rng.standard_normal((h, 3 * h + 8)) / np.sqrt(3 * h + 8))
    bq = cast(0.1 * rng.standard_normal((h, 1)))
    et = cast(rng.standard_normal((h, A + 1)))
    enc, ctx = cast(rng.standard_normal((h, B))), cast(rng.standard_normal(
        (h, B)))
    dsum = cast(rng.random((8, B)))
    idx = rng.integers(0, A + 1, B)

    def jax_query(wq, enc, ctx, emb, dsum, bq):  # pallas_actor_step.py:243
        qin = jnp.concatenate([enc, ctx, emb, dsum], axis=0)
        mm = jnp.dot(wq, qin, preferred_element_type=jnp.float32)
        return mm.astype(wq.dtype) + bq

    args = [jnp.asarray(x) for x in (wq, enc, ctx, et[:, idx], dsum, bq)]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax_query).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
            .astype(jnp.float32))

    tdt = getattr(torch, dtype)
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(tdt)
    params = [None] * 11
    params[7], params[8] = t(et), t(wq)
    rd = AS.rounder(tdt)
    qctx, qemb = AS.query_parts_ref(params, t(ctx))
    part = AS.wq_prime(params).float() @ torch.cat([t(enc), t(dsum)]).float()
    got = rd(rd((qctx + qemb[:, idx]) + part) + t(bq).float()).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        d = np.abs(got - want)
        assert (d <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()
        assert (d > 0).mean() < 0.05  # rounding ties, not a wrong sum


@pytest.mark.parametrize("h", [160, 256])
def test_plain_modes_match_jax_kernel(h):
    cfg, jcfg = CONFIGS["2d-basic"], JCONFIGS["2d-basic"]
    flax_params = jax_init_params(jax.random.key(5), jcfg, h)["actor"]
    actor = actor_from_flax(jax.tree.map(np.asarray, flax_params), cfg, h)
    ops = _operands(cfg, actor, seed=h)
    with jax.default_matmul_precision("highest"):
        want = JAS.actor_select_step(
            *(jnp.asarray(o) for o in ops),
            JAS.head_operands(flax_params, jcfg, jnp.float32),
            cfg=jcfg, temperature=0.8, interpret=True)
    port, params = _port_ops(ops), AS.head_operands(actor, cfg)
    labels = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    for ref in (AS.actor_select_step_ref, AS.actor_select_step_live_ref):
        got = ref(*port, params, cfg, temperature=0.8)
        for label, w, g in zip(labels, want, got):
            w = np.asarray(w)
            if g is None:
                assert label == "logits" and ref is not AS.actor_select_step_ref
            elif label in ("logits", "logp"):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                           atol=1e-5, err_msg=label)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=label)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("h", WIDE)
def test_every_covered_config_is_eligible(h, dtype):
    for name, cfg in CONFIGS.items():
        covered = AS._covers_config(cfg)
        assert covered == (name != "multi-container-capped"), name
        assert AS.eligible(cfg, h, dtype) == covered, (name, h, dtype)
        assert AS.smem_bytes(cfg, h, dtype) <= AS.SMEM_LIMIT, name


# Above hidden 128 the plan keeps every container's query [h][33] floats
# for the whole tile, so a config with more containers than the shipped
# ones may not fit at the widest widths: the first h of WIDE at which each
# covered config, with C containers, leaves K2 for the next route (none:
# K2 at every width up to 256).
FIRST_MISS = {
    torch.float32: {("2d-basic", 3): 256, ("2d-basic", 4): 224,
                    ("2d-rot", 3): 224, ("2d-rot", 4): 224,
                    ("3d-basic", 3): 224, ("3d-basic", 4): 192,
                    ("2d-rolling", 2): 224, ("2d-rolling", 3): 192,
                    ("2d-rolling", 4): 160, ("multi-container", 3): 224,
                    ("multi-container", 4): 192},
    BF: {("2d-basic", 4): 256, ("2d-rot", 4): 256, ("3d-basic", 4): 224,
         ("2d-rolling", 3): 224, ("2d-rolling", 4): 192,
         ("multi-container", 4): 224}}


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_more_containers_leave_k2_where_pinned(dtype):
    """Every covered config with 1-4 containers: K2 eligible at h of WIDE
    exactly below its pinned first miss, and `smem_bytes` over the limit
    from there on."""
    import dataclasses
    for name, cfg in CONFIGS.items():
        if not AS._covers_config(cfg):
            continue
        for C in range(1, AS.MAX_C + 1):
            c = dataclasses.replace(cfg, num_containers=C)
            first = FIRST_MISS[dtype].get((name, C), 10 ** 9)
            for h in WIDE:
                assert AS.eligible(c, h, dtype) == (h < first), (name, C, h)
                assert (AS.smem_bytes(c, h, dtype) > AS.SMEM_LIMIT) == (
                    h >= first), (name, C, h)


def _read_slab(buf, h, k, j, bf16, simt):
    """The kernel's address of W[j, k] within one matrix's slabs (buf its
    own slabs, flat): bfloat16 `ldsm_slab` (row j's 16-byte chunk ch at
    8 (ch ^ ((j >> 1) & 3))); float32 W1 (`simt`, ring_mv_f32) row k % KR
    of slab k // KR as [KR][h]; float32 W2 and Wq' (ring_mm_tf32) lane
    4 g + t's 16 bytes of row tile m, half f, for row 16 m + 8 f + g and
    the slab's columns 4 t .. 4 t + 3."""
    if bf16:
        s, kk = divmod(k, AS.RING_K)
        ch, e = divmod(kk, 8)
        return buf[s * h * AS.RING_K + j * AS.RING_K
                   + 8 * (ch ^ ((j >> 1) & 3)) + e]
    s, kk = divmod(k, AS.KR)
    if simt:
        return buf[(s * AS.KR + kk) * h + j]
    t, e = divmod(kk, 4)
    m, r = divmod(j, 16)
    f, g = divmod(r, 8)
    return buf[s * AS.KR * h + 256 * m + 128 * f + 4 * (4 * g + t) + e]


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("h", [160, 256, 320])
def test_ring_slabs_hold_the_weights(h, dtype):
    """Above 256 (WX) each matrix is its two row halves' slabs in turn,
    each laid out as a matrix of h / 2 rows."""
    cfg = CONFIGS["multi-container"]
    g = torch.Generator().manual_seed(h)
    params = [torch.randn(s, generator=g).to(dtype)
              for s in AS.head_shapes(cfg, h)]
    bf16 = dtype == BF
    slabs = AS.ring_slabs(params, h)
    assert slabs.dtype == BF
    flat = slabs if bf16 else slabs.view(torch.float32)
    unit = 1 if bf16 else 2  # bfloat16 units per element
    sk = AS.RING_K if bf16 else AS.KR
    nh = AS.geometry(h)["nh"]
    assert nh == (2 if h > 256 else 1)
    hr = h // nh
    off = 0
    for i, wm in enumerate((params[3], params[5], AS.wq_prime(params))):
        for w in wm.chunk(nh, 0):
            K = w.shape[1]
            ns = -(-K // sk)
            buf = flat[off // unit:(off + ns * hr * AS.RING_K) // unit]
            back = torch.tensor([[float(_read_slab(buf, hr, k, j, bf16,
                                                   i == 0))
                                  for k in range(ns * sk)]
                                 for j in range(hr)])
            assert torch.equal(back[:, :K], w.float())
            assert not back[:, K:].any()
            off += ns * hr * AS.RING_K
    assert off == slabs.numel()
    assert torch.equal(AS.wq_prime(params), torch.cat(
        [params[8][:, :h], params[8][:, 3 * h:]], 1))


def test_b_copies_meet_no_bank_conflict():
    """`xs32_at`: the 8 rows k0 .. k0 + 7 of one 16-byte chunk position,
    64 bytes a row, land in 8 different 16-byte bank groups."""
    xs32_at = lambda k, n: 32 * k + 8 * ((n >> 3) ^ ((k >> 1) & 3)) + (n & 7)
    for k0 in range(0, 64, 8):
        for c in range(4):
            groups = {(2 * xs32_at(k0 + r, 8 * c) // 16) % 8 for r in range(8)}
            assert len(groups) == 8
    cells = {xs32_at(k, n) for k in range(16) for n in range(32)}
    assert cells == set(range(16 * 32))
