"""K2's once-per-rollout query parts (csrc/actor_step.cu
`query_parts_kernel`, `ops.actor_step.query_parts`), held on the CPU
through what the card's body rests on. The kernel computes qctx = Wq_ctx
ctx [h, B] and qemb = Wq_emb E [h, A+1] on the tensor cores: bfloat16
products in one pass, float32 ones as 3xTF32. Here:

1. the plain version `query_parts_ref` against the JAX kernel's query at
   its ctx and embedding parts (tapnet_tpu/ops/pallas_actor_step.py:
   237-243: `mm(wqt, qin)` over qin's ctx rows, and over its embedding
   rows, the one-hot product `mm(et, onehot)`) at hidden 160 and 256:
   within 1e-5 under highest matmul precision in both dtypes, and in
   bfloat16 within float32's summation bound of the float64 sums of the
   exact products (the kernel's contract). Check 1 of
   tests/test_torch_k2_wide.py holds the whole query; this one its parts;
2. a numpy model of the float32 body's arithmetic (operands split as
   hi = tf32(x) by `cvt.rna` and lo = tf32(x - hi), lo.lo dropped, each
   k-step of 8 adding its lo.hi, hi.lo and hi.hi passes in that order,
   k-steps in k order) on seeded 2d-basic and 2d-rolling operands at
   every hidden width above 128: within `chip_smoke.py`'s TOL (1e-5 +
   1e-5 |x|, phase 26) of `query_parts_ref`, where one TF32 pass is not;
3. a model of the kernel's tile and fragment indexing: every (row,
   column) of both outputs is written by exactly one lane for B in {100,
   512, 4096}, every shipped config's A + 1 and every hidden width above
   128; every register of every ldmatrix and B fragment holds the element
   that the mma layout asks for, read from where the stage copy put it;
   the 8 rows of each ldmatrix matrix (the swizzled A stages, the
   bfloat16 B stage read by ldmatrix.trans) fall in 8 different 16-byte
   bank groups, and the float32 B loads of a fragment in 32 banks.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapnet_torch import random as R
from tapnet_torch.config import CONFIGS
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.models.features import static_tokens
from tapnet_torch.models.tapnet import embed_static_T, init_params
from tapnet_torch.ops import actor_step as AS

WIDE = (160, 192, 224, 256)
TOL = 1e-5  # chip_smoke.py TOL: phase 26 holds the kernel to it

SRC = (Path(AS.__file__).resolve().parent.parent / "csrc"
       / "actor_step.cu").read_text()
# the kernel's plan, as the source writes it (asserted below)
BM, BN, NT, BLD = 64, 128, 256, 136
KS = {"bfloat16": 64, "float32": 32}


def test_model_constants_are_the_kernels():
    for text in ("QP_BM = 64, QP_BN = 128", "QP_NT = 256",
                 "QP_BLD = QP_BN + 8", "KS = BF ? 64 : 32",
                 "wm = 32 * (w & 1), wn = 32 * (w >> 1)"):
        assert text in SRC, text


# ---- 1. the plain version against the JAX query's parts

def _parts_operands(h, dtype, B=48, A=20, seed=0):
    rng = np.random.default_rng(seed + h)
    jdt = jnp.dtype(dtype)
    cast = lambda x: np.asarray(jnp.asarray(x, jnp.float32).astype(jdt))
    wq = cast(rng.standard_normal((h, 3 * h + 8)) / np.sqrt(3 * h + 8))
    et = cast(rng.standard_normal((h, A + 1)))
    ctx = cast(rng.standard_normal((h, B)))
    idx = rng.integers(0, A + 1, B)
    return wq, et, ctx, idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [160, 256])
def test_plain_parts_equal_jax_query_parts(h, dtype):
    wq, et, ctx, idx = _parts_operands(h, dtype)
    A1 = et.shape[1]

    def jax_parts(wq, ctx, et, idx):  # pallas_actor_step.py:237-243
        mm = lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32)
        onehot = (jnp.arange(A1)[:, None] == idx[None, :]).astype(wq.dtype)
        prev_emb = mm(et, onehot).astype(wq.dtype)
        return mm(wq[:, h:2 * h], ctx), mm(wq[:, 2 * h:3 * h], prev_emb)

    with jax.default_matmul_precision("highest"):
        want_c, want_e = (np.asarray(x) for x in jax.jit(jax_parts)(
            *(jnp.asarray(x) for x in (wq, ctx, et, idx))))
    tdt = getattr(torch, dtype)
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(tdt)
    params = [None] * 11
    params[7], params[8] = t(et), t(wq)
    qctx, qemb = AS.query_parts_ref(params, t(ctx))
    got_c, got_e = qctx.numpy(), qemb.numpy()[:, idx]
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_e, want_e, rtol=1e-5, atol=1e-5)
    if dtype == "bfloat16":  # exact products, float32 sums
        w64 = np.asarray(wq, np.float64)
        for got, a, b in ((qctx.numpy(), w64[:, h:2 * h], ctx),
                          (qemb.numpy(), w64[:, 2 * h:3 * h], et)):
            b64 = np.asarray(b, np.float64)
            exact, mag = a @ b64, np.abs(a) @ np.abs(b64)
            assert (np.abs(got - exact) <= h * 2.0 ** -24 * mag).all()


# ---- 2. the float32 body's 3xTF32 arithmetic

def _tf32(x):
    """cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_model(a, b, passes):
    """sum_k a[m][k] b[k][n] as the kernel adds it: per k-step of 8, in k
    order, each (x, y) pass of `passes(a_part, b_part)` adds its 8 exact
    products (tf32 x tf32 is exact in float32) to the float32 sum."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in passes(a[:, k0:k0 + 8], b[k0:k0 + 8]):
            part = x.astype(np.float64) @ y.astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _three(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ((al, bh), (ah, bl), (ah, bh))


def _seeded_parts(name, h, B=64, seed=3):
    """(Wq, E, ctx) of the port's seeded actor on B sampled instances of
    config `name`, float32: ctx the mean static key, as a rollout makes
    it (chip_smoke.actor_operands)."""
    cfg = CONFIGS[name]
    actor = init_params(seed, cfg, h, "cpu")
    inst = sample_batch(R.key(seed, "cpu"), B, cfg)
    T = cfg.num_blocks * cfg.num_rot
    static = static_tokens(inst, cfg)
    with torch.no_grad():
        se = embed_static_T(actor, static.permute(2, 1, 0).reshape(
            4, T * B), torch.float32).reshape(-1, T, B)
        params = AS.head_operands(actor, cfg, torch.float32)
    return params, se.mean(1).contiguous()


@pytest.mark.parametrize("h", WIDE)
@pytest.mark.parametrize("name", ["2d-basic", "2d-rolling"])
def test_3xtf32_model_meets_tol(name, h):
    params, ctx = _seeded_parts(name, h)
    with torch.no_grad():
        refs = [r.numpy() for r in AS.query_parts_ref(params, ctx)]
    wq = params[8].numpy()
    pairs = ((wq[:, h:2 * h], ctx.numpy()), (wq[:, 2 * h:3 * h],
                                            params[7].numpy()))
    one_pass_err = 0.0
    for ref, (a, b) in zip(refs, pairs):
        got = _mma_model(a, b, _three)
        d = np.abs(got - ref)
        assert (d <= TOL + TOL * np.abs(ref)).all(), d.max()
        one = _mma_model(a, b, lambda x, y: ((_tf32(x), _tf32(y)),))
        one_pass_err = max(one_pass_err, float(
            (np.abs(one - ref) - TOL * np.abs(ref)).max()))
    assert one_pass_err > TOL  # one TF32 pass would not meet it


# ---- 3. the tile and fragment indexing

def _cdiv(a, b):
    return -(-a // b)


def _stores(h, B, A1):
    """The (product, row, column) of every store of one launch, the
    kernel's grid and epilogue: blocks of the emb tiles first, then the
    ctx tiles, each walking the columns of a row tile; warp w's two
    m-tiles and four n-tiles, lane 4 g + t's rows g, g + 8 and columns
    2 t, 2 t + 1; rows >= h and columns >= ncol not stored."""
    nrb, ne, nb = _cdiv(h, BM), _cdiv(A1, BN), _cdiv(B, BN)
    out = []
    for bid in range(nrb * (ne + nb)):
        emb = bid < nrb * ne
        b = bid if emb else bid - nrb * ne
        ncol = A1 if emb else B
        ncb = _cdiv(ncol, BN)
        r0, c0 = b // ncb * BM, b % ncb * BN
        w, lane, mt, nt, f, j = np.meshgrid(
            np.arange(NT // 32), np.arange(32), np.arange(2), np.arange(4),
            np.arange(2), np.arange(2), indexing="ij")
        g, t = lane >> 2, lane & 3
        r = r0 + 32 * (w & 1) + 16 * mt + g + 8 * f
        c = c0 + 32 * (w >> 1) + 8 * nt + 2 * t + j
        keep = (r < h) & (c < ncol)
        out.append((int(emb), r[keep], c[keep]))
    return out


@pytest.mark.parametrize("h", WIDE)
def test_every_output_written_once(h):
    a1s = sorted({cfg.num_actions + 1 for cfg in CONFIGS.values()})
    assert {11, 41, 101} <= set(a1s)
    for B in (100, 512, 4096):
        for A1 in a1s:
            count = [np.zeros((h, A1), np.int64), np.zeros((h, B), np.int64)]
            for emb, r, c in _stores(h, B, A1):
                np.add.at(count[1 - emb], (r, c), 1)
            assert (count[0] == 1).all() and (count[1] == 1).all(), (B, A1)


def _ldsm(addr, trans=False):
    """ldmatrix .x4 on element addresses of 16-bit units: `addr[l]` is
    lane l's row address (matrix l // 8, row l % 8). Returns, per lane T
    and register j, the two 16-bit element addresses it receives: row T
    // 4, elements 2 (T % 4) and + 1; with .trans, rows 2 (T % 4) and + 1,
    element T // 4."""
    T = np.arange(32)
    j = np.arange(4)[None, :]
    if trans:
        rows = addr[8 * j + 2 * (T[:, None] % 4)]
        e = (T // 4)[:, None]
        return np.stack([rows + e, addr[8 * j + 2 * (T[:, None] % 4) + 1]
                         + e], -1)
    base = addr[8 * j + (T // 4)[:, None]] + 2 * (T[:, None] % 4)
    return np.stack([base, base + 1], -1)


def _groups_distinct(byte_addr):
    """The 8 rows of each ldmatrix matrix in 8 different bank groups."""
    for m in range(4):
        rows = byte_addr[8 * m:8 * m + 8]
        assert len({(a // 16) % 8 for a in rows}) == 8


def _stage_map(n, per, place):
    """Element position -> logical (row, column) of a stage copy of n
    chunks of `per` elements: `place(e, j)` gives the position and the
    logical index of element j of chunk e. No position is written twice."""
    pos = {}
    for e in range(n):
        for j in range(per):
            p, rc = place(e, j)
            assert p not in pos
            pos[p] = rc
    return pos


def test_bf16_fragments_read_their_operands():
    ks = KS["bfloat16"]
    la = lambda e, j: (  # A: [64][64], chunk c of row r at c ^ (r & 7)
        (e >> 3) * ks + 8 * ((e & 7) ^ ((e >> 3) & 7)) + j,
        (e >> 3, 8 * (e & 7) + j))
    lb = lambda e, j: (  # B: [64][128], chunk c of row k at c ^ (k & 7)
        (e >> 4) * BN + 8 * ((e & 15) ^ ((e >> 4) & 7)) + j,
        (e >> 4, 8 * (e & 15) + j))
    A = _stage_map(BM * ks // 8, 8, la)
    Bm = _stage_map(ks * BN // 8, 8, lb)
    assert set(A) == set(range(BM * ks)) and set(Bm) == set(range(ks * BN))
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for w in range(NT // 32):
        wm, wn = 32 * (w & 1), 32 * (w >> 1)
        for kk in range(ks // 16):
            for mt in range(2):
                r = wm + 16 * mt + (lanes & 15)
                ch = 2 * kk + (lanes >> 4)
                addr = r * ks + 8 * (ch ^ (r & 7))
                _groups_distinct(2 * addr)
                got = _ldsm(addr)
                want_r = wm + 16 * mt + g[:, None] + 8 * (np.arange(4) & 1)
                want_k = 16 * kk + 2 * t[:, None] + 8 * (np.arange(4) >> 1)
                for i in range(2):
                    rc = np.vectorize(lambda p: A[p][0])(got[..., i])
                    kc = np.vectorize(lambda p: A[p][1])(got[..., i])
                    assert (rc == want_r).all() and (kc == want_k + i).all()
            for np_ in range(2):
                k = 16 * kk + (lanes & 15)
                c = (wn + 16 * np_) // 8 + (lanes >> 4)
                addr = k * BN + 8 * (c ^ (k & 7))
                _groups_distinct(2 * addr)
                got = _ldsm(addr, trans=True)
                # b[0], b[1]: n-tile 2 np_ (k 2t.. and 2t + 8..); b[2],
                # b[3]: n-tile 2 np_ + 1
                reg = np.arange(4)
                want_n = wn + 16 * np_ + 8 * (reg >> 1) + g[:, None]
                want_k = 16 * kk + 2 * t[:, None] + 8 * (reg & 1)
                for i in range(2):
                    kc = np.vectorize(lambda p: Bm[p][0])(got[..., i])
                    nc = np.vectorize(lambda p: Bm[p][1])(got[..., i])
                    assert (kc == want_k + i).all() and (nc == want_n).all()


def test_f32_fragments_read_their_operands():
    ks = KS["float32"]
    la = lambda e, j: (  # A hi (lo alike): [64][32] floats, swizzled
        (e >> 3) * ks + 4 * ((e & 7) ^ ((e >> 3) & 7)) + j,
        (e >> 3, 4 * (e & 7) + j))
    lb = lambda e, j: ((e >> 5) * BLD + 4 * (e & 31) + j,
                       (e >> 5, 4 * (e & 31) + j))
    A = _stage_map(BM * ks // 4, 4, la)
    Bm = _stage_map(ks * BN // 4, 4, lb)
    assert set(A) == set(range(BM * ks))
    assert max(Bm) < ks * BLD and BLD % 32 == 8 and (4 * BLD) % 16 == 0
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for w in range(NT // 32):
        wm, wn = 32 * (w & 1), 32 * (w >> 1)
        for kk in range(ks // 8):
            for mt in range(2):
                r = wm + 16 * mt + (lanes & 15)
                at = 2 * (r * ks + 4 * ((2 * kk + (lanes >> 4)) ^ (r & 7)))
                _groups_distinct(2 * at)
                got = _ldsm(at)  # 16-bit units: a float is the pair
                assert (got[..., 0] % 2 == 0).all()
                fl = got[..., 0] // 2
                rc = np.vectorize(lambda p: A[p][0])(fl)
                kc = np.vectorize(lambda p: A[p][1])(fl)
                reg = np.arange(4)  # (g, t), (g+8, t), (g, t+4), (g+8, t+4)
                assert (rc == wm + 16 * mt + g[:, None] + 8 * (reg & 1)).all()
                assert (kc == 8 * kk + t[:, None] + 4 * (reg >> 1)).all()
            for nt in range(4):
                for half in range(2):
                    p = (8 * kk + t + 4 * half) * BLD + wn + 8 * nt + g
                    assert len(set(p % 32)) == 32
                    kc = np.vectorize(lambda q: Bm[q][0])(p)
                    nc = np.vectorize(lambda q: Bm[q][1])(p)
                    assert (kc == 8 * kk + t + 4 * half).all()
                    assert (nc == wn + 8 * nt + g).all()
