"""The bfloat16 replay backward's deferred weight-gradient contractions
(csrc/replay.cu `grad_outer`, wgmma, every hidden width 32-256) held on
the CPU through their plain version.

`grad_outer_ref(..., dtype=bfloat16)` reads a bfloat16 backward's record
by `rec_offsets` (the gradient sections f32, the activation sections
bfloat16 pairs); here it is held to a float64 sum over the acting steps
on seeded numpy records (C = 2, a batch that is not a multiple of 32,
about a third of the steps without an action, whose records hold garbage
and NaN that must add nothing; hidden 64, 128, 160 and 256). A model of
the kernel's arithmetic (G split as hi = bf16(g), lo = bf16(g - hi); per
stage and k-step of 16 lanes the exact products lo.X, then hi.X, each
block's sum rounded to float32 and added in float32, stages in step and
container order) is held to the same float64 sum within its rounding
bound and to the plain version within GRAD_TOL. The kernel's
shared-memory plan (`grad_outer_bf16_plan`, the mirror of `gb_plan`,
whose sizes the source also checks when it compiles) fits a block, two
an SM at h <= 128, at every width and config the routers send to the
bfloat16 replay, and the constants the mirror assumes are the source's.
The kernel itself runs only on the card (chip_smoke.py phases 24 and 26
hold it to this plain version there).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tapnet_torch import grad_witness as GW
from tapnet_torch.config import CONFIGS
from tapnet_torch.ops import replay as RP
from tapnet_torch.ops.actor_step import geometry, kernel_width

SRC = Path(RP.__file__).resolve().parent.parent / "csrc" / "replay.cu"
BF = torch.bfloat16
SPLIT_U = 2.0 ** -16  # |hi + lo - g| <= 2^-16 |g| (two bf16 roundings)


def bf16_bits(x):
    """float32 -> the bfloat16 bits of its round-to-nearest-even value."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def bf16(x):
    """float32 rounded to bfloat16, as float32."""
    return (bf16_bits(x).astype(np.uint32) << 16).view(np.float32)


def _records(cfg, h, B, seed):
    """Seeded numpy records of the bfloat16 backward for a batch of B (rows
    = its tiles, N steps a row): gradient sections ~1e-3 f32 as the
    backward's are, activation sections bfloat16 pairs (the lower index in
    the low half), and sflag with about a third of the steps without an
    action (at least one of each), one of whose records is all NaN."""
    rows, length = -(-B // RP.TB), cfg.num_blocks
    rng = np.random.default_rng(seed)
    ro = RP.rec_offsets(cfg, h, BF)
    tp = geometry(h)["tp"]
    parts = rows * length * cfg.num_containers * (RP.TB // tp)
    rec = np.empty((parts, ro["pass"]), np.float32)
    g = 3 * h * tp
    rec[:, :g] = rng.standard_normal((parts, g)) * 1e-3
    x = rng.standard_normal((parts, 2 * (ro["pass"] - g))).astype(np.float32)
    rec[:, g:] = bf16_bits(x).view(np.float32).reshape(parts, -1)
    sflag = (rng.random(rows * length) < 0.65).astype(np.int32)
    sflag[0], sflag[1] = 0, 1
    rec = rec.reshape(-1)
    off = cfg.num_containers * ro["size"]
    rec[:off] = np.nan  # step 0 of row 0: no action
    return torch.from_numpy(rec), torch.from_numpy(sflag), length


def _stages(rec, sflag, cfg, h, length):
    """Per row and section (W1, W2, Wq), the acting stages' G [stages, 32,
    h] and X [stages, 32, cols] in float64, a stage's 32 lanes in the
    kernel's k order (the two passes' 16 lanes one after the other above
    hidden 128)."""
    ro = RP.rec_offsets(cfg, h, BF)
    tp = geometry(h)["tp"]
    rows, C, NP = sflag.numel() // length, cfg.num_containers, RP.TB // tp
    r = rec.view(rows, length, C, NP, ro["pass"])
    rb = r.view(BF)
    WD2 = cfg.target_width * cfg.target_depth + 2
    out = []
    for a in range(rows):
        acting = [s for s in range(length) if sflag[a * length + s]]
        secs = []
        for gn, xn, n in (("de1", "feats", WD2), ("dhm", "e1", h),
                          ("dq", "qin", 3 * h + 8)):
            G = r[a, acting][..., ro[gn]:ro[gn] + h * tp]
            X = rb[a, acting][..., 2 * ro[xn]:2 * ro[xn] + n * tp].float()
            G = G.reshape(-1, NP, h, tp).permute(0, 1, 3, 2)
            X = X.reshape(-1, NP, n, tp).permute(0, 1, 3, 2)
            secs.append((G.reshape(-1, RP.TB, h).double().numpy(),
                         X.reshape(-1, RP.TB, n).double().numpy()))
        out.append(secs)
    return out


def _model(G, X):
    """The kernel's sums: per stage and k-step, lo.X then hi.X, each block
    of 16 exact products summed and rounded to float32, then added to a
    float32 accumulator."""
    g32 = G.astype(np.float32)
    hi = bf16(g32)
    lo = bf16(g32 - hi)
    acc = np.zeros((G.shape[2], X.shape[2]), np.float32)
    for s in range(G.shape[0]):
        for ks in range(2):
            k = slice(16 * ks, 16 * ks + 16)
            for a in (lo, hi):
                blk = (a[s, k].astype(np.float64).T @ X[s, k]).astype(
                    np.float32)
                acc = acc + blk
    return acc


CASES = [("multi-container", 64, 40), ("multi-container", 128, 40),
         ("multi-container", 160, 40), ("multi-container", 256, 40)]


@pytest.mark.parametrize("name,h,B", CASES)
def test_grad_outer_bf16_ref_against_float64(name, h, B):
    """The plain contractions of bfloat16 records are the float64 sums
    over the acting steps to float32's rounding bound (gamma of the terms
    times the sum of their magnitudes); a step without an action adds
    nothing even where its record holds NaN; the wrapper takes the plain
    version for a CPU tensor."""
    cfg = CONFIGS[name]
    rec, sflag, length = _records(cfg, h, B, seed=h + B)
    got = RP.grad_outer_ref(rec, sflag, cfg, h, length, BF)
    for a, b in zip(RP.grad_outer_bf16(rec, sflag, cfg, h, length), got):
        assert a.equal(b)
    for row, secs in enumerate(_stages(rec, sflag, cfg, h, length)):
        for out, (G, X) in zip(got, secs):
            exact = np.einsum("skj,skn->jn", G, X)
            mag = np.einsum("skj,skn->jn", np.abs(G), np.abs(X))
            u = GW.gamma(G.shape[0] * G.shape[1])
            assert out[row].shape == exact.shape
            assert bool(np.all(np.abs(out[row].double().numpy() - exact)
                               <= u * mag))


@pytest.mark.parametrize("name,h,B", CASES)
def test_grad_outer_bf16_model(name, h, B):
    """The kernel's arithmetic, modelled (`_model`): within the split's
    2^-16 and the float32 sums' rounding bound of the float64 product, and
    within GRAD_TOL (of the plain result's max magnitude) of the plain
    version."""
    cfg = CONFIGS[name]
    rec, sflag, length = _records(cfg, h, B, seed=2 * h + B)
    plain = RP.grad_outer_ref(rec, sflag, cfg, h, length, BF)
    for row, secs in enumerate(_stages(rec, sflag, cfg, h, length)):
        for out, (G, X) in zip(plain, secs):
            model = _model(G, X)
            exact = np.einsum("skj,skn->jn", G, X)
            mag = np.einsum("skj,skn->jn", np.abs(G), np.abs(X))
            u = SPLIT_U + 1.01 * GW.gamma(4 * G.shape[0] + 1)
            assert bool(np.all(np.abs(model - exact) <= u * mag))
            want = out[row].numpy()
            e = float(np.abs(model - want).max()
                      / (np.abs(want).max() + 1e-12))
            assert e <= CS.GRAD_TOL, e


def test_grad_outer_bf16_plan_fits_every_routed_config():
    """At every hidden width the kernels take (32-256, and 320-512, where a
    block takes a row half of G, `go_rows`) and every config the replay
    router sends to the bfloat16 kernels, a grad_outer block's plan fits
    the 227 KB a block may hold, and two of them an SM (228 KB, 1 KB reserved a
    block) at h <= 128; A's reads of the last warpgroup's rows past h stay
    in the raw stage and the stores' staging arrays fit in the ring; the
    bulk copies' sources and sizes are 16-byte multiples and the B tiles
    512-byte aligned; and the plan's constants are those of
    csrc/replay.cu, whose static_asserts hold `gb_plan` to the mirror's
    sizes at hidden 128 and 256."""
    src = SRC.read_text()
    for name, val in (("GO_NT", RP.GO_NT), ("GO_NX", RP.GO_NX),
                      ("GO_SL", RP.GO_SL), ("GO_NB", RP.GO_NB)):
        assert re.search(rf"constexpr int {name} = {val};", src), name
    assert "p.rs = h <= 128 ? 3 : 4;" in src
    p128, p256 = RP.grad_outer_bf16_plan(128), RP.grad_outer_bf16_plan(256)
    assert (f"static_assert(gb_plan(128).bytes == {p128['bytes']} && "
            f"gb_plan(256).bytes == {p256['bytes']}") in src
    routed = 0
    widths = [h for h in range(32, RP.MAX_H + 1, 32) if kernel_width(h) == h]
    for h in widths:
        p = RP.grad_outer_bf16_plan(h)
        rows = RP.go_rows(h)  # of G, a block
        assert p["bytes"] <= RP.SMEM_LIMIT, h
        if h <= 128:
            assert 2 * (p["bytes"] + 1024) <= 228 * 1024, h
        wg = p["wg"]
        # A's rows: [64 wg][32] f32 (h <= 128) or the second pass's
        # [64 wg][16] from h * 64 bytes on; X's second run ends at
        # g + 64 NX + 64
        reach = 64 * wg * 128 if h <= 128 else rows * 64 + 64 * wg * 64
        assert reach <= p["stage"] and p["g"] + 64 * RP.GO_NX + 64 \
            <= p["stage"]
        assert 4 * wg * 16 * RP.GO_SL * 4 <= p["rs"] * p["stage"]
        assert p["stage"] % 1024 == 0 and p["b"] % 512 == 0
        for cfg in CONFIGS.values():
            if not RP.eligible(cfg, h, BF):
                continue
            routed += 1
            ro = RP.rec_offsets(cfg, h, BF)
            xp = geometry(h)["tp"] // 2  # floats of an X row
            for k in ("dq", "dhm", "de1", "qin", "e1", "feats", "pass",
                      "size"):
                assert ro[k] % 4 == 0, (k, h)
            assert (4 * xp) % 16 == 0 and (h * 4 * 2 * xp) % 16 == 0
    assert routed == len(widths) * len(CONFIGS) == 12 * len(CONFIGS)


def test_grad_outer_bf16_source():
    """The bfloat16 contractions run only on wgmma: the kernel's products
    are wg_mma2 (WgBf16, m64nNk16 bf16 x bf16 -> f32) for each tile width,
    no mma.sync body is left beside them, the backward launches them
    through launch_grad_outer, and the C entry takes the dtype."""
    src = SRC.read_text()
    body = src[src.index("__device__ void gb_tile"):
               src.index("// Launches of the helper kernels")]
    assert "wg_mma2<N>(acc, ah, al, bt);" in body
    assert "mma(acc[" not in body and "GO_SW" not in src
    for n in (32, 64, 128, 136):
        assert f"m64n{n}k16.f32.bf16.bf16" in (SRC.parent / "wgmma.cuh") \
            .read_text()
    assert "err = launch_grad_outer(d, tc, (const float*)p[32]" in src
    assert re.search(r"tapnet_replay_grad_outer\(const float\* rec, const "
                     r"int\* sflag,\s+const int\* ints, int rows, int len,"
                     r"\s+int bf16, float\* part", src)
