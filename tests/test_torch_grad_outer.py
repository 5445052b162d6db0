"""The replay backward's two helper kernels held on the CPU through their
plain versions: `grad_outer_tf32` (the float32 backward's deferred
weight-gradient contractions above hidden 128, wgmma 3xTF32 in
csrc/replay.cu) and `reduce_tiles` (the ordered sum of partial rows).

`grad_outer_ref` reads a record by `rec_offsets`, the Python mirror of
the kernel's `rec_off`; here it is held to a float64 sum over the acting
steps on seeded numpy records (C = 2, a batch that is not a multiple of
32, some steps without an action, hidden 160 and 256), and a model of
the kernel's 3xTF32 arithmetic (tf32 hi + lo split by `cvt.rna`, lo.hi +
hi.lo + hi.hi, as tests/test_torch_tf32x3.py models it) to the same
float64 sum within its rounding bound and to the plain version within
GRAD_TOL. `reduce_tiles_ref` is held bit for bit to a float32 sum in row
order. The kernel's shared-memory plan (`grad_outer_smem`, the mirror of
`go_plan`, whose size the source also checks when it compiles) fits a
block at every width and config the routers send to it, and the
constants the mirrors assume are those of the source. The kernels themselves run only on the card
(chip_smoke.py phase 26 holds them to these plain versions there).
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

SRC = Path(RP.__file__).resolve().parent.parent / "csrc" / "replay.cu"
WIDE = (160, 192, 224, 256)
KERNEL_U = 12  # tests/test_torch_tf32x3.py: roundoff units 3xTF32 adds


def tf32(x):
    """float32 to tf32 as `cvt.rna.tf32.f32` (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _records(cfg, h, B, seed, length=None):
    """Seeded numpy records of the float32 backward for a batch of B
    (rows = its tiles, `length` steps a row: the config's N by default),
    gradient sections ~1e-3 as the backward's are, and sflag with about a
    third of the steps without an action (at least one of each)."""
    rows = -(-B // RP.TB)
    length = length or cfg.num_blocks
    rng = np.random.default_rng(seed)
    n = rows * length * cfg.num_containers * RP.record_floats(cfg, h)
    rec = rng.standard_normal(n).astype(np.float32)
    ro = RP.rec_offsets(cfg, h)
    rec.reshape(-1, ro["pass"])[:, :3 * h * 16] *= 1e-3
    sflag = (rng.random(rows * length) < 0.65).astype(np.int32)
    sflag[0], sflag[1] = 0, 1
    return torch.from_numpy(rec), torch.from_numpy(sflag), length


def _operands(rec, sflag, cfg, h, length):
    """Per row and section, the acting parts' G [K, h] and X [K, cols]
    stacked along K (steps, containers, passes, lanes in the kernel's
    order), in float32."""
    ro = RP.rec_offsets(cfg, h)
    rows = sflag.numel() // length
    r = rec.view(rows, length, cfg.num_containers, 2, ro["pass"])
    WD2 = cfg.target_width * cfg.target_depth + 2
    out = []
    for a in range(rows):
        acting = [s for s in range(length) if sflag[a * length + s]]
        secs = []
        for g, x, k in (("de1", "feats", WD2), ("dhm", "e1", h),
                        ("dq", "qin", 3 * h + 8)):
            part = lambda name, n: r[a, acting][..., ro[name]:ro[name]
                                                + n * 16].reshape(
                len(acting), cfg.num_containers, 2, n, 16)
            G = part(g, h).permute(0, 1, 2, 4, 3).reshape(-1, h)
            X = part(x, k).permute(0, 1, 2, 4, 3).reshape(-1, k)
            secs.append((G, X))
        out.append(secs)
    return out


CASES = [("multi-container", 160, 40), ("multi-container", 256, 100),
         ("2d-basic", 256, 72), ("2d-rolling", 160, 33)]


@pytest.mark.parametrize("name,h,B", CASES)
def test_grad_outer_ref_against_float64(name, h, B):
    """The plain contractions are the float64 sums over the acting steps
    to float32's rounding bound (gamma of the terms times the sum of
    their magnitudes); a step without an action adds nothing even where
    its record holds NaN (the kernel never writes it)."""
    cfg = CONFIGS[name]
    rec, sflag, length = _records(cfg, h, B, seed=h + B)
    ro = RP.rec_offsets(cfg, h)
    off = sflag.tolist().index(0) * cfg.num_containers * ro["size"]
    rec[off:off + ro["size"]] = float("nan")
    got = RP.grad_outer_ref(rec, sflag, cfg, h, length)
    assert RP.grad_outer_tf32(rec, sflag, cfg, h, length)[0].equal(got[0])
    for row, secs in zip(range(len(got[0])), _operands(rec, sflag, cfg, h,
                                                      length)):
        for out, (G, X) in zip(got, secs):
            exact = G.double().T @ X.double()
            mag = G.double().abs().T @ X.double().abs()
            u = GW.gamma(G.shape[0])
            assert bool(((out[row].double() - exact).abs()
                         <= u * mag).all())
            assert out[row].shape == exact.shape


@pytest.mark.parametrize("name,h,B", CASES)
def test_grad_outer_3xtf32_model(name, h, B):
    """The kernel's arithmetic, modelled: per k-step of 8 lanes the three
    tf32 products lo.hi, hi.lo, hi.hi of exact tf32 operands, summed in
    float32, within the rounding bound of a 3xTF32 sum of the float64
    product and within GRAD_TOL (of the plain result's max magnitude) of
    the plain version."""
    cfg = CONFIGS[name]
    rec, sflag, length = _records(cfg, h, B, seed=2 * h + B)
    plain = RP.grad_outer_ref(rec, sflag, cfg, h, length)
    for row, secs in enumerate(_operands(rec, sflag, cfg, h, length)):
        for out, (G, X) in zip(plain, secs):
            gh, gl = split(G.T.contiguous())
            xh, xl = split(X)
            model = (gl @ xh + gh @ xl) + gh @ xh
            exact = G.double().T @ X.double()
            mag = G.double().abs().T @ X.double().abs()
            u = GW.gamma(G.shape[0] + 3) + KERNEL_U * GW.U32
            assert bool(((model.double() - exact).abs() <= u * mag).all())
            e = float((model - out[row]).abs().max()
                      / (out[row].abs().max() + 1e-12))
            assert e <= CS.GRAD_TOL, e


@pytest.mark.parametrize("tiles,P", [(1, 37), (7, 100), (33, 1001),
                                     (128, 4096), (62, 2048)])
def test_reduce_tiles_ref_bit_for_bit(tiles, P):
    """The plain ordered sum is numpy's float32 sum in row order from 0,
    bit for bit (signed zeros, cancellations and large ranges included);
    the wrapper takes it for a CPU tensor."""
    rng = np.random.default_rng(tiles * P)
    x = (rng.standard_normal((tiles, P))
         * 10.0 ** rng.integers(-20, 20, (tiles, P))).astype(np.float32)
    x[:, :3] = -0.0
    x[0, 3], x[-1, 3] = 1e30, -1e30
    want = np.zeros(P, np.float32)
    for t in range(tiles):
        want = want + x[t]
    t = torch.from_numpy(x)
    for got in (RP.reduce_tiles_ref(t), RP.reduce_tiles(t)):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("h", (32, 96, 128) + WIDE)
def test_rec_offsets_mirror_record_floats(h):
    """`rec_offsets` lays the sections out one after another in the
    kernel's order, two passes a record (one at h <= 128), and its size
    is `record_floats` wherever a record is kept."""
    for cfg in CONFIGS.values():
        for dtype in (torch.float32, torch.bfloat16):
            ro = RP.rec_offsets(cfg, h, dtype)
            names = ["dq", "dhm", "de1", "qin", "e1", "feats", "q"]
            assert [ro[n] for n in names] == sorted(ro[n] for n in names)
            assert ro["dhm"] - ro["dq"] == h * (16 if h > 128 else 32)
            n = RP.record_floats(cfg, h, dtype)
            if n:
                assert ro["size"] == n
                assert ro["size"] == ro["pass"] * (2 if h > 128 else 1)
            else:
                assert dtype == torch.float32 and h <= 128


def test_grad_outer_plan_fits_every_routed_config():
    """At every width above 128 and every config the replay router sends
    to the float32 kernels there, a grad_outer_tf32 block's plan fits the
    227 KB a block may hold; its regions are aligned for the bulk copies
    (16 bytes) and the swizzled tiles (512); and the plan's constants are
    those of csrc/replay.cu, whose static_assert holds `go_plan` to the
    mirror's size at hidden 256."""
    src = SRC.read_text()
    for name, val in (("GO_NT", RP.GO_NT), ("GO_NX", RP.GO_NX),
                      ("GO_RS", RP.GO_RS), ("GO_NB", RP.GO_NB),
                      ("GO_SL", RP.GO_SL)):
        assert re.search(rf"constexpr int {name} = {val};", src), name
    assert RP.MAX_N == int(re.search(r"constexpr int MAX_N_STEPS = (\d+);",
                                     src).group(1))
    routed = 0
    for h in WIDE:
        # A's rows read past G (up to 64 a warpgroup) stay in the stage
        stage = (h * 64 + RP.GO_NX * 64 + 1023) & ~1023
        assert stage % 1024 == 0 and -(-h // 64) * 64 * 64 <= stage
        assert (RP.GO_NX * 64) % 512 == 0 and (h * 64) % 16 == 0
        assert RP.grad_outer_smem(h) <= RP.SMEM_LIMIT, h
        for cfg in CONFIGS.values():
            if RP.eligible(cfg, h, torch.float32):
                routed += 1
                assert RP.record_floats(cfg, h) % 16 == 0
    assert routed == len(WIDE) * len(CONFIGS)
    assert RP.grad_outer_smem(256) == 222512
    assert "static_assert(go_plan(256).bytes == 222512" in src


@pytest.mark.parametrize("h", WIDE)
def test_grad_outer_tiles_cover_each_section(h):
    """csrc/replay.cu `go_ntiles` cuts each section (Wq's 3h + 8 columns,
    W2's h, W1's W*D + 2 of every config) into GO_NT-wide tiles whose last
    one takes a rest of up to GO_NX - GO_NT columns: every column in
    exactly one tile, each tile within the widest wgmma the kernel has
    (GO_NX) and the plan's X rows."""
    src = SRC.read_text()
    assert "cols <= GO_NX ? 1 : (cols - (GO_NX - GO_NT) + GO_NT - 1) / GO_NT" \
        in src

    def ntiles(cols):
        if cols <= RP.GO_NX:
            return 1
        return (cols - (RP.GO_NX - RP.GO_NT) + RP.GO_NT - 1) // RP.GO_NT

    for cfg in CONFIGS.values():
        for cols in (3 * h + 8, h, cfg.target_width * cfg.target_depth + 2):
            k = ntiles(cols)
            widths = [RP.GO_NT] * (k - 1) + [cols - RP.GO_NT * (k - 1)]
            assert sum(widths) == cols and 0 < widths[-1] <= RP.GO_NX
    assert ntiles(3 * 256 + 8) == 6  # 776 = 5 x 128 + 136
