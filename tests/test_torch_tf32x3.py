"""The float32 replay kernels' products above hidden 128 as 3xTF32, held on
the CPU through a plain model of their arithmetic.

Above hidden 128 the float32 replay kernels (csrc/replay.cu with
csrc/mma_tf32.cuh) run the encoder and query products W2 e1 and Wq qin
(W1 feats, ~1% of them, stays float32 SIMT; the model covers it too),
their transposed products (Wq^T dq, W2^T d_hm) and the deferred
weight-gradient contractions (dq qin^T, d_hm e1^T, de1 feats^T) on the
tensor cores: each float32 operand split as x = hi + lo, hi = tf32(x)
and lo = tf32(x - hi) (round to nearest, ties away: `cvt.rna`), and
lo.hi + hi.lo + hi.hi summed in float32. Here `tf32` and `mm3` model that
in plain PyTorch, and the tests hold the model to the float32 products
on the plain replay's own operands at hidden 160 and 256: forward
products within the value tolerance TOL (1e-5, `chip_smoke.check_replay`)
and transposed products and contractions within GRAD_TOL (5e-5), each of
the float32 product's max magnitude, and every element within the
rounding bound of a 3xTF32 sum. The shared-memory plan and the records of
the float32 backward above 128 are held to what the routers and the
kernel need.
"""

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tapnet_torch import grad_witness as GW
from tapnet_torch.config import CONFIGS, TAPConfig
from tapnet_torch.models.tapnet import init_params
from tapnet_torch.ops import replay as RP

# units of roundoff a 3xTF32 product may add to a float32 one: the dropped
# lo.lo term and the tf32 rounding of each lo, 2^-22 of the product each
KERNEL_U = 12
ROLLING_SMALL = TAPConfig(num_blocks=12, min_blocks=6, container_width=8,
                          container_height=12, target_width=8, window=4,
                          allow_rot=True)
WIDE = (160, 192, 224, 256)


def tf32(x):
    """float32 to tf32 (10 explicit mantissa bits), round to nearest with
    ties away from zero, as `cvt.rna.tf32.f32`: half of the dropped 13
    bits' weight added to the magnitude, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b as the kernels' three tf32 passes: lo.hi + hi.lo + hi.hi,
    each pass a float32 product of exact tf32 operands."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def test_split_reconstructs_float32():
    """hi + lo is x to 2^-21 relative, hi and lo are tf32 values (low 13
    bits zero), and hi is the nearest tf32 value (ties away from zero)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(20000), rng.standard_normal(2000) * 1e-30,
        rng.standard_normal(2000) * 1e30]).astype(np.float32))
    hi, lo = split(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    assert bool(((x.double() - hi.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def _record(cfg, h, B=48, seed=10):
    """The plain replay's operands on a sampled rollout (weights from seed
    0) and one step's encoder/query operands per container, with query
    and encoder gradients drawn from a numpy seed."""
    dev = torch.device("cpu")
    actor = init_params(0, cfg, h, dev)
    ops, _ = CS.replay_operands(actor, cfg, B, dev, seed, 1.0)
    flags, hms, _, acts, _, ctx, _, statm, params = ops
    k = cfg.num_blocks // 2
    prev = RP._prev_rows(acts)
    _, _, _, sv = RP._head_queries(cfg, k, flags[k], hms[k], prev[k], ctx,
                                   statm, params)
    rng = np.random.default_rng(seed)
    grad = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 1e-3)
    return params, sv, grad


def _close_values(got, want):
    """Within TOL of the float32 product's max magnitude: an element of a
    product is a sum that may cancel, and the float32 product itself lies
    ~1e-6 from the exact one at K = 3h + 8."""
    e = float((got - want).abs().max() / want.abs().max())
    assert e <= CS.TOL, e


def _close_grads(got, want):
    e = float((got - want).abs().max() / (want.abs().max() + 1e-12))
    assert e <= CS.GRAD_TOL, e


def _within_bound(a, b, got):
    """Every element of `got` within the rounding bound of a 3xTF32 sum
    (gamma of the terms, `grad_witness.gamma`, plus KERNEL_U units) of the
    float64 product; two float32 adds more than the kernel's are the
    model's own (its three products are summed after rounding)."""
    exact = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    u = GW.gamma(a.shape[1] + 3) + KERNEL_U * GW.U32
    assert bool(((got.double() - exact).abs() <= u * mag).all())


@pytest.mark.parametrize("h", [160, 256])
@pytest.mark.parametrize("name", ["2d-basic", "rolling-small"])
def test_products_within_float32_tolerances(name, h):
    """On the plain replay's encoder/query operands of one decode step
    (batch 48): W1 feats, W2 e1 and Wq qin in 3xTF32 within TOL of the
    float32 products; Wq^T dq, W2^T d_hm and the weight-gradient
    contractions over the batch within GRAD_TOL; all within the kernel's
    rounding bound of the exact products."""
    cfg = CONFIGS[name] if name in CONFIGS else ROLLING_SMALL
    params, sv, grad = _record(cfg, h)
    w1t, w2t, wqt = (params[i].float() for i in (3, 5, 8))
    for c, ((feats, e1), qin) in enumerate(zip(sv["hm"], sv["qins"])):
        for w, x in ((w1t, feats), (w2t, e1), (wqt, qin)):
            got = mm3(w, x)
            _close_values(got, w @ x)
            _within_bound(w, x, got)
        B = feats.shape[1]
        dq, d_hm = grad(h, B), grad(h, B)
        de1 = (w2t.T @ d_hm) * (e1 > 0)
        for a, b in ((wqt.T[:3 * h], dq), (w2t.T, d_hm),
                     (dq, qin.T), (d_hm, e1.T), (de1, feats.T)):
            got = mm3(a.contiguous(), b.contiguous())
            _close_grads(got, a @ b)
            _within_bound(a, b, got)


@pytest.mark.parametrize("h", WIDE)
def test_wide_float32_plan_and_records(h):
    """Above hidden 128 the float32 kernels' 3xTF32 products read their
    weights from L2, so the shared-memory plan is the one PR 15 measured;
    every shipped config stays on the kernels in float32; each (step,
    container) of a partial row keeps a record of f32 operands (bfloat16
    keeps its half-width one, q included above 128; float32 at h <= 128
    none), sized by `scratch_bytes`."""
    f32, bf16 = torch.float32, torch.bfloat16
    tp = 16
    for cfg in CONFIGS.values():
        assert RP.eligible(cfg, h, f32) and RP.eligible(cfg, h, bf16)
        assert RP.smem_bytes(cfg, h, True, dtype=f32) <= RP.SMEM_LIMIT
        WD2 = cfg.target_width * cfg.target_depth + 2
        FQ = 3 * h + 8
        assert RP.record_floats(cfg, h, f32) == \
            2 * (3 * h * tp + (FQ + h + WD2) * tp + h * tp)
        assert RP.record_floats(cfg, h, bf16) == \
            2 * (3 * h * tp + (FQ + h + WD2 + h) * tp // 2)
        assert RP.record_floats(cfg, 128, f32) == 0
        assert RP.record_floats(cfg, 128, bf16) == \
            3 * 128 * 32 + (3 * 128 + 8 + 128 + WD2) * 16
    rolling = CONFIGS["2d-rolling"]
    s = RP.scratch_bytes(rolling, 4096, h)
    assert s["records"] == 4 * 128 * 2 * 25 * RP.record_floats(rolling, h)
    assert RP.scratch_bytes(rolling, 4096, 128)["records"] == 0
    if h == 256:  # the float32 plans that PR 15 measured (223.0 KB)
        assert RP.smem_bytes(rolling, h, True) == 228344
        assert RP.smem_bytes(rolling, h, False) == 183800
        assert s["records"] == 1_699_020_800


@pytest.mark.parametrize("steps", [False, True])
def test_plain_backward_returns_its_gates(steps):
    """With `pre=True` the plain backward returns the same gradients bit
    for bit and every step's ReLU pre-activations with their inputs: ReLU
    of them is the plain forward's e1 and h1; `near_zero_gates` counts
    only gates of acting instances and live columns."""
    cfg = ROLLING_SMALL if steps else CONFIGS["2d-basic"]
    dev = torch.device("cpu")
    actor = init_params(0, cfg, 32, dev)
    ops, _ = CS.replay_operands(actor, cfg, 8, dev, 10, 1.0)
    dlp = torch.linspace(-1.0, 1.0, 8)
    if steps:
        so = ops[:4] + (RP._prev_rows(ops[3]),) + ops[4:]
        ref = RP.replay_logp_bwd_steps_ref
    else:
        so, ref = ops, RP.replay_logp_bwd_ref
    plain = ref(dlp, *so, cfg, 1.0)
    *again, pres = ref(dlp, *so, cfg, 1.0, pre=True)
    for a, b in zip(CS._flat_grads(plain), CS._flat_grads(again)):
        assert torch.equal(a, b)
    assert [p["k"] for p in pres] == list(range(cfg.num_blocks))
    flags, hms, _, acts, _, ctx, _, statm, params = ops
    prev = RP._prev_rows(acts)
    for p in pres:
        k = p["k"]
        _, _, _, sv = RP._head_queries(cfg, k, flags[k], hms[k], prev[k],
                                       ctx, statm, params)
        for (feats, e1), f, pre in zip(sv["hm"], p["feats"], p["e1"]):
            assert torch.equal(f, feats) and torch.equal(torch.relu(pre), e1)
        assert p["x"].shape == (8, cfg.num_blocks * cfg.num_rot, 8)
        assert p["h1"].shape == (32,) + p["x"].shape[1:]
    n, rows = GW.near_zero_gates(pres, ops, cfg)
    assert n >= 0 and set(rows) == {"W1", "W8"}
    # a gate of an instance that never acts cannot count
    none = list(ops)
    none[3] = torch.full_like(acts, -1)
    assert GW.near_zero_gates(pres, tuple(none), cfg)[0] == 0
