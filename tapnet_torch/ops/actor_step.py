"""actor_select_step: one whole decode step of the learned policy, batch-last.

Port of `tapnet_tpu/ops/pallas_actor_step.py`: accessibility from
precedence bitmasks -> flags -> mask -> heightmap encoder, previous-action
embedding, query and per-token dyn MLP -> additive attention -> masked
(tempered) logits + gumbel -> select/place -> log pi of the chosen action.

Exactness (SPEC.md §12): the integer outputs (flags, mask, env state,
actions given equal argmax) are bit-equal to the JAX kernel; logits and
logp follow the same formula with the same f32 rounding points, and agree
to accumulation-order tolerance.

- `actor_select_step_ref`: the plain PyTorch version (the JAX kernel's
  formula as batched tensor ops), used on CPU tensors and as the reference
  the kernel is held to;
- `actor_select_step`: on a CUDA tensor it launches `csrc/actor_step.cu` on
  the current stream and counts it in `actor_select_step.launches`.

Coverage, as the JAX kernel's: both placement rules (`lb`, `mcs`),
unbounded height, N <= 62. The precedence graphs arrive as column bitmasks
in L = ceil(N/31) limbs of 31 bits; a rolling window is cut inside the
kernel (rank[i] = accessible blocks before i, win = acc0 & rank < window),
written to flag bit 3 and used for the mask, the count summary and the token
input. All T tokens are scored and the ones outside the window masked to
-1e9, which gives the windowed head's softmax exactly (exp(-1e9 - max) is
0). A finite height cap is not covered, here as there: its mask needs a
candidate scan per action, and such configs decode through `select_step`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.env.core import rotated_dims_all
from tapnet_torch.models.features import _scale
from tapnet_torch.ops import _build
from tapnet_torch.ops.policy_step import (MAX_WD, _check, env_ints,
                                          select_place_ref)

NEG = -1e9
MAX_C = 4  # csrc/actor_step.cu
SMEM_LIMIT = 232448  # bytes of shared memory a block may hold


MAX_N = 62  # two 31-bit precedence limbs


def eligible(cfg: TAPConfig) -> bool:
    """Unbounded height and bitmask-size precedence (N <= 62), as the JAX
    kernel; rolling windows are cut inside the kernel. The port's own
    limits: at most 4 containers and W*D <= 256 cells."""
    return (cfg.target_height == 0 and cfg.num_blocks <= MAX_N
            and cfg.num_containers <= MAX_C
            and cfg.target_width * cfg.target_depth <= MAX_WD)


def _check_cfg(cfg: TAPConfig):
    if not eligible(cfg):
        raise NotImplementedError(
            f"actor_select_step covers unbounded height, N <= {MAX_N}, C <= "
            f"{MAX_C} and W*D <= {MAX_WD}, not {cfg}")


def _num_limbs(N: int) -> int:
    """31-bit int32 bitmask limbs covering N blocks (sign bit unused)."""
    return (N + 30) // 31


def smem_bytes(cfg: TAPConfig, h: int) -> int:
    """Shared memory of one block, in bytes, as
    csrc/actor_step.cu::smem_bytes computes it."""
    C, A = cfg.num_containers, cfg.num_actions
    WD = cfg.target_width * cfg.target_depth
    floats = 32 * ((WD + 2) + h + (3 * h + 8) + C * h + 8 + 32 + 16 * C
                   + 2 * A)
    return 4 * (floats + 32 * (A + 8))


def head_operands(actor, cfg: TAPConfig, grad: bool = False):
    """The actor head's weights in the kernel's [out, in] layout (W @ X with
    the batch as the last axis), f32, contiguous, in the kernel's order:
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v.

    Detached for the rollout; with `grad=True` they keep the autograd graph
    (transposes and column views of the parameters), so the replay's
    gradients reach `actor.dyn_hidden.weight` and the others."""
    f = lambda t: (t if grad else t.detach()).float().contiguous()
    col = lambda b: f(b)[:, None].contiguous()
    hm = actor.hm_enc
    return (f(actor.dyn_hidden.weight), col(actor.dyn_hidden.bias),
            f(actor.dyn_proj.weight),
            f(hm.Dense_0.weight), col(hm.Dense_0.bias),
            f(hm.Dense_1.weight), col(hm.Dense_1.bias),
            f(actor.prev_embed.weight.T),
            f(actor.query.weight), col(actor.query.bias),
            f(actor.v))


def head_shapes(cfg: TAPConfig, h: int):
    """Shapes of the 11 head operands, in `head_operands` order."""
    WD = cfg.target_width * cfg.target_depth
    A = cfg.num_actions
    return [(32, 8), (32, 1), (h, 32), (h, WD + 2), (h, 1), (h, h), (h, 1),
            (h, A + 1), (h, 3 * h + 8), (h, 1), (h, 1)]


def precedence_bitmasks(instances, cfg: TAPConfig):
    """Column bitmasks of the up/rot graphs, i32[L*N, B], L = ceil(N/31):
    upm[l*N + i, b] = sum_{j in limb l} up[b, j, i] << (j - 31 l)."""
    N = cfg.num_blocks
    j = torch.arange(N, device=instances.up.device)

    def limbs(graph):
        g = graph.long()                                     # [B, j, i]
        rows = []
        for limb in range(_num_limbs(N)):
            in_l = (j >= 31 * limb) & (j < 31 * (limb + 1))
            pw = torch.where(in_l, 1 << (j - 31 * limb).clamp(0, 30), 0)
            rows.append((g * pw[None, :, None]).sum(1).T)    # [N, B]
        return torch.cat(rows, 0).int().contiguous()

    return limbs(instances.up), limbs(instances.rot)


def fits_planes(instances, cfg: TAPConfig):
    """Per-rotation geometric target fit, i32[R*N, B]."""
    rows = []
    for r in range(cfg.num_rot):
        d = rotated_dims_all(instances.dims, r, cfg)
        rows.append(((d[..., 0] <= cfg.target_width)
                     & (d[..., 1] <= cfg.target_depth)).int().T)
    return torch.cat(rows, 0).contiguous()


def actor_select_step_ref(tf, packed, hm, plc, prev, dims_w, dims_d, dims_h,
                          upm, rotm, fits, g, se, ctx, statp, statm, params,
                          cfg: TAPConfig, temperature: float = 1.0):
    """Plain version. tf f32[1, 1] (t/N), packed i32[N, B], hm i32[C*W, D, B],
    plc i32[N*6, B], prev i32[1, B], dims_* i32[N, B], upm/rotm i32[L*N, B]
    (`precedence_bitmasks`), fits i32[R*N, B], g f32[A, B] (zeros = greedy), se f32[T, h, B],
    ctx f32[h, B], statp f32[4, T, B], statm f32[4, B],
    params = head_operands(...).

    Returns (packed', hm', plc', act i32[B], flags i32[N, B], mask i32[A, B],
    logits f32[A, B], logp f32[B])."""
    _check_cfg(cfg)
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    R, A = cfg.num_rot, cfg.num_actions
    T = N * R
    B = packed.shape[1]
    dev = packed.device
    f32 = torch.float32
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params

    # accessibility from the bitmask limbs (env.core._accessibility
    # semantics: blocked[i] = any_j graph[j, i] & unpacked[j])
    unpk = 1 - packed
    iota = torch.arange(N, device=dev)
    blocked0 = torch.zeros((N, B), dtype=torch.bool, device=dev)
    blockedr = torch.zeros((N, B), dtype=torch.bool, device=dev)
    for limb in range(_num_limbs(N)):
        in_l = (iota >= 31 * limb) & (iota < 31 * (limb + 1))
        pw = torch.where(in_l, 1 << (iota - 31 * limb).clamp(0, 30),
                         0).int()[:, None]
        ub = (unpk * pw).sum(0, keepdim=True).int()           # [1, B]
        blocked0 |= (upm[limb * N:(limb + 1) * N] & ub) != 0
        blockedr |= (rotm[limb * N:(limb + 1) * N] & ub) != 0
    acc0 = (unpk == 1) & ~blocked0
    accr = acc0 & ~blockedr
    acc0_i, accr_i = acc0.int(), accr.int()
    if cfg.window > 0:
        # rolling window: the first `window` accessible blocks in index
        # order (features.dynamic_flags)
        rank = acc0_i.cumsum(0) - acc0_i
        win_i = acc0_i * (rank < cfg.window).int()
    else:
        win_i = acc0_i
    flags = packed + 2 * acc0_i + 4 * accr_i + 8 * win_i

    ok = torch.stack([win_i, win_i * accr_i][:R], 0)         # [R, N, B]
    mask_nr = (ok * fits.reshape(R, N, B)).permute(1, 0, 2)   # [N, R, B]
    mask = mask_nr[:, :, None].expand(N, R, C, B).reshape(A, B).int()

    # exact-count context summary dsum [8, B]
    pk = packed.sum(0, keepdim=True).to(f32)
    a0 = acc0_i.sum(0, keepdim=True).to(f32)
    ar = accr_i.sum(0, keepdim=True).to(f32)
    wn = win_i.sum(0, keepdim=True).to(f32)
    acc_mean = (a0 + ar) / T if R == 2 else a0 / N
    tf_row = torch.ones(1, B, dtype=f32, device=dev) * tf.reshape(1, 1)
    dsum = torch.cat([pk / N, acc_mean, wn / N, tf_row, statm], 0)

    # heightmap encoder per container, then the query
    inv_s = torch.tensor(1.0 / _scale(cfg), dtype=f32, device=dev)
    idx = (prev + 1).clamp(0, A).long()[0]                    # [B]
    prev_emb = et[:, idx]                                     # [h, B]
    qs = []
    for c in range(C):
        xc = hm[c * W:(c + 1) * W].reshape(W * D, B).to(f32) * inv_s
        feats = torch.cat([xc, xc.amax(0, keepdim=True),
                           xc.sum(0, keepdim=True) / (W * D)], 0)
        e1 = torch.relu(w1t @ feats + b1)
        enc = w2t @ e1 + b2
        qs.append(wqt @ torch.cat([enc, ctx, prev_emb, dsum], 0) + bq)

    # per-token dyn MLP + additive attention; token t = (i, r)
    pk_t = packed.to(f32).repeat_interleave(R, 0)             # [T, B]
    ac_t = torch.stack([acc0_i, accr_i][:R], 1).reshape(T, B).to(f32)
    wn_t = win_i.to(f32).repeat_interleave(R, 0)
    x_all = torch.stack([pk_t, ac_t, wn_t, tf_row.expand(T, B),
                         statp[0], statp[1], statp[2], statp[3]], 0)
    h1 = torch.relu(w8t @ x_all.reshape(8, T * B) + b8)       # [32, T*B]
    dyn = (wpt @ h1).reshape(-1, T, B).permute(1, 0, 2)       # [T, h, B]
    sd = se + dyn
    scores = torch.stack([(torch.tanh(sd + q[None]) * v[None]).sum(1)
                          for q in qs], 1).reshape(A, B)      # [A, B]

    masked = torch.where(mask == 1, scores / temperature,
                         torch.tensor(NEG, dtype=f32, device=dev))
    p_n, h_n, l_n, a_n = select_place_ref(cfg, masked + g, mask, packed, hm,
                                          plc, dims_w, dims_d, dims_h)
    mx = masked.amax(0)
    lse = torch.log(torch.exp(masked - mx).sum(0))
    bi = torch.arange(B, device=dev)
    lp = (masked[a_n.clamp(min=0).long(), bi] - mx) - lse
    logp = torch.where(a_n >= 0, lp, torch.zeros_like(lp))
    return p_n, h_n, l_n, a_n, flags.int(), mask, scores, logp


@functools.cache
def _lib():
    lib = _build.load("actor_step")
    fn = lib.tapnet_actor_select_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def actor_select_step(tf, packed, hm, plc, prev, dims_w, dims_d, dims_h,
                      upm, rotm, fits, g, se, ctx, statp, statm, params,
                      cfg: TAPConfig, temperature: float = 1.0):
    """One fused actor + select decode step; operands and results as in
    `actor_select_step_ref`."""
    if not packed.is_cuda:
        return actor_select_step_ref(tf, packed, hm, plc, prev, dims_w,
                                     dims_d, dims_h, upm, rotm, fits, g, se,
                                     ctx, statp, statm, params, cfg,
                                     temperature)
    _check_cfg(cfg)
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    R, A = cfg.num_rot, cfg.num_actions
    T, B, h = N * R, packed.shape[1], se.shape[1]
    L = _num_limbs(N)
    if smem_bytes(cfg, h) > SMEM_LIMIT:
        raise NotImplementedError(
            f"actor_select_step: {smem_bytes(cfg, h)} B of shared memory per "
            f"block at hidden {h} exceed the {SMEM_LIMIT} B a block may hold")
    dev, i32, f32 = packed.device, torch.int32, torch.float32
    shapes = [("tf", tf, (1, 1), f32), ("packed", packed, (N, B), i32),
              ("hm", hm, (C * W, D, B), i32), ("plc", plc, (N * 6, B), i32),
              ("prev", prev, (1, B), i32), ("dims_w", dims_w, (N, B), i32),
              ("dims_d", dims_d, (N, B), i32), ("dims_h", dims_h, (N, B), i32),
              ("upm", upm, (L * N, B), i32), ("rotm", rotm, (L * N, B), i32),
              ("fits", fits, (R * N, B), i32), ("g", g, (A, B), f32),
              ("se", se, (T, h, B), f32), ("ctx", ctx, (h, B), f32),
              ("statp", statp, (4, T, B), f32), ("statm", statm, (4, B), f32)]
    shapes += [(f"params[{k}]", p, s, f32)
               for k, (p, s) in enumerate(zip(params, head_shapes(cfg, h)))]
    for name, t, shape, dt in shapes:
        _check(t, name, shape, dt, dev)
    outs = (torch.empty_like(packed), torch.empty_like(hm),
            torch.empty_like(plc), torch.empty(B, dtype=i32, device=dev),
            torch.empty((N, B), dtype=i32, device=dev),
            torch.empty((A, B), dtype=i32, device=dev),
            torch.empty((A, B), dtype=f32, device=dev),
            torch.empty(B, dtype=f32, device=dev))
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = _build.ptr_array(
            (packed, hm, plc, dims_w, dims_d, dims_h, tf, prev, upm, rotm,
             fits, g, se, ctx, statp, statm) + tuple(params) + outs)
        ints = _build.int_array([B] + env_ints(cfg) + [h, cfg.window])
        err = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(ints, ctypes.c_void_p),
                 ctypes.c_float(1.0 / _scale(cfg)),
                 ctypes.c_float(temperature), ctypes.c_void_p(stream))
    actor_select_step.launches += 1
    _build.check(err, "actor_select_step")
    return outs


actor_select_step.launches = 0
