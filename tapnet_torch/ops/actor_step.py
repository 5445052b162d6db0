"""actor_select_step: one whole decode step of the learned policy, batch-last.

Port of `tapnet_tpu/ops/pallas_actor_step.py`: accessibility from
precedence bitmasks -> flags -> mask -> heightmap encoder, previous-action
embedding, query and per-token dyn MLP -> additive attention -> masked
(tempered) logits + gumbel -> select/place -> log pi of the chosen action.

Exactness (SPEC.md §12): the integer outputs (flags, mask, env state,
actions given equal argmax) are bit-equal to the JAX kernel; logits and
logp follow the same formula with the same f32 rounding points, and agree
to accumulation-order tolerance.

Two modes. The full one (`logits=True`) scores every token and returns the
logits [A, B]. The decode loop's mode (`logits=False`, what
`train/rollout.py` runs) scores only the live columns (`live_columns`: the
pairs (instance, token) whose mask allows the token in some container) and
returns None for the logits: every other action scores -1e9 masked, adds
exactly 0 to the softmax (exp(-1e9 - max) is 0 in f32) and never wins the
gumbel argmax while any action is valid, so action, state, flags and mask
are the full mode's and logp its sum less exact zeros.

- `actor_select_step_ref`: the plain PyTorch version of the full mode (the
  JAX kernel's formula as batched tensor ops), the reference the kernel is
  held to; `actor_select_step_live_ref`: the plain version of the live
  mode;
- `actor_select_step`: on a CPU tensor the plain version of the mode asked
  for; on a CUDA tensor it launches `csrc/actor_step.cu` on the current
  stream and counts it in `actor_select_step.launches`.

Coverage, as the JAX kernel's: both placement rules (`lb`, `mcs`),
unbounded height, N <= 62. The precedence graphs arrive as column bitmasks
in L = ceil(N/31) limbs of 31 bits; a rolling window is cut inside the
kernel (rank[i] = accessible blocks before i, win = acc0 & rank < window),
written to flag bit 3 and used for the mask, the count summary and the token
input; the tokens outside the window are masked, which gives the windowed
head's softmax exactly. A finite height cap is not covered, here as there:
its mask needs a candidate scan per action, and such configs decode through
`select_step`. The kernel's own limits (`eligible`): C <= 4, W*D <= 256, a
hidden width that is a multiple of 32 up to 128, and a block's shared
memory within 227 KB; the routers (`train/rollout.py` `routes`) send any
other config down the step-fused path.

The static keys `se` are [B, T, h]: a column's keys are one contiguous row
(the JAX kernel's [T, h, B] transposed), built once per rollout.
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
MAX_N = 62  # two 31-bit precedence limbs
MAX_H = 128  # hidden: a multiple of 32, at most 128
SMEM_LIMIT = 232448  # bytes of shared memory a block may hold
TB, LD, G, KS = 32, 33, 64, 64  # csrc/actor_step.cu: tile, stride, group,
#                                 weight slice


def _covers_config(cfg: TAPConfig) -> bool:
    return (cfg.target_height == 0 and cfg.num_blocks <= MAX_N
            and cfg.num_containers <= MAX_C
            and cfg.target_width * cfg.target_depth <= MAX_WD)


def eligible(cfg: TAPConfig, h: int = 128) -> bool:
    """Configs the kernel covers at hidden width h: unbounded height and
    bitmask-size precedence (N <= 62), as the JAX kernel (rolling windows
    are cut inside the kernel); the port's own limits: at most 4
    containers, W*D <= 256 cells, h a multiple of 32 up to 128 and a block
    that fits in shared memory (`smem_bytes`)."""
    return (_covers_config(cfg) and h % 32 == 0 and 0 < h <= MAX_H
            and smem_bytes(cfg, h) <= SMEM_LIMIT)


def _check_cfg(cfg: TAPConfig, h: int = None):
    """Raise NotImplementedError outside the config rule or, given h, the
    kernel's coverage."""
    if not _covers_config(cfg):
        raise NotImplementedError(
            f"actor_select_step covers unbounded height, N <= {MAX_N}, C <= "
            f"{MAX_C} and W*D <= {MAX_WD}, not {cfg}")
    if h is not None and not eligible(cfg, h):
        raise NotImplementedError(
            f"actor_select_step kernel covers a hidden width that is a "
            f"multiple of 32 up to {MAX_H} with at most {SMEM_LIMIT} B of "
            f"shared memory per block, not hidden {h} "
            f"({smem_bytes(cfg, h)} B) on {cfg}")


def _num_limbs(N: int) -> int:
    """31-bit int32 bitmask limbs covering N blocks (sign bit unused)."""
    return (N + 30) // 31


def smem_bytes(cfg: TAPConfig, h: int) -> int:
    """Shared memory of one block, in bytes, as
    csrc/actor_step.cu::smem_bytes computes it."""
    up4 = lambda x: (x + 3) & ~3
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD = cfg.target_width * cfg.target_depth
    T = N * R
    A = T * C
    floats = (up4(32 * h) + 256 + 32 + up4(h) + up4(C * h * LD)
              + A * TB + up4((WD + 2 + h + 3 * h + 8) * LD)
              + max(40 * G, KS * h,
                    (N + 2 * _num_limbs(N) * N + R * N) * TB,
                    (13 + 8 * 16 + C * WD + 3 * N) * TB))
    ints = 12 * TB + 4 * TB + TB + 2 + TB * T
    return 4 * (floats + ints)


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


def transposed(params):
    """W1, W2 and Wq of `head_operands` as [in, h]: the K2 and K5 kernels
    stream their rows. The decode loop makes them once per rollout."""
    return tuple(params[i].T.contiguous() for i in (3, 5, 8))


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


def _head_state(tf, packed, hm, prev, upm, rotm, fits, ctx, statm, params,
                cfg: TAPConfig):
    """A decode step up to its token work: flags [N, B], mask [A, B], the
    planes (acc0, accr, win) [N, B], t/N as a row [1, B] and the C queries
    [h, B] (`actor_select_step_ref` operands)."""
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    R, A = cfg.num_rot, cfg.num_actions
    T = N * R
    B = packed.shape[1]
    dev = packed.device
    f32 = torch.float32
    _, _, _, w1t, b1, w2t, b2, et, wqt, bq, _ = params

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
    return flags.int(), mask, (acc0_i, accr_i, win_i), tf_row, qs


def _token_inputs(packed, planes, tf_row, statp, cfg: TAPConfig):
    """The dyn MLP's input x [8, T, B]; token t = (i, r)."""
    R, T = cfg.num_rot, cfg.num_blocks * cfg.num_rot
    B = packed.shape[1]
    f32 = torch.float32
    acc0_i, accr_i, win_i = planes
    pk_t = packed.to(f32).repeat_interleave(R, 0)             # [T, B]
    ac_t = torch.stack([acc0_i, accr_i][:R], 1).reshape(T, B).to(f32)
    wn_t = win_i.to(f32).repeat_interleave(R, 0)
    return torch.stack([pk_t, ac_t, wn_t, tf_row.expand(T, B),
                        statp[0], statp[1], statp[2], statp[3]], 0)


def _select_logp(masked, g, mask, packed, hm, plc, dims_w, dims_d, dims_h,
                 cfg: TAPConfig):
    """Gumbel argmax + select/place of the masked scores [A, B], and log pi
    of the chosen action (0 where none is valid)."""
    B = packed.shape[1]
    p_n, h_n, l_n, a_n = select_place_ref(cfg, masked + g, mask, packed, hm,
                                          plc, dims_w, dims_d, dims_h)
    mx = masked.amax(0)
    lse = torch.log(torch.exp(masked - mx).sum(0))
    bi = torch.arange(B, device=packed.device)
    lp = (masked[a_n.clamp(min=0).long(), bi] - mx) - lse
    logp = torch.where(a_n >= 0, lp, torch.zeros_like(lp))
    return p_n, h_n, l_n, a_n, logp


def actor_select_step_ref(tf, packed, hm, plc, prev, dims_w, dims_d, dims_h,
                          upm, rotm, fits, g, se, ctx, statp, statm, params,
                          cfg: TAPConfig, temperature: float = 1.0):
    """Plain version of the full mode. tf f32[1, 1] (t/N), packed i32[N, B],
    hm i32[C*W, D, B], plc i32[N*6, B], prev i32[1, B], dims_* i32[N, B],
    upm/rotm i32[L*N, B] (`precedence_bitmasks`), fits i32[R*N, B], g
    f32[A, B] (zeros = greedy), se f32[B, T, h], ctx f32[h, B], statp
    f32[4, T, B], statm f32[4, B], params = head_operands(...).

    Returns (packed', hm', plc', act i32[B], flags i32[N, B], mask i32[A, B],
    logits f32[A, B], logp f32[B])."""
    _check_cfg(cfg)
    T, A = cfg.num_blocks * cfg.num_rot, cfg.num_actions
    B = packed.shape[1]
    w8t, b8, wpt, _, _, _, _, _, _, _, v = params
    flags, mask, planes, tf_row, qs = _head_state(
        tf, packed, hm, prev, upm, rotm, fits, ctx, statm, params, cfg)
    x_all = _token_inputs(packed, planes, tf_row, statp, cfg)
    h1 = torch.relu(w8t @ x_all.reshape(8, T * B) + b8)       # [32, T*B]
    dyn = (wpt @ h1).reshape(-1, T, B).permute(1, 0, 2)       # [T, h, B]
    sd = se.permute(1, 2, 0) + dyn
    scores = torch.stack([(torch.tanh(sd + q[None]) * v[None]).sum(1)
                          for q in qs], 1).reshape(A, B)      # [A, B]
    masked = torch.where(mask == 1, scores / temperature,
                         torch.tensor(NEG, dtype=scores.dtype,
                                      device=scores.device))
    p_n, h_n, l_n, a_n, logp = _select_logp(masked, g, mask, packed, hm, plc,
                                            dims_w, dims_d, dims_h, cfg)
    return p_n, h_n, l_n, a_n, flags, mask, scores, logp


def live_columns(mask, cfg: TAPConfig):
    """The live columns of a decode step, the rule the kernel's main-path
    mode applies: pairs (instance b, token t) whose mask [A, B] allows t in
    some container (which implies that the instance has a valid action).
    Returns (b [n], t [n]) ordered by instance, then token, the kernel's
    column order. Every other action scores -1e9 masked and adds exactly 0
    to the softmax."""
    T, C = cfg.num_blocks * cfg.num_rot, cfg.num_containers
    live = (mask.reshape(T, C, -1) == 1).any(1)               # [T, B]
    b, t = live.T.nonzero(as_tuple=True)
    return b, t


def actor_select_step_live_ref(tf, packed, hm, plc, prev, dims_w, dims_d,
                               dims_h, upm, rotm, fits, g, se, ctx, statp,
                               statm, params, cfg: TAPConfig,
                               temperature: float = 1.0):
    """Plain version of the decode loop's mode: operands as in
    `actor_select_step_ref`; the dyn MLP and the attention run on the live
    columns only (`live_columns`), every other action is masked. Returns
    the full version's outputs with None for the logits: the integer ones
    equal, logp the same sum less exact zeros."""
    _check_cfg(cfg)
    T, C, A = cfg.num_blocks * cfg.num_rot, cfg.num_containers, cfg.num_actions
    B = packed.shape[1]
    w8t, b8, wpt, _, _, _, _, _, _, _, v = params
    flags, mask, planes, tf_row, qs = _head_state(
        tf, packed, hm, prev, upm, rotm, fits, ctx, statm, params, cfg)
    b, t = live_columns(mask, cfg)
    x = _token_inputs(packed, planes, tf_row, statp, cfg)[:, t, b]  # [8, n]
    h1 = torch.relu(w8t @ x + b8)                             # [32, n]
    sd = se[b, t].T + wpt @ h1                                # [h, n]
    scores = torch.stack([(torch.tanh(sd + q[:, b]) * v).sum(0)
                          for q in qs], 1)                    # [n, C]
    masked = torch.full((T, C, B), NEG, dtype=scores.dtype,
                        device=scores.device)
    masked[t, :, b] = scores / temperature
    p_n, h_n, l_n, a_n, logp = _select_logp(masked.reshape(A, B), g, mask,
                                            packed, hm, plc, dims_w, dims_d,
                                            dims_h, cfg)
    return p_n, h_n, l_n, a_n, flags, mask, None, logp


@functools.cache
def _lib():
    lib = _build.load("actor_step")
    fn = lib.tapnet_actor_select_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(ops, cfg: TAPConfig, temperature: float, logits: bool,
            params_t, stream: int):
    """Check the operands, allocate the outputs on their device and launch
    the kernel on `stream`. Returns (outputs, CUDA error code)."""
    (tf, packed, hm, plc, prev, dims_w, dims_d, dims_h, upm, rotm, fits, g,
     se, ctx, statp, statm, params) = ops
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    R, A = cfg.num_rot, cfg.num_actions
    T, B, h = N * R, packed.shape[1], se.shape[2]
    _check_cfg(cfg, h)
    L = _num_limbs(N)
    dev, i32, f32 = packed.device, torch.int32, torch.float32
    shapes = [("tf", tf, (1, 1), f32), ("packed", packed, (N, B), i32),
              ("hm", hm, (C * W, D, B), i32), ("plc", plc, (N * 6, B), i32),
              ("prev", prev, (1, B), i32), ("dims_w", dims_w, (N, B), i32),
              ("dims_d", dims_d, (N, B), i32), ("dims_h", dims_h, (N, B), i32),
              ("upm", upm, (L * N, B), i32), ("rotm", rotm, (L * N, B), i32),
              ("fits", fits, (R * N, B), i32), ("g", g, (A, B), f32),
              ("se", se, (B, T, h), f32), ("ctx", ctx, (h, B), f32),
              ("statp", statp, (4, T, B), f32), ("statm", statm, (4, B), f32)]
    shapes += [(f"params[{k}]", p, s, f32)
               for k, (p, s) in enumerate(zip(params, head_shapes(cfg, h)))]
    WD = W * D
    shapes += [(f"params_t[{k}]", p, s, f32) for k, (p, s) in enumerate(
        zip(params_t, [(WD + 2, h), (h, h), (3 * h + 8, h)]))]
    for name, t, shape, dt in shapes:
        _check(t, name, shape, dt, dev)
    outs = (torch.empty_like(packed), torch.empty_like(hm),
            torch.empty_like(plc), torch.empty(B, dtype=i32, device=dev),
            torch.empty((N, B), dtype=i32, device=dev),
            torch.empty((A, B), dtype=i32, device=dev),
            torch.empty((A, B), dtype=f32, device=dev) if logits else None,
            torch.empty(B, dtype=f32, device=dev))
    none = torch.empty(0, device=dev)
    ptrs = _build.ptr_array(
        (packed, hm, plc, dims_w, dims_d, dims_h, tf, prev, upm, rotm, fits,
         g, se, ctx, statp, statm) + tuple(params)
        + tuple(none if o is None else o for o in outs) + tuple(params_t))
    ints = _build.int_array([B] + env_ints(cfg)
                            + [h, cfg.window, int(logits)])
    err = _lib()(ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(ints, ctypes.c_void_p),
                 ctypes.c_float(1.0 / _scale(cfg)),
                 ctypes.c_float(temperature), ctypes.c_void_p(stream))
    return outs, err


def actor_select_step(tf, packed, hm, plc, prev, dims_w, dims_d, dims_h,
                      upm, rotm, fits, g, se, ctx, statp, statm, params,
                      cfg: TAPConfig, temperature: float = 1.0,
                      logits: bool = True, params_t=None):
    """One fused actor + select decode step; operands and results as in
    `actor_select_step_ref`. `logits=False`: the decode loop's mode, the
    token work on the live columns only and None in the logits' slot.
    params_t: `transposed(params)` (made here when not given)."""
    ops = (tf, packed, hm, plc, prev, dims_w, dims_d, dims_h, upm, rotm,
           fits, g, se, ctx, statp, statm, params)
    if not packed.is_cuda:
        ref = actor_select_step_ref if logits else actor_select_step_live_ref
        return ref(*ops, cfg, temperature)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        outs, err = _launch(ops, cfg, temperature, logits,
                            params_t or transposed(params), stream)
    actor_select_step.launches += 1
    _build.check(err, "actor_select_step")
    return outs


actor_select_step.launches = 0
