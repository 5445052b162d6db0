"""replay_logp: the differentiated REINFORCE replay of the actor head, the
port of `tapnet_tpu/ops/pallas_replay.py` (both schedules).

Given the rollout record (flags, heightmaps, masks, actions), the static
keys se [T, h, B], their mean ctx [h, B], the static token features and the
head weights (`actor_step.head_operands`), the forward is the per-instance
sum over decode steps of log pi(a_t | s_t) and the backward is its
hand-derived gradient (`_bwd_step`): d_se [T, h, B], d_ctx [h, B] and the
gradients of the 11 head weights summed over the batch.

- `replay_logp_fwd_ref` / `replay_logp_bwd_ref`: the plain PyTorch
  versions, following `_head_fwd`, `_logp_row` and `_bwd_step` formula for
  formula; used on CPU tensors and as the reference the kernels are held to;
- `replay_logp_fwd` / `replay_logp_bwd`: on CUDA tensors they launch
  `csrc/replay.cu` (the backward is the kernel plus a fixed-order sum of
  its per-tile weight-gradient partials) and count their launches;
- `replay_logp_fwd_steps` / `replay_logp_bwd_steps`: the step-grid schedule
  (`_steps_grid`: rolling windows and N > 31, up to N = 62). The same value
  and gradients from the same record plus `prev` [S, B] (the actions
  shifted by a step); on the card a grid over (batch tiles, step chunks)
  whose per-chunk partials of logp, d_se, d_ctx and the weight gradients
  are summed in a fixed order by a second kernel (`step_chunks` picks the
  chunks). Their plain versions walk the same chunks. Own launch counters;
- `ReplayLogp`: the `torch.autograd.Function` around them, routing by
  `_steps_grid(cfg)`. With `logp0` given (the rollout kernel's own logp,
  `use_primal` of the JAX custom VJP) the forward returns it and launches
  nothing; the backward is the same.

Coverage: every unbounded or capped config with N <= 62 and at most 4
containers whose shared-memory plan fits a block (`eligible`). A rolling
window enters the replay only through the recorded flag bit 3 and the
recorded mask: all T tokens are scored and the ones outside the window
masked to -1e9, which is the windowed softmax exactly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.models.features import _scale
from tapnet_torch.ops import _build
from tapnet_torch.ops.actor_step import head_shapes
from tapnet_torch.ops.policy_step import _check

NEG = -1e9
MAX_C = 4
TB, LD, NWARP = 32, 33, 16         # csrc/replay.cu
SMEM_LIMIT = 232448                # bytes of shared memory a block may hold


def _ints(cfg: TAPConfig, B: int, h: int):
    return [B, cfg.num_blocks, cfg.target_width, cfg.target_depth,
            cfg.num_rot, cfg.num_containers, h]


MAX_N = 62                         # step-grid: 64-bit flag words
SM_COUNT = 132                     # H100 SXM; `step_chunks` fills them


def _steps_grid(cfg: TAPConfig) -> bool:
    """The step-grid schedule serves rolling windows and N > 31 (the
    monolithic kernel packs a block set into one 32-bit word)."""
    return cfg.window > 0 or cfg.num_blocks > 31


def smem_bytes(cfg: TAPConfig, h: int, bwd: bool, steps=None) -> int:
    """Shared memory of one block, in bytes, as
    csrc/replay.cu::smem_bytes computes it (`steps`: the schedule; auto by
    `_steps_grid`)."""
    if steps is None:
        steps = _steps_grid(cfg)
    C, A = cfg.num_containers, cfg.num_actions
    WD = cfg.target_width * cfg.target_depth
    FQ = 3 * h + 8
    union = max(WD + 2 + h + FQ + (3 * h if bwd else 0),
                8 + 32 + h + 32 + NWARP * C)
    rows = A + union
    floats = rows * LD + ((h * 32 + 256 + 32 + h) if bwd else 0)
    return 4 * (floats + (10 * TB + 1 if steps else 6 * TB))


def eligible(cfg: TAPConfig, h: int = 128) -> bool:
    """Configs the replay kernels cover: N <= 62 (N > 31 and rolling
    windows on the step-grid schedule), C <= 4, and a backward block that
    fits. A finite height cap is covered: the mask is the recorded one."""
    return (cfg.num_blocks <= MAX_N and cfg.num_containers <= MAX_C
            and smem_bytes(cfg, h, True) <= SMEM_LIMIT)


def _check_cfg(cfg: TAPConfig, h: int, steps: bool):
    if not steps and cfg.num_blocks > 31:
        raise NotImplementedError(
            "replay_logp: the monolithic schedule holds N <= 31; N > 31 "
            "runs the step-grid schedule (replay_logp_fwd_steps)")
    smem = smem_bytes(cfg, h, True, steps)
    if (cfg.num_blocks > MAX_N or cfg.num_containers > MAX_C
            or smem > SMEM_LIMIT):
        raise NotImplementedError(
            f"replay_logp kernels cover N <= {MAX_N} and C <= {MAX_C} with "
            f"at most {SMEM_LIMIT} B of shared memory per block, not {cfg} "
            f"at hidden {h} ({smem} B); pass kernel=False")


def step_chunks(cfg: TAPConfig, B: int) -> int:
    """Step chunks of the step-grid schedule at batch B: the fewest that
    give every SM a block (tiles x chunks >= 132), at most one per step.
    More chunks buy nothing once the card is full (a block holds most of
    an SM's shared memory, so one runs per SM), and each costs a d_se
    partial of T*h*B floats: 2 chunks and 420 MB at 2d-rolling, batch 4096,
    hidden 128."""
    tiles = (B + TB - 1) // TB
    S = cfg.num_blocks
    chunks = max(1, min(S, -(-SM_COUNT // tiles)))
    length = -(-S // chunks)
    return -(-S // length)


# ------------------------------------------------------------------ #
# plain versions

def _head_fwd(cfg, k, flags_k, hm_k, mask_k, prev, se, ctx, statp, statm,
              params, temperature):
    """Head of decode step k from the record, batch-last. Returns
    (masked [A, B], mask_f [A, B], saved activations)."""
    N, W, D = cfg.num_blocks, cfg.target_width, cfg.target_depth
    R, C, A = cfg.num_rot, cfg.num_containers, cfg.num_actions
    T = N * R
    B = flags_k.shape[1]
    dev = flags_k.device
    f32 = torch.float32
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params
    packed = flags_k & 1
    acc0 = (flags_k >> 1) & 1
    accr = (flags_k >> 2) & 1
    win = (flags_k >> 3) & 1
    tf = torch.tensor(k, dtype=f32, device=dev) / cfg.num_blocks
    pk = packed.sum(0, keepdim=True).to(f32)
    a0 = acc0.sum(0, keepdim=True).to(f32)
    ar = accr.sum(0, keepdim=True).to(f32)
    wn = win.sum(0, keepdim=True).to(f32)
    acc_mean = (a0 + ar) / T if R == 2 else a0 / N
    ones = torch.ones(1, B, dtype=f32, device=dev)
    dsum = torch.cat([pk / N, acc_mean, wn / N, ones * tf, statm], 0)

    inv_s = torch.tensor(1.0 / _scale(cfg), dtype=f32, device=dev)
    idx = (prev + 1).clamp(0, A).long()
    oh_prev = (torch.arange(A + 1, device=dev)[:, None] == idx[None]).to(f32)
    prev_emb = et[:, idx]                                     # [h, B]
    hm_saved, qins, qs = [], [], []
    for c in range(C):
        xc = hm_k[c * W:(c + 1) * W].reshape(W * D, B).to(f32) * inv_s
        feats = torch.cat([xc, xc.amax(0, keepdim=True),
                           xc.sum(0, keepdim=True) / (W * D)], 0)
        e1 = torch.relu(w1t @ feats + b1)
        enc = w2t @ e1 + b2
        qin = torch.cat([enc, ctx, prev_emb, dsum], 0)
        qs.append(wqt @ qin + bq)
        hm_saved.append((feats, e1))
        qins.append(qin)

    ac = torch.stack([acc0, accr][:R], 1).reshape(T, B).to(f32)
    x = torch.stack([packed.to(f32).repeat_interleave(R, 0), ac,
                     win.to(f32).repeat_interleave(R, 0),
                     (ones * tf).expand(T, B),
                     statp[0], statp[1], statp[2], statp[3]], 0)  # [8, T, B]
    h1 = torch.relu(w8t @ x.reshape(8, T * B) + b8).reshape(32, T, B)
    dyn = (wpt @ h1.reshape(32, T * B)).reshape(-1, T, B).permute(1, 0, 2)
    sd = se + dyn                                             # [T, h, B]
    act = torch.stack([torch.tanh(sd + q[None]) for q in qs], 1)  # [T,C,h,B]
    scores = (act * v[None, None]).sum(2).reshape(A, B)
    mask_f = mask_k.to(f32)
    masked = torch.where(mask_k == 1, scores / temperature,
                         torch.tensor(NEG, dtype=f32, device=dev))
    saved = dict(hm=hm_saved, qins=qins, oh_prev=oh_prev, x=x, h1=h1,
                 act=act)
    return masked, mask_f, saved


def _logp_row(masked, act_k):
    """(lp [B], p [A, B], onehot [A, B], valid [B]) of one decode step."""
    A = masked.shape[0]
    valid = (act_k >= 0).float()
    onehot = (torch.arange(A, device=masked.device)[:, None]
              == act_k.clamp(min=0)[None]).float()
    m = masked.amax(0, keepdim=True)
    e = torch.exp(masked - m)
    s = e.sum(0, keepdim=True)
    lsm = masked - m - torch.log(s)
    return (onehot * lsm).sum(0) * valid, e / s, onehot, valid


def _prev_rows(acts):
    return torch.cat([torch.full_like(acts[:1], -1), acts[:-1]], 0)


def _fwd_chunk(k0, k1, flags, hms, masks, acts, prev, se, ctx, statp, statm,
               params, cfg, temperature):
    """logp [B] summed over decode steps [k0, k1)."""
    total = torch.zeros(acts.shape[1], dtype=torch.float32,
                        device=acts.device)
    for k in range(k0, k1):
        masked, _, _ = _head_fwd(cfg, k, flags[k], hms[k], masks[k],
                                 prev[k], se, ctx, statp, statm, params,
                                 temperature)
        total = total + _logp_row(masked, acts[k])[0]
    return total


def replay_logp_fwd_ref(flags, hms, masks, acts, se, ctx, statp, statm,
                        params, cfg: TAPConfig, temperature: float = 1.0):
    """Plain forward. flags i32[S, N, B], hms i32[S, C*W, D, B], masks
    i32[S, A, B] (the recorded mask), acts i32[S, B], se f32[T, h, B],
    ctx f32[h, B], statp f32[4, T, B], statm f32[4, B], params =
    head_operands(...). Returns logp f32[B]."""
    return _fwd_chunk(0, cfg.num_blocks, flags, hms, masks, acts,
                      _prev_rows(acts), se, ctx, statp, statm, params, cfg,
                      temperature)


def _chunk_bounds(cfg, B):
    """[k0, k1) of each step chunk at batch B (`step_chunks`)."""
    S = cfg.num_blocks
    length = -(-S // step_chunks(cfg, B))
    return [(k0, min(k0 + length, S)) for k0 in range(0, S, length)]


def replay_logp_fwd_steps_ref(flags, hms, masks, acts, prev, se, ctx, statp,
                              statm, params, cfg: TAPConfig,
                              temperature: float = 1.0):
    """Plain step-grid forward: operands as `replay_logp_fwd_ref` plus
    prev i32[S, B] (the action before each step, -1 at step 0). Each chunk
    of steps (`step_chunks`) gives a partial logp; the partials are summed
    in chunk order."""
    parts = [_fwd_chunk(k0, k1, flags, hms, masks, acts, prev, se, ctx,
                        statp, statm, params, cfg, temperature)
             for k0, k1 in _chunk_bounds(cfg, acts.shape[1])]
    return torch.stack(parts, 0).sum(0) if len(parts) > 1 else parts[0]


def _bwd_chunk(k0, k1, dlp, flags, hms, masks, acts, prev, se, ctx, statp,
               statm, params, cfg, temperature):
    """(d_se, d_ctx, the 11 head-operand gradients) of decode steps
    [k0, k1)."""
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    T, h = N * R, se.shape[1]
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params
    g = [torch.zeros_like(p) for p in params]
    (dw8t, db8, dwpt, dw1t, db1, dw2t, db2, det, dwqt, dbq, dv) = g
    dse = torch.zeros_like(se)
    dctx = torch.zeros_like(ctx)
    inv_temp = torch.tensor(1.0 / temperature, dtype=torch.float32,
                            device=se.device)
    for k in range(k0, k1):
        masked, mask_f, sv = _head_fwd(cfg, k, flags[k], hms[k], masks[k],
                                       prev[k], se, ctx, statp, statm,
                                       params, temperature)
        _, p, onehot, valid = _logp_row(masked, acts[k])
        gsc = (dlp * valid * (onehot - p) * mask_f) * inv_temp   # [A, B]
        gsc = gsc.reshape(T, C, 1, -1)
        act = sv["act"]                                       # [T, C, h, B]
        dv += (act * gsc).sum((0, 1, 3))[:, None]
        dpre = (v[None, None] * gsc) * (1.0 - act * act)      # [T, C, h, B]
        d_dyn = dpre.sum(1)                                   # [T, h, B]
        dse += d_dyn
        dqs = dpre.sum(0)                                     # [C, h, B]
        h1 = sv["h1"]                                         # [32, T, B]
        dwpt += torch.einsum("thb,ktb->hk", d_dyn, h1)
        dh1 = torch.einsum("hk,thb->ktb", wpt, d_dyn) * (h1 > 0)
        dw8t += torch.einsum("ktb,mtb->km", dh1, sv["x"])
        db8 += dh1.sum((1, 2))[:, None]
        d_prev = torch.zeros_like(ctx)
        for c in range(C):
            qin = sv["qins"][c]
            dwqt += dqs[c] @ qin.T
            dbq += dqs[c].sum(1, keepdim=True)
            dqin = wqt.T @ dqs[c]
            d_hm = dqin[0:h]
            dctx += dqin[h:2 * h]
            d_prev += dqin[2 * h:3 * h]
            feats, e1 = sv["hm"][c]
            dw2t += d_hm @ e1.T
            db2 += d_hm.sum(1, keepdim=True)
            de1 = (w2t.T @ d_hm) * (e1 > 0)
            dw1t += de1 @ feats.T
            db1 += de1.sum(1, keepdim=True)
        det += d_prev @ sv["oh_prev"].T
    return dse, dctx, tuple(g)


def replay_logp_bwd_ref(dlp, flags, hms, masks, acts, se, ctx, statp, statm,
                        params, cfg: TAPConfig, temperature: float = 1.0):
    """Plain backward given dlp f32[B]. Returns (d_se f32[T, h, B],
    d_ctx f32[h, B], the 11 head-operand gradients)."""
    return _bwd_chunk(0, cfg.num_blocks, dlp, flags, hms, masks, acts,
                      _prev_rows(acts), se, ctx, statp, statm, params, cfg,
                      temperature)


def replay_logp_bwd_steps_ref(dlp, flags, hms, masks, acts, prev, se, ctx,
                              statp, statm, params, cfg: TAPConfig,
                              temperature: float = 1.0):
    """Plain step-grid backward: operands as `replay_logp_bwd_ref` plus
    prev i32[S, B]; per-chunk partials of every output, summed in chunk
    order."""
    total = None
    for k0, k1 in _chunk_bounds(cfg, acts.shape[1]):
        dse, dctx, g = _bwd_chunk(k0, k1, dlp, flags, hms, masks, acts, prev,
                                  se, ctx, statp, statm, params, cfg,
                                  temperature)
        if total is None:
            total = [dse, dctx, *g]
        else:
            for acc, x in zip(total, (dse, dctx, *g)):
                acc += x
    return total[0], total[1], tuple(total[2:])


# ------------------------------------------------------------------ #
# kernels

@functools.cache
def _lib():
    fn = _build.load("replay").tapnet_replay_logp
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_operands(flags, hms, masks, acts, se, ctx, statp, statm, params,
                    cfg, steps=False, prev=None):
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    A, T, S = cfg.num_actions, N * cfg.num_rot, cfg.num_blocks
    _, h, B = se.shape
    _check_cfg(cfg, h, steps)
    dev, i32, f32 = se.device, torch.int32, torch.float32
    operands = [
        ("flags", flags, (S, N, B), i32), ("hms", hms, (S, C * W, D, B), i32),
        ("masks", masks, (S, A, B), i32), ("acts", acts, (S, B), i32),
        ("se", se, (T, h, B), f32), ("ctx", ctx, (h, B), f32),
        ("statp", statp, (4, T, B), f32), ("statm", statm, (4, B), f32)]
    if steps:
        operands.append(("prev", prev, (S, B), i32))
    for name, t, shape, dt in operands:
        _check(t, name, shape, dt, dev)
    for i, (p, s) in enumerate(zip(params, head_shapes(cfg, h))):
        _check(p, f"params[{i}]", s, f32, dev)
    return B, h, dev


def _scratch(cfg, B, h, dev, chunks=1):
    """[chunks, C*h, tiles*TB] f32 for the kernels' per-instance queries
    (and their gradients)."""
    tiles = (B + TB - 1) // TB
    return torch.empty((chunks, cfg.num_containers * h, tiles * TB),
                       dtype=torch.float32, device=dev)


def _launch(bwd, ptrs, cfg, B, h, temperature, dev, chunks=0):
    """`chunks` = 0: the monolithic schedule; else the step-grid one."""
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        arr = _build.ptr_array(ptrs)
        ints = _ints(cfg, B, h) + [int(chunks > 0), max(chunks, 1)]
        err = fn(int(bwd), ctypes.cast(arr, ctypes.c_void_p),
                 ctypes.cast(_build.int_array(ints), ctypes.c_void_p),
                 ctypes.c_float(1.0 / _scale(cfg)),
                 ctypes.c_float(temperature),
                 ctypes.c_float(1.0 / temperature), ctypes.c_void_p(stream))
    return err


def _fwd_kernel(ops, prev, cfg, temperature, chunks):
    flags, hms, masks, acts, se, ctx, statp, statm, params = ops
    B, h, dev = _check_operands(*ops, cfg, chunks > 0, prev)
    f32 = torch.float32
    logp = torch.empty(B, dtype=f32, device=dev)
    none = torch.empty(0, device=dev)
    part = (torch.empty((chunks, B), dtype=f32, device=dev) if chunks > 1
            else none)
    ptrs = ((flags, hms, masks, acts, se, ctx, statp, statm, none)
            + tuple(params)
            + (logp, part, none, none, none,
               _scratch(cfg, B, h, dev, max(chunks, 1)), none,
               none if prev is None else prev, none, none))
    return logp, _launch(False, ptrs, cfg, B, h, temperature, dev, chunks)


def _bwd_kernel(dlp, ops, prev, cfg, temperature, chunks):
    flags, hms, masks, acts, se, ctx, statp, statm, params = ops
    B, h, dev = _check_operands(*ops, cfg, chunks > 0, prev)
    _check(dlp, "dlp", (B,), torch.float32, dev)
    f32 = torch.float32
    shapes = head_shapes(cfg, h)
    P = sum(a * b for a, b in shapes)
    tiles = (B + TB - 1) // TB
    nc = max(chunks, 1)
    dse = torch.empty_like(se)
    dctx = torch.empty_like(ctx)
    part = torch.empty((tiles * nc, P), dtype=f32, device=dev)
    flat = torch.empty(P, dtype=f32, device=dev)
    none = torch.empty(0, device=dev)
    dse_part = (torch.empty((nc,) + se.shape, dtype=f32, device=dev)
                if nc > 1 else none)
    dctx_part = (torch.empty((nc,) + ctx.shape, dtype=f32, device=dev)
                 if nc > 1 else none)
    ptrs = ((flags, hms, masks, acts, se, ctx, statp, statm, dlp)
            + tuple(params)
            + (none, dse, dctx, part, flat, _scratch(cfg, B, h, dev, nc),
               _scratch(cfg, B, h, dev, nc),
               none if prev is None else prev, dse_part, dctx_part))
    err = _launch(True, ptrs, cfg, B, h, temperature, dev, chunks)
    grads, off = [], 0
    for a, b in shapes:
        grads.append(flat[off:off + a * b].view(a, b))
        off += a * b
    return (dse, dctx, tuple(grads)), err


def replay_logp_fwd(flags, hms, masks, acts, se, ctx, statp, statm, params,
                    cfg: TAPConfig, temperature: float = 1.0):
    """Forward, monolithic schedule (K5f); operands and result as in
    `replay_logp_fwd_ref`."""
    ops = (flags, hms, masks, acts, se, ctx, statp, statm, params)
    if not se.is_cuda:
        return replay_logp_fwd_ref(*ops, cfg, temperature)
    logp, err = _fwd_kernel(ops, None, cfg, temperature, 0)
    replay_logp_fwd.launches += 1
    _build.check(err, "replay_logp_fwd")
    return logp


replay_logp_fwd.launches = 0


def replay_logp_bwd(dlp, flags, hms, masks, acts, se, ctx, statp, statm,
                    params, cfg: TAPConfig, temperature: float = 1.0):
    """Backward, monolithic schedule (K5b); operands and results as in
    `replay_logp_bwd_ref`. The weight gradients are summed over instance
    tiles in a fixed order: two launches on the same inputs give
    bit-identical outputs."""
    ops = (flags, hms, masks, acts, se, ctx, statp, statm, params)
    if not se.is_cuda:
        return replay_logp_bwd_ref(dlp, *ops, cfg, temperature)
    out, err = _bwd_kernel(dlp, ops, None, cfg, temperature, 0)
    replay_logp_bwd.launches += 1
    _build.check(err, "replay_logp_bwd")
    return out


replay_logp_bwd.launches = 0


def replay_logp_fwd_steps(flags, hms, masks, acts, prev, se, ctx, statp,
                          statm, params, cfg: TAPConfig,
                          temperature: float = 1.0):
    """Forward, step-grid schedule (K5f-steps); operands and result as in
    `replay_logp_fwd_steps_ref`. One launch of the (tile, chunk) grid plus,
    for more than one chunk, the ordered sum of the chunks' partials."""
    ops = (flags, hms, masks, acts, se, ctx, statp, statm, params)
    if not se.is_cuda:
        return replay_logp_fwd_steps_ref(flags, hms, masks, acts, prev,
                                         *ops[4:], cfg, temperature)
    logp, err = _fwd_kernel(ops, prev, cfg, temperature,
                            step_chunks(cfg, acts.shape[1]))
    replay_logp_fwd_steps.launches += 1
    _build.check(err, "replay_logp_fwd_steps")
    return logp


replay_logp_fwd_steps.launches = 0


def replay_logp_bwd_steps(dlp, flags, hms, masks, acts, prev, se, ctx, statp,
                          statm, params, cfg: TAPConfig,
                          temperature: float = 1.0):
    """Backward, step-grid schedule (K5b-steps); operands and results as in
    `replay_logp_bwd_steps_ref`. Every sum over steps and over tiles is
    taken in a fixed order from per-(tile, chunk) partials: two launches on
    the same inputs give bit-identical outputs."""
    ops = (flags, hms, masks, acts, se, ctx, statp, statm, params)
    if not se.is_cuda:
        return replay_logp_bwd_steps_ref(dlp, flags, hms, masks, acts, prev,
                                         *ops[4:], cfg, temperature)
    out, err = _bwd_kernel(dlp, ops, prev, cfg, temperature,
                           step_chunks(cfg, acts.shape[1]))
    replay_logp_bwd_steps.launches += 1
    _build.check(err, "replay_logp_bwd_steps")
    return out


replay_logp_bwd_steps.launches = 0


def scratch_bytes(cfg: TAPConfig, B: int, h: int) -> dict:
    """Device scratch of one step-grid backward call, in bytes: the d_se
    and d_ctx partials (none for one chunk), the weight-gradient partial
    rows and the two query scratches."""
    chunks = step_chunks(cfg, B)
    tiles = (B + TB - 1) // TB
    T = cfg.num_blocks * cfg.num_rot
    P = sum(a * b for a, b in head_shapes(cfg, h))
    multi = chunks > 1
    return {"chunks": chunks,
            "d_se_partials": 4 * chunks * T * h * B * multi,
            "d_ctx_partials": 4 * chunks * h * B * multi,
            "weight_partials": 4 * tiles * chunks * P,
            "query_scratch": 2 * 4 * chunks * cfg.num_containers * h
            * tiles * TB}


class ReplayLogp(torch.autograd.Function):
    """logp [B] = sum_t log pi(a_t | s_t), differentiable in se, ctx and the
    11 head operands; the record is data (gradient None). The schedule
    follows the config (`_steps_grid`).

    apply(cfg, temperature, logp0, flags, hms, masks, acts, statp, statm,
          se, ctx, *params)

    With `logp0` (a tensor [B]) the forward returns it and launches
    nothing; the gradients are the same either way, since the backward
    re-runs the head itself."""

    @staticmethod
    def forward(ctx_, cfg, temperature, logp0, flags, hms, masks, acts,
                statp, statm, se, ctx, *params):
        ctx_.cfg, ctx_.temperature = cfg, temperature
        ctx_.save_for_backward(flags, hms, masks, acts, statp, statm, se,
                               ctx, *params)
        if logp0 is not None:
            return logp0.detach().clone()
        if _steps_grid(cfg):
            return replay_logp_fwd_steps(flags, hms, masks, acts,
                                         _prev_rows(acts), se, ctx, statp,
                                         statm, params, cfg, temperature)
        return replay_logp_fwd(flags, hms, masks, acts, se, ctx, statp,
                               statm, params, cfg, temperature)

    @staticmethod
    def backward(ctx_, dlp):
        flags, hms, masks, acts, statp, statm, se, ctx, *params = \
            ctx_.saved_tensors
        dlp = dlp.contiguous().float()
        if _steps_grid(ctx_.cfg):
            dse, dctx, dparams = replay_logp_bwd_steps(
                dlp, flags, hms, masks, acts, _prev_rows(acts), se, ctx,
                statp, statm, tuple(params), ctx_.cfg, ctx_.temperature)
        else:
            dse, dctx, dparams = replay_logp_bwd(
                dlp, flags, hms, masks, acts, se, ctx, statp, statm,
                tuple(params), ctx_.cfg, ctx_.temperature)
        return (None, None, None, None, None, None, None, None, None,
                dse, dctx, *dparams)
