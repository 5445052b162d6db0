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
  nothing; the backward is the same;
- `live_columns`, `replay_logp_fwd_live` / `replay_logp_bwd_live`: the
  kernels' rule in plain PyTorch. The kernels do the token work only for
  the live columns of a step, (instance, token) pairs whose instance has an
  action and whose mask allows the token; every other token scores -1e9 and
  adds exact zeros. The live replay computes the same value and gradients
  from those columns alone.

Coverage: every unbounded or capped config with N <= 62, at most 4
containers and a hidden width that is a multiple of 32 up to 128 whose
shared-memory plan fits a block (`eligible`). A rolling window enters the
replay only through the recorded flag bit 3 and the recorded mask: a token
outside the window is masked to -1e9, which is the windowed softmax
exactly, and is not a live column.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.models.features import _scale
from tapnet_torch.ops import _build
from tapnet_torch.ops.actor_step import head_shapes, transposed
from tapnet_torch.ops.policy_step import _check

NEG = -1e9
MAX_C = 4
TB, LD, NWARP = 32, 33, 16         # csrc/replay.cu
G = 4 * NWARP                      # columns per token group
MAX_H = 128                        # hidden: a multiple of 32, at most 128
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
    """Shared memory of one block, in bytes, as csrc/replay.cu::smem_bytes
    computes it (`layout` and `n_ints`; `steps`: the schedule, auto by
    `_steps_grid`)."""
    if steps is None:
        steps = _steps_grid(cfg)
    C, T = cfg.num_containers, cfg.num_blocks * cfg.num_rot
    WD = cfg.target_width * cfg.target_depth
    up4 = lambda x: (x + 3) & ~3
    floats = (up4(32 * h) + 256 + 32 + up4(h) + up4(h * LD) * (2 if bwd else 1)
              + up4(TB * T * C)
              + up4((WD + 2 + h + 3 * h + 8 + (h if bwd else 0)) * LD)
              + max(40 * G + ((G * (h + 4) + 32 * G) if bwd else 0), 64 * h,
                    (cfg.num_blocks + T) * TB))
    ints = (8 if steps else 4) * TB + 5 * TB + 2 + TB * T
    return 4 * (floats + ints)


def eligible(cfg: TAPConfig, h: int = 128) -> bool:
    """Configs the replay kernels cover: N <= 62 (N > 31 and rolling
    windows on the step-grid schedule), C <= 4, hidden a multiple of 32 up
    to 128, and a backward block that fits. A finite height cap is covered:
    the mask is the recorded one."""
    return (cfg.num_blocks <= MAX_N and cfg.num_containers <= MAX_C
            and h % 32 == 0 and 0 < h <= MAX_H
            and smem_bytes(cfg, h, True) <= SMEM_LIMIT)


def _check_cfg(cfg: TAPConfig, h: int, steps: bool):
    if not steps and cfg.num_blocks > 31:
        raise NotImplementedError(
            "replay_logp: the monolithic schedule holds N <= 31; N > 31 "
            "runs the step-grid schedule (replay_logp_fwd_steps)")
    smem = smem_bytes(cfg, h, True, steps)
    if not eligible(cfg, h):
        raise NotImplementedError(
            f"replay_logp kernels cover N <= {MAX_N} and C <= {MAX_C} at a "
            f"hidden width that is a multiple of 32 up to {MAX_H}, with at "
            f"most {SMEM_LIMIT} B of shared memory per block, not {cfg} at "
            f"hidden {h} ({smem} B); pass kernel=False")


def step_chunks(cfg: TAPConfig, B: int) -> int:
    """Step chunks of the step-grid schedule at batch B: the fewest that
    give every SM a block (tiles x chunks >= 132), at most one per step.
    A backward block holds up to ~219 KB of shared memory (one per SM), so
    more chunks than that buy no residency, and each costs a d_se partial
    of B*T*h floats: 2 chunks and 420 MB at 2d-rolling, batch 4096,
    hidden 128."""
    tiles = (B + TB - 1) // TB
    S = cfg.num_blocks
    chunks = max(1, min(S, -(-SM_COUNT // tiles)))
    length = -(-S // chunks)
    return -(-S // length)


# ------------------------------------------------------------------ #
# plain versions

def _head_queries(cfg, k, flags_k, hm_k, prev, ctx, statm, params):
    """The step-k part of the head that does not depend on the token: the
    bit planes of the flags, the step fraction and per container the
    encoder and the query, batch-last over the B columns given. Returns
    (bits (packed, acc0, accr, win) [N, B], tf, queries [C] of [h, B],
    saved activations)."""
    N, W, D = cfg.num_blocks, cfg.target_width, cfg.target_depth
    R, C, A = cfg.num_rot, cfg.num_containers, cfg.num_actions
    T = N * R
    B = flags_k.shape[1]
    dev = flags_k.device
    f32 = torch.float32
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params
    bits = tuple((flags_k >> i) & 1 for i in range(4))
    packed, acc0, accr, win = bits
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
    return bits, tf, qs, dict(hm=hm_saved, qins=qins, oh_prev=oh_prev)


def _head_fwd(cfg, k, flags_k, hm_k, mask_k, prev, se, ctx, statp, statm,
              params, temperature):
    """Head of decode step k from the record, batch-last. Returns
    (masked [A, B], mask_f [A, B], saved activations)."""
    R, A = cfg.num_rot, cfg.num_actions
    T = cfg.num_blocks * R
    B = flags_k.shape[1]
    dev = flags_k.device
    f32 = torch.float32
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params
    (packed, acc0, accr, win), tf, qs, saved = _head_queries(
        cfg, k, flags_k, hm_k, prev, ctx, statm, params)
    ones = torch.ones(1, B, dtype=f32, device=dev)
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
    saved.update(x=x, h1=h1, act=act)
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
        _query_bwd(dqs, sv, params, g, dctx)
    return dse, dctx, tuple(g)


def _query_bwd(dqs, sv, params, g, dctx):
    """The query and encoder backward of one step from the query gradients
    dqs [C] of [h, B]: adds the weight gradients into g (the 11 of
    `head_operands`) and d_ctx into dctx [h, B]."""
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params
    (dw8t, db8, dwpt, dw1t, db1, dw2t, db2, det, dwqt, dbq, dv) = g
    h = wqt.shape[0]
    d_prev = torch.zeros_like(dqs[0])
    for c, dq in enumerate(dqs):
        qin = sv["qins"][c]
        dwqt += dq @ qin.T
        dbq += dq.sum(1, keepdim=True)
        dqin = wqt.T @ dq
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


def live_columns(mask_k, act_k, cfg: TAPConfig):
    """The live columns of one decode step, the rule the kernels apply:
    pairs (instance b, token t) whose instance has an action (act >= 0) and
    whose recorded mask allows t in some container. Returns (b [n], t [n])
    ordered by instance, then token, so the columns of batch tile b // TB
    are one contiguous run in the kernels' order. Every other token scores
    -1e9 and adds exact zeros to the value and to every gradient."""
    T, C = cfg.num_blocks * cfg.num_rot, cfg.num_containers
    live = ((mask_k.reshape(T, C, -1) == 1).any(1)
            & (act_k >= 0)[None])                             # [T, B]
    b, t = live.T.nonzero(as_tuple=True)
    return b, t


def _live_step(cfg, k, flags_k, hm_k, mask_k, act_k, prev, se, ctx, statp,
               statm, params, temperature):
    """Decode step k over its live columns only: the queries of the
    instances that act, then the token MLP and the scores of the live
    columns. Returns None when no instance acts, else a dict of the
    columns, their masked scores [n, C] and what the backward needs."""
    R, C = cfg.num_rot, cfg.num_containers
    T = cfg.num_blocks * R
    f32 = torch.float32
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params
    inst = (act_k >= 0).nonzero()[:, 0]
    if inst.numel() == 0:
        return None
    b, t = live_columns(mask_k, act_k, cfg)
    (packed, acc0, accr, win), tf, qs, sv = _head_queries(
        cfg, k, flags_k[:, inst], hm_k[..., inst], prev[inst], ctx[:, inst],
        statm[:, inst], params)
    col = torch.searchsorted(inst, b)          # the column's instance row
    i, r = t // R, t % R
    n = b.numel()
    x = torch.stack([packed[i, col].to(f32),
                     torch.where(r == 0, acc0[i, col], accr[i, col]).to(f32),
                     win[i, col].to(f32), tf.expand(n),
                     statp[0, t, b], statp[1, t, b], statp[2, t, b],
                     statp[3, t, b]], 0)                      # [8, n]
    h1 = torch.relu(w8t @ x + b8)                             # [32, n]
    sd = se[t, :, b].T + wpt @ h1                             # [h, n]
    act = torch.stack([torch.tanh(sd + q[:, col]) for q in qs], 0)
    scores = (act * v[None]).sum(1).T                         # [n, C]
    mk = mask_k.reshape(T, C, -1)[t, :, b]                    # [n, C]
    masked = torch.where(mk == 1, scores / temperature,
                         torch.tensor(NEG, dtype=f32, device=se.device))
    a_col = t[:, None] * C + torch.arange(C, device=se.device)[None]
    return dict(inst=inst, b=b, t=t, col=col, x=x, h1=h1, act=act,
                masked=masked, mask_f=mk.to(f32), a_col=a_col, sv=sv)


def _live_logp(st, act_k, A):
    """Per acting instance: lp [n_inst] and the softmax p [n, C] over its
    live columns (its other actions have p = 0 exactly). An instance whose
    every action is masked gets the full version's uniform -log(A)."""
    inst, col, masked = st["inst"], st["col"], st["masked"]
    C = masked.shape[1]
    ni = inst.numel()
    dev = masked.device
    seg = col[:, None].expand(-1, C).reshape(-1)
    m = masked.reshape(-1)
    neg = torch.full((ni,), NEG, dtype=torch.float32, device=dev)
    mx = neg.scatter_reduce(0, seg, m, "amax", include_self=False)
    e = torch.exp(m - mx[seg])
    ssum = torch.zeros(ni, dtype=torch.float32, device=dev).index_add(
        0, seg, e)
    count = torch.zeros(ni, device=dev).index_add(0, seg, torch.ones_like(m))
    ssum = torch.where(count > 0, ssum, torch.full_like(ssum, float(A)))
    hit = (st["a_col"] == act_k[st["b"]][:, None]).reshape(-1)
    la = neg.index_put((seg[hit],), m[hit])
    lp = (la - mx) - torch.log(ssum)
    return lp, (e / ssum[seg]).reshape(-1, C), hit.reshape(-1, C)


def replay_logp_fwd_live(flags, hms, masks, acts, se, ctx, statp, statm,
                         params, cfg: TAPConfig, temperature: float = 1.0):
    """Plain forward over the live columns only (`live_columns`); operands
    and result as in `replay_logp_fwd_ref`, equal to it up to the grouping
    of the sums."""
    prev = _prev_rows(acts)
    total = torch.zeros(acts.shape[1], dtype=torch.float32,
                        device=acts.device)
    for k in range(cfg.num_blocks):
        st = _live_step(cfg, k, flags[k], hms[k], masks[k], acts[k], prev[k],
                        se, ctx, statp, statm, params, temperature)
        if st is not None:
            lp, _, _ = _live_logp(st, acts[k], cfg.num_actions)
            total = total.index_add(0, st["inst"], lp)
    return total


def replay_logp_bwd_live(dlp, flags, hms, masks, acts, se, ctx, statp, statm,
                         params, cfg: TAPConfig, temperature: float = 1.0):
    """Plain backward over the live columns only; operands and results as
    in `replay_logp_bwd_ref`: per step the token MLP's chain runs on the
    live columns, the query gradients are per-instance sums over them, and
    the query and encoder backward runs on the instances that act."""
    T, h = cfg.num_blocks * cfg.num_rot, se.shape[1]
    w8t, b8, wpt, w1t, b1, w2t, b2, et, wqt, bq, v = params
    g = [torch.zeros_like(p) for p in params]
    (dw8t, db8, dwpt, dw1t, db1, dw2t, db2, det, dwqt, dbq, dv) = g
    dse = torch.zeros_like(se)
    dctx = torch.zeros_like(ctx)
    prev = _prev_rows(acts)
    for k in range(cfg.num_blocks):
        st = _live_step(cfg, k, flags[k], hms[k], masks[k], acts[k], prev[k],
                        se, ctx, statp, statm, params, temperature)
        if st is None:
            continue
        _, p, onehot = _live_logp(st, acts[k], cfg.num_actions)
        gsc = ((dlp[st["b"]][:, None] * (onehot.float() - p))
               * st["mask_f"]) * (1.0 / temperature)          # [n, C]
        act, h1, x = st["act"], st["h1"], st["x"]             # [C, h, n]
        gc = gsc.T[:, None, :]                                # [C, 1, n]
        # gv cancels (the g of an instance sum to 0 over its actions): it is
        # summed in the full [T, C, h, B] layout, as the full version sums
        # it, the dead entries exact zeros there as well
        full = torch.zeros((T,) + act.shape[:2] + (dlp.shape[0],),
                           dtype=act.dtype, device=act.device)
        full.permute(0, 3, 1, 2)[st["t"], st["b"]] = (
            (act * gc).permute(2, 0, 1))
        dv += full.sum((0, 1, 3))[:, None]
        dpre = (v[None] * gc) * (1.0 - act * act)
        d_dyn = dpre.sum(0)                                   # [h, n]
        dse.permute(0, 2, 1).index_put_((st["t"], st["b"]), d_dyn.T,
                                        accumulate=True)
        ni = st["inst"].numel()
        dqs = [torch.zeros(h, ni, dtype=se.dtype, device=se.device)
               .index_add_(1, st["col"], dpre[c]) for c in range(act.shape[0])]
        dwpt += d_dyn @ h1.T
        dh1 = (wpt.T @ d_dyn) * (h1 > 0)
        dw8t += dh1 @ x.T
        db8 += dh1.sum(1, keepdim=True)
        dctx_i = torch.zeros(h, ni, dtype=se.dtype, device=se.device)
        _query_bwd(dqs, st["sv"], params, g, dctx_i)
        dctx[:, st["inst"]] += dctx_i
    return dse, dctx, tuple(g)


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


def _se_rows(se):
    """se [T, h, B] as [B, T, h]: a live column's keys are one contiguous
    row, gathered coalesced by the kernels."""
    return se.permute(2, 0, 1).contiguous()


def _fwd_kernel(ops, prev, cfg, temperature, chunks):
    flags, hms, masks, acts, se, ctx, statp, statm, params = ops
    B, h, dev = _check_operands(*ops, cfg, chunks > 0, prev)
    f32 = torch.float32
    logp = torch.empty(B, dtype=f32, device=dev)
    none = torch.empty(0, device=dev)
    part = (torch.empty((chunks, B), dtype=f32, device=dev) if chunks > 1
            else none)
    ptrs = ((flags, hms, masks, acts, _se_rows(se), ctx, statp, statm, none)
            + tuple(params)
            + (logp, none, none, none, none,
               none if prev is None else prev, part, none, none)
            + transposed(params))
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
    T = se.shape[0]
    dse = torch.empty_like(se)
    dctx = torch.empty_like(ctx)
    part = torch.empty((tiles * nc, P), dtype=f32, device=dev)
    flat = torch.empty(P, dtype=f32, device=dev)
    none = torch.empty(0, device=dev)
    dse_part = torch.empty((nc, B, T, h), dtype=f32, device=dev)
    dctx_part = (torch.empty((nc,) + ctx.shape, dtype=f32, device=dev)
                 if nc > 1 else none)
    ptrs = ((flags, hms, masks, acts, _se_rows(se), ctx, statp, statm, dlp)
            + tuple(params)
            + (none, dse, dctx, part, flat,
               none if prev is None else prev, none, dse_part, dctx_part)
            + transposed(params))
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
    """Device scratch of one step-grid backward call, in bytes: the [B, T,
    h] copy of se, the d_se partials (one per chunk), the d_ctx partials
    (none for one chunk) and the weight-gradient partial rows."""
    chunks = step_chunks(cfg, B)
    tiles = (B + TB - 1) // TB
    T = cfg.num_blocks * cfg.num_rot
    P = sum(a * b for a, b in head_shapes(cfg, h))
    return {"chunks": chunks,
            "se_rows": 4 * B * T * h,
            "d_se_partials": 4 * chunks * T * h * B,
            "d_ctx_partials": 4 * chunks * h * B * (chunks > 1),
            "weight_partials": 4 * tiles * chunks * P}


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
