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
  its per-tile weight-gradient partials) and count their launches (the
  helper kernels' launches, counted by csrc/replay.cu where it launches
  them, go to `grad_outer_bf16.launches`, `grad_outer_tf32.launches` and
  `reduce_tiles.launches`);
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

Compute dtype (the JAX kernels' `dtype_name`): se, ctx, statp, statm and
the head weights come in float32 or bfloat16 (v float32) and pick the
kernels' instantiation. In bfloat16 the forward rounds where
`actor_step`'s does (`rounder`); the backward works in float32 from that
rounded forward and the float32 values of the bfloat16 weights, as
`_bwd_step` does, and its gradients are float32 (`ReplayLogp` casts each
to its operand's dtype, as the JAX `_bwd_impl` does).

Coverage: every unbounded or capped config with N <= 62, at most 4
containers and a hidden width up to 512 whose shared-memory plan fits a
block (`eligible`). The kernels take the multiples of 32 up to 256 and of
64 above (`actor_step.kernel_width`; above 256 the WX form of the head,
csrc/geo.cuh); `ReplayLogp` runs any other width on operands padded with
zeros to the next of them (`actor_step.pad_head`) and slices the
gradients back, which changes no value. A rolling window enters the
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
from tapnet_torch.ops.actor_step import (DTYPES, F32, geometry, head_shapes,
                                         kernel_width, pad_head, pad_hidden,
                                         rounder, transposed, unpad_head)
from tapnet_torch.ops.policy_step import _check

NEG = -1e9
MAX_C = 4
TB = 32                            # csrc/replay.cu: instances per block
MAX_H = 512                        # hidden: at most 512 (`kernel_width`)
SMEM_LIMIT = 232448                # bytes of shared memory a block may hold


def _ints(cfg: TAPConfig, B: int, h: int):
    return [B, cfg.num_blocks, cfg.target_width, cfg.target_depth,
            cfg.num_rot, cfg.num_containers, h]


MAX_N = 62                         # step-grid: 64-bit flag words
SM_COUNT = 132                     # H100 SXM; `step_chunks` fills them
RING_K = 32                        # csrc/ring_bf16.cuh: columns of a slab
RING_S = 3                         # ... and stages of the ring


def _steps_grid(cfg: TAPConfig) -> bool:
    """The step-grid schedule serves rolling windows and N > 31 (the
    monolithic kernel packs a block set into one 32-bit word)."""
    return cfg.window > 0 or cfg.num_blocks > 31


def smem_bytes(cfg: TAPConfig, h: int, bwd: bool, steps=None,
               dtype=F32) -> int:
    """Shared memory of one block, in bytes, as csrc/replay.cu::smem_bytes
    computes it (`layout` and `n_ints`; `steps`: the schedule, auto by
    `_steps_grid`). Both dtypes hold their values as float32 in shared
    memory, the head's arrays (q, dq, the encoder view, the token view) for
    one pass of `geometry(h)["tp"]` instances, but for the bfloat16
    instantiations' (`dtype`) weights: their tensor-core plan holds Wp as
    bfloat16 rows of 40 in place of the float Wp^T, h1 rows padded to G +
    4, a dyn array in the forward too, and the encoder/query weight slices
    as two bfloat16 slabs of 72 h floats in the token view; above 128 the
    weight ring's RING_S stages of h RING_K bfloat16 there, its mbarriers
    and counts behind the token view, and d_prev and dq in the forward
    too (with them the room of the products' bfloat16 B operands). Above
    256 (WX) q, dq and the encoder view are in the block's scratch in
    device memory (`wx_scratch`), the bfloat16 copies of the ring
    products' B operands in shared memory of their own (`_wx_xs`), G = 16
    and a ring stage holds a row half (h / 2 rows)."""
    if steps is None:
        steps = _steps_grid(cfg)
    tc = dtype == torch.bfloat16
    geo = geometry(h)
    G, LP = geo["g"], geo["lp"]
    wx = geo["nh"] == 2
    C, T = cfg.num_containers, cfg.num_blocks * cfg.num_rot
    WD = cfg.target_width * cfg.target_depth
    up4 = lambda x: (x + 3) & ~3
    tok = (8 * G + 32 * (G + 4 if tc else G)
           + (G * (h + 4) if bwd or tc else 0) + (32 * G if bwd else 0))
    ring = tc and h > 128
    if tc:
        slabs = RING_S * (h // geo["nh"]) * RING_K // 2 if ring else 72 * h
    else:
        slabs = geo["ks"] * h
    head = (up4(h * LP) * (2 if bwd or ring else 1)
            + up4((WD + 2 + h + 3 * h + 8 + (h if bwd or ring else 0)) * LP))
    floats = (up4(20 * h if tc else 32 * h) + 256 + 32 + up4(h)
              + (0 if wx else head) + up4(TB * T * C)
              + (_wx_xs(h) if wx and ring else 0)
              + max(tok, slabs, (cfg.num_blocks + T) * TB)
              + (up4(3 * RING_S) if ring else 0))
    ints = (8 if steps else 4) * TB + 5 * TB + 2 + TB * T
    return 4 * (floats + ints)


def _wx_xs(h: int) -> int:
    """Floats of the bfloat16 copies of the ring products' B operands above
    hidden 256 (csrc/replay.cu `wx_xs`): A/B's qin [FQ16][16] and e1
    [h][16], or E's four [h][16], bfloat16, and 16 bytes of alignment."""
    ab, e = 16 * ((3 * h + 8 + 15) // 16 * 16 + h), 64 * h
    return max(ab, e) // 2 + 4


def wx_scratch(cfg: TAPConfig, h: int) -> int:
    """Floats of one block's scratch in device memory above hidden 256
    (csrc/replay.cu `wx_scratch`): q and dq [h][17], then the encoder view
    feats [W*D+2][17], e1 [h][17], qin [3h+8][17] and d_prev [h][17]; 0 up
    to 256."""
    if h <= 256:
        return 0
    up4 = lambda x: (x + 3) & ~3
    WD2 = cfg.target_width * cfg.target_depth + 2
    return 2 * up4(h * 17) + up4((WD2 + 5 * h + 8) * 17)


def eligible(cfg: TAPConfig, h: int = 128, dtype=F32) -> bool:
    """Configs the replay kernels cover: float32 or bfloat16, N <= 62
    (N > 31 and rolling windows on the step-grid schedule), C <= 4, hidden
    1 .. 512 (run at `kernel_width(h)` on padded operands; above 128 the
    head runs in two passes of 16 instances, above 256 over the weights'
    row halves, `actor_step.geometry`), and a backward block of the
    dtype's plan that fits. A finite height cap is covered: the mask is
    the recorded one."""
    return (dtype in DTYPES and cfg.num_blocks <= MAX_N
            and cfg.num_containers <= MAX_C and 0 < h <= MAX_H
            and smem_bytes(cfg, kernel_width(h), True, dtype=dtype)
            <= SMEM_LIMIT)


def _check_cfg(cfg: TAPConfig, h: int, steps: bool, dtype=F32):
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"replay_logp computes in float32 or bfloat16, not {dtype}")
    if not steps and cfg.num_blocks > 31:
        raise NotImplementedError(
            "replay_logp: the monolithic schedule holds N <= 31; N > 31 "
            "runs the step-grid schedule (replay_logp_fwd_steps)")
    smem = smem_bytes(cfg, kernel_width(h), True, steps, dtype)
    if h != kernel_width(h) or not eligible(cfg, h, dtype):
        raise NotImplementedError(
            f"replay_logp kernels cover N <= {MAX_N} and C <= {MAX_C} at a "
            f"hidden width that is a multiple of 32 up to 256 or of 64 up to "
            f"{MAX_H} (ReplayLogp pads the others), with at most "
            f"{SMEM_LIMIT} B of shared memory per block, not {cfg} at "
            f"hidden {h} ({smem} B); pass kernel=False")


def _steps_per_row(cfg: TAPConfig, chunks: int) -> int:
    """Steps of one partial row: all N (monolithic, chunks = 0) or the
    kernel's steps per chunk."""
    S = cfg.num_blocks
    return S if chunks == 0 else -(-S // chunks)


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
    rd = rounder(ctx.dtype)
    w1t, b1, w2t, b2, et, wqt, bq = (p.float() for p in params[3:10])
    bits = tuple((flags_k >> i) & 1 for i in range(4))
    packed, acc0, accr, win = bits
    tf = torch.full((), k, dtype=f32, device=dev) / cfg.num_blocks
    pk = packed.sum(0, keepdim=True).to(f32)
    a0 = acc0.sum(0, keepdim=True).to(f32)
    ar = accr.sum(0, keepdim=True).to(f32)
    wn = win.sum(0, keepdim=True).to(f32)
    acc_mean = (a0 + ar) / T if R == 2 else a0 / N
    ones = torch.ones(1, B, dtype=f32, device=dev)
    dsum = torch.cat([rd(pk / N), rd(acc_mean), rd(wn / N), rd(ones * tf),
                      statm.float()], 0)

    inv_s = torch.full((), 1.0 / _scale(cfg), dtype=f32, device=dev)
    idx = (prev + 1).clamp(0, A).long()
    oh_prev = (torch.arange(A + 1, device=dev)[:, None] == idx[None]).to(f32)
    prev_emb = et[:, idx]                                     # [h, B]
    hm_saved, qins, qs, pres = [], [], [], []
    for c in range(C):
        xc = rd(hm_k[c * W:(c + 1) * W].reshape(W * D, B).to(f32) * inv_s)
        feats = torch.cat([xc, xc.amax(0, keepdim=True),
                           rd(xc.sum(0, keepdim=True) / (W * D))], 0)
        pre1 = rd(rd(w1t @ feats) + b1)
        e1 = torch.relu(pre1)
        enc = rd(rd(w2t @ e1) + b2)
        qin = torch.cat([enc, ctx.float(), prev_emb, dsum], 0)
        qs.append(rd(rd(wqt @ qin) + bq))
        hm_saved.append((feats, e1))
        qins.append(qin)
        pres.append(pre1)
    return bits, tf, qs, dict(hm=hm_saved, qins=qins, oh_prev=oh_prev,
                              pre1=pres)


def _head_fwd(cfg, k, flags_k, hm_k, mask_k, prev, se, ctx, statp, statm,
              params, temperature):
    """Head of decode step k from the record, batch-last. Returns
    (masked [A, B], mask_f [A, B], saved activations)."""
    R, A = cfg.num_rot, cfg.num_actions
    T = cfg.num_blocks * R
    B = flags_k.shape[1]
    dev = flags_k.device
    f32 = torch.float32
    rd = rounder(se.dtype)
    w8t, b8, wpt = (p.float() for p in params[:3])
    v = params[10]
    (packed, acc0, accr, win), tf, qs, saved = _head_queries(
        cfg, k, flags_k, hm_k, prev, ctx, statm, params)
    ones = torch.ones(1, B, dtype=f32, device=dev)
    ac = torch.stack([acc0, accr][:R], 1).reshape(T, B).to(f32)
    statp = statp.float()
    x = torch.stack([packed.to(f32).repeat_interleave(R, 0), ac,
                     win.to(f32).repeat_interleave(R, 0),
                     rd(ones * tf).expand(T, B),
                     statp[0], statp[1], statp[2], statp[3]], 0)  # [8, T, B]
    pre8 = rd(rd(w8t @ x.reshape(8, T * B)) + b8).reshape(32, T, B)
    h1 = torch.relu(pre8)
    dyn = rd(wpt @ h1.reshape(32, T * B)).reshape(-1, T, B).permute(1, 0, 2)
    sd = rd(se.float() + dyn)                                 # [T, h, B]
    act = torch.stack([rd(torch.tanh(rd(sd + q[None]))) for q in qs],
                      1)                                      # [T,C,h,B]
    scores = rd((act * v[None, None]).sum(2)).reshape(A, B)
    mask_f = mask_k.to(f32)
    masked = torch.where(mask_k == 1, scores / temperature, NEG)
    saved.update(x=x, h1=h1, act=act, pre8=pre8)
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
               statm, params, cfg, temperature, pres=None):
    """(d_se, d_ctx, the 11 head-operand gradients) of decode steps
    [k0, k1); each step's ReLU pre-activations appended to the list
    `pres` if one is given (`_pre_record`)."""
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    T, h = N * R, se.shape[1]
    wpt, v = params[2].float(), params[10]
    g = _zeros_f32(params)
    (dw8t, db8, dwpt, dw1t, db1, dw2t, db2, det, dwqt, dbq, dv) = g
    dse, dctx = _zeros_f32((se, ctx))
    inv_temp = torch.full((), 1.0 / temperature, dtype=torch.float32,
                          device=se.device)
    for k in range(k0, k1):
        masked, mask_f, sv = _head_fwd(cfg, k, flags[k], hms[k], masks[k],
                                       prev[k], se, ctx, statp, statm,
                                       params, temperature)
        if pres is not None:
            pres.append(_pre_record(k, sv))
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


def _pre_record(k, sv):
    """Step k's ReLU gates as the plain version computes them: per
    container the encoder's input feats [W*D+2, B] and pre-activation W1
    feats + b1 [h, B] (`e1`), and the token MLP's input x [8, T, B] and
    pre-activation W8 x + b8 [32, T, B] (`h1`)."""
    return dict(k=k, feats=[f for f, _ in sv["hm"]], e1=sv["pre1"],
                x=sv["x"], h1=sv["pre8"])


def _zeros_f32(ts):
    """float32 zeros shaped like each tensor of `ts`: the gradients are
    accumulated in float32 whatever the operands' dtype."""
    return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for t in ts]


def _query_bwd(dqs, sv, params, g, dctx):
    """The query and encoder backward of one step from the query gradients
    dqs [C] of [h, B]: adds the weight gradients into g (the 11 of
    `head_operands`) and d_ctx into dctx [h, B]."""
    w2t, wqt = params[5].float(), params[8].float()
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
                        params, cfg: TAPConfig, temperature: float = 1.0,
                        pre: bool = False):
    """Plain backward given dlp f32[B]. Returns (d_se f32[T, h, B],
    d_ctx f32[h, B], the 11 head-operand gradients); with `pre`, also the
    list of every step's ReLU pre-activations and their inputs
    (`_pre_record`)."""
    pres = [] if pre else None
    out = _bwd_chunk(0, cfg.num_blocks, dlp, flags, hms, masks, acts,
                     _prev_rows(acts), se, ctx, statp, statm, params, cfg,
                     temperature, pres)
    return (*out, pres) if pre else out


def replay_logp_bwd_steps_ref(dlp, flags, hms, masks, acts, prev, se, ctx,
                              statp, statm, params, cfg: TAPConfig,
                              temperature: float = 1.0, pre: bool = False):
    """Plain step-grid backward: operands as `replay_logp_bwd_ref` plus
    prev i32[S, B]; per-chunk partials of every output, summed in chunk
    order (`pre`: as in `replay_logp_bwd_ref`)."""
    total = None
    pres = [] if pre else None
    for k0, k1 in _chunk_bounds(cfg, acts.shape[1]):
        dse, dctx, g = _bwd_chunk(k0, k1, dlp, flags, hms, masks, acts, prev,
                                  se, ctx, statp, statm, params, cfg,
                                  temperature, pres)
        if total is None:
            total = [dse, dctx, *g]
        else:
            for acc, x in zip(total, (dse, dctx, *g)):
                acc += x
    out = total[0], total[1], tuple(total[2:])
    return (*out, pres) if pre else out


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
    rd = rounder(se.dtype)
    w8t, b8, wpt = (p.float() for p in params[:3])
    v = params[10]
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
    sp = statp[:, t, b].float()                               # [4, n]
    x = torch.stack([packed[i, col].to(f32),
                     torch.where(r == 0, acc0[i, col], accr[i, col]).to(f32),
                     win[i, col].to(f32), rd(tf).expand(n),
                     sp[0], sp[1], sp[2], sp[3]], 0)          # [8, n]
    h1 = torch.relu(rd(rd(w8t @ x) + b8))                     # [32, n]
    sd = rd(se[t, :, b].T.float() + rd(wpt @ h1))             # [h, n]
    act = torch.stack([rd(torch.tanh(rd(sd + q[:, col]))) for q in qs], 0)
    scores = rd((act * v[None]).sum(1)).T                     # [n, C]
    mk = mask_k.reshape(T, C, -1)[t, :, b]                    # [n, C]
    masked = torch.where(mk == 1, scores / temperature, NEG)
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
    wpt, v = params[2].float(), params[10]
    g = _zeros_f32(params)
    (dw8t, db8, dwpt, dw1t, db1, dw2t, db2, det, dwqt, dbq, dv) = g
    dse, dctx = _zeros_f32((se, ctx))
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
        dqs = [torch.zeros(h, ni, dtype=dse.dtype, device=se.device)
               .index_add_(1, st["col"], dpre[c]) for c in range(act.shape[0])]
        dwpt += d_dyn @ h1.T
        dh1 = (wpt.T @ d_dyn) * (h1 > 0)
        dw8t += dh1 @ x.T
        db8 += dh1.sum(1, keepdim=True)
        dctx_i = torch.zeros(h, ni, dtype=dse.dtype, device=se.device)
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


def _record_floats(cfg: TAPConfig, h: int, dtype=F32) -> int:
    """Floats of one record of the deferred weight gradients, as the kernel
    lays it out (csrc/replay.cu `rec_off`; `record_floats` mirrors it)."""
    fn = _build.load("replay").tapnet_replay_record_floats
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(ctypes.cast(_build.int_array(_ints(cfg, 1, h)),
                          ctypes.c_void_p), int(dtype == torch.bfloat16))


def _check_operands(flags, hms, masks, acts, se, ctx, statp, statm, params,
                    cfg, steps=False, prev=None):
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    A, T, S = cfg.num_actions, N * cfg.num_rot, cfg.num_blocks
    _, h, B = se.shape
    cdt = se.dtype
    _check_cfg(cfg, h, steps, cdt)
    dev, i32, f32 = se.device, torch.int32, torch.float32
    operands = [
        ("flags", flags, (S, N, B), i32), ("hms", hms, (S, C * W, D, B), i32),
        ("masks", masks, (S, A, B), i32), ("acts", acts, (S, B), i32),
        ("se", se, (T, h, B), cdt), ("ctx", ctx, (h, B), cdt),
        ("statp", statp, (4, T, B), cdt), ("statm", statm, (4, B), cdt)]
    if steps:
        operands.append(("prev", prev, (S, B), i32))
    for name, t, shape, dt in operands:
        _check(t, name, shape, dt, dev)
    for i, (p, s) in enumerate(zip(params, head_shapes(cfg, h))):
        _check(p, f"params[{i}]", s, f32 if i == 10 else cdt, dev)
    return B, h, dev


def _launch(bwd, ptrs, cfg, B, h, temperature, dev, chunks, dtype):
    """`chunks` = 0: the monolithic schedule; else the step-grid one.
    `dtype`: the float operands' (the instantiation)."""
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        arr = _build.ptr_array(ptrs)
        ints = _ints(cfg, B, h) + [int(chunks > 0), max(chunks, 1),
                                   int(dtype == torch.bfloat16)]
        err = fn(int(bwd), ctypes.cast(arr, ctypes.c_void_p),
                 ctypes.cast(_build.int_array(ints), ctypes.c_void_p),
                 ctypes.c_float(1.0 / _scale(cfg)),
                 ctypes.c_float(temperature),
                 ctypes.c_float(1.0 / temperature), ctypes.c_void_p(stream))
    return err


@functools.cache
def _ring_index(h: int, K1: int, device) -> tuple:
    """Indices into W1, W2 and Wq flattened one after another and followed
    by one zero, that lay out the ring slabs csrc/ring_bf16.cuh streams,
    and the five slab sets' sizes: W1 [h][K1], W2 [h][h], Wq [h][3h + 8],
    the first 3h rows of Wq^T as three [h][h] blocks, and W2^T. A matrix
    [M][K] becomes slabs of RING_K columns, K padded with the zero: per
    slab its M rows of RING_K values, the 16-byte chunks of row r swizzled
    (chunk ch at position ch ^ ((r >> 1) & 3)), so that the 8 rows of an
    ldmatrix matrix fall in 8 bank groups without a pad. Above hidden 256
    (WX) a matrix's M rows are two halves, each its own slabs of M / 2 rows
    (the first half's, then the second's; each of Wq^T's blocks so). Built
    with device operations, once per width and device."""
    FQ = 3 * h + 8
    o2, o3 = h * K1, h * K1 + h * h
    zero = o3 + h * FQ
    nh = geometry(h)["nh"]
    hr = h // nh
    ar = lambda n: torch.arange(n, device=device)

    def slabs(K, at, lead=1):
        ns, nch = -(-K // RING_K), RING_K // 8
        u = ar(lead)[:, None, None, None, None, None]
        q = ar(nh)[None, :, None, None, None, None]
        s = ar(ns)[None, None, :, None, None, None]
        rr = ar(hr)[None, None, None, :, None, None]
        r = q * hr + rr
        ch = ar(nch)[None, None, None, None, :, None] ^ ((rr >> 1)
                                                        & (nch - 1))
        k = s * RING_K + 8 * ch + ar(8)[None, None, None, None, None, :]
        return torch.where(k < K, at(u, r, k.clamp(max=K - 1)),
                           zero).reshape(-1)

    parts = [slabs(K1, lambda u, r, k: r * K1 + k),
             slabs(h, lambda u, r, k: o2 + r * h + k),
             slabs(FQ, lambda u, r, k: o3 + r * FQ + k),
             slabs(h, lambda u, r, k: o3 + k * FQ + u * h + r, lead=3),
             slabs(h, lambda u, r, k: o2 + k * h + r)]
    return torch.cat(parts), tuple(p.numel() for p in parts)


def ring_operands(params, h: int):
    """The bfloat16 replay's weights above hidden 128 as ring slabs
    (`_ring_index`): W1, W2, Wq, Wq^T's first 3h rows (three [h, h]
    blocks) and W2^T, views of one buffer made by one gather; empty
    tensors for the other instantiations, which read none."""
    if params[3].dtype != torch.bfloat16 or h <= 128:
        return tuple(torch.empty(0, device=params[3].device)
                     for _ in range(5))
    w1, w2, wq = params[3], params[5], params[8]
    idx, sizes = _ring_index(h, w1.shape[1], w1.device)
    src = torch.cat([w1.reshape(-1), w2.reshape(-1), wq.reshape(-1),
                     w1.new_zeros(1)])
    return torch.split(src[idx], sizes)


def _scratch(cfg, B, h, chunks, dev):
    """The blocks' scratch above hidden 256 (pointer 39): one `wx_scratch`
    a block of the grid (tiles x chunks); empty at other widths."""
    blocks = -(-B // TB) * max(chunks, 1)
    return torch.empty(blocks * wx_scratch(cfg, h), dtype=torch.float32,
                       device=dev)


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
            + transposed(params) + (none, none)
            + ring_operands(params, h)
            + (_scratch(cfg, B, h, chunks, dev),))
    before = _helper_counts()
    err = _launch(False, ptrs, cfg, B, h, temperature, dev, chunks,
                  se.dtype)
    _count_helpers(before)  # the chunks' logp partials' sum, if any
    return logp, err


# None, or a list to which every backward launch appends the operands of
# its helper kernels: the records and sflag of the deferred contractions
# (empty where it keeps none) with their steps a row and the compute dtype
# that laid them out, the weight-gradient partial rows and their sum, the
# d_ctx chunk partials (empty for one chunk) and d_ctx
kept = None


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
    dse = torch.empty(se.shape, dtype=f32, device=dev)
    dctx = torch.empty(ctx.shape, dtype=f32, device=dev)
    part = torch.empty((tiles * nc, P), dtype=f32, device=dev)
    flat = torch.empty(P, dtype=f32, device=dev)
    none = torch.empty(0, device=dev)
    dse_part = torch.empty((nc, B, T, h), dtype=f32, device=dev)
    dctx_part = (torch.empty((nc,) + ctx.shape, dtype=f32, device=dev)
                 if nc > 1 else none)
    rec = sflag = none
    if record_floats(cfg, h, se.dtype):  # the deferred weight gradients
        rows, length = tiles * nc, _steps_per_row(cfg, chunks)
        rec = torch.empty(rows * length * cfg.num_containers
                          * _record_floats(cfg, h, se.dtype), dtype=f32,
                          device=dev)
        sflag = torch.zeros(rows * length, dtype=torch.int32, device=dev)
    ptrs = ((flags, hms, masks, acts, _se_rows(se), ctx, statp, statm, dlp)
            + tuple(params)
            + (none, dse, dctx, part, flat,
               none if prev is None else prev, none, dse_part, dctx_part)
            + transposed(params) + (rec, sflag)
            + ring_operands(params, h)
            + (_scratch(cfg, B, h, chunks, dev),))
    before = _helper_counts()
    err = _launch(True, ptrs, cfg, B, h, temperature, dev, chunks, se.dtype)
    _count_helpers(before)  # the helper kernels this launch ran
    if kept is not None:  # the helpers' operands, to hold them alone
        kept.append({"rec": rec, "sflag": sflag, "part": part,
                     "dctx_part": dctx_part, "dctx": dctx, "grads": flat,
                     "length": _steps_per_row(cfg, chunks) if rec.numel()
                     else 0, "dtype": se.dtype})
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
    """Backward, monolithic schedule (K5b); operands and results (float32)
    as in `replay_logp_bwd_ref`. The weight gradients are summed over instance
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


def record_floats(cfg: TAPConfig, h: int, dtype=F32) -> int:
    """Floats of one record of the deferred weight gradients (per step
    and container of a partial row), as csrc/replay.cu `rec_off` lays it
    out: per head pass of `geometry(h)["tp"]` instances dq, d_hm and de1
    [h][tp] f32, then qin [3h+8][tp], e1 [h][tp] and feats [W*D+2][tp],
    bfloat16 pairs in the bfloat16 backward, else f32; above hidden 128
    followed by q [h][tp] in the same type (A/B writes the activations, D
    reads q and e1 back). 0 for float32 at h <= 128, which keeps no
    records."""
    bf = dtype == torch.bfloat16
    if not bf and h <= 128:
        return 0
    tp = geometry(h)["tp"]
    xp = tp // 2 if bf else tp
    WD2 = cfg.target_width * cfg.target_depth + 2
    q = h * xp if h > 128 else 0
    return (3 * h * tp + (3 * h + 8 + h + WD2) * xp + q) * (TB // tp)


def rec_offsets(cfg: TAPConfig, h: int, dtype=F32) -> dict:
    """csrc/replay.cu `rec_off` in Python: the floats from a record part's
    start of its sections dq, dhm, de1 (f32 [h][tp]), qin [3h+8][xp], e1
    [h][xp], feats [W*D+2][xp] and, above hidden 128, q [h][xp] (xp = tp
    in float32, tp / 2 bfloat16 pairs in bfloat16), the part's floats
    ("pass") and the record's ("size": one part per head pass)."""
    tp = geometry(h)["tp"]
    xp = tp // 2 if dtype == torch.bfloat16 else tp
    WD2 = cfg.target_width * cfg.target_depth + 2
    out, o = {}, 0
    for name, n in (("dq", h * tp), ("dhm", h * tp), ("de1", h * tp),
                    ("qin", (3 * h + 8) * xp), ("e1", h * xp),
                    ("feats", WD2 * xp), ("q", h * xp if h > 128 else 0)):
        out[name], o = o, o + n
    out["pass"], out["size"] = o, o * (TB // tp)
    return out


def scratch_bytes(cfg: TAPConfig, B: int, h: int, dtype=F32) -> dict:
    """Device scratch of one step-grid backward call, in bytes: the [B, T,
    h] copy of se (float32: the bfloat16 one is half), the d_se partials
    (one per chunk), the d_ctx partials (none for one chunk), the
    weight-gradient partial rows, the records of the deferred weight
    gradients (the bfloat16 backward, and the float32 one above hidden
    128: `record_floats`) and, above hidden 256, the blocks' head arrays
    (`wx_scratch`)."""
    chunks = step_chunks(cfg, B)
    tiles = (B + TB - 1) // TB
    T = cfg.num_blocks * cfg.num_rot
    P = sum(a * b for a, b in head_shapes(cfg, h))
    rows, length = tiles * chunks, _steps_per_row(cfg, chunks)
    return {"chunks": chunks, "head_scratch": 4 * rows * wx_scratch(cfg, h),
            "se_rows": (2 if dtype == torch.bfloat16 else 4) * B * T * h,
            "d_se_partials": 4 * chunks * T * h * B,
            "d_ctx_partials": 4 * chunks * h * B * (chunks > 1),
            "weight_partials": 4 * tiles * chunks * P,
            "records": 4 * rows * length * cfg.num_containers
            * record_floats(cfg, h, dtype)}


class ReplayLogp(torch.autograd.Function):
    """logp [B] = sum_t log pi(a_t | s_t), differentiable in se, ctx and the
    11 head operands; the record is data (gradient None). The schedule
    follows the config (`_steps_grid`), the instantiation the operands'
    dtype; each gradient is cast to its operand's dtype (in bfloat16 the
    weights' and se's gradients are rounded to bfloat16, v's stays
    float32, as the JAX `_bwd_impl` casts them).

    apply(cfg, temperature, logp0, flags, hms, masks, acts, statp, statm,
          se, ctx, *params)

    With `logp0` (a tensor [B]) the forward returns it and launches
    nothing; the gradients are the same either way, since the backward
    re-runs the head itself.

    A hidden width the kernels do not take (`kernel_width(h)` != h: 48,
    100, 288, ...) runs on se, ctx and the head operands padded with zeros
    to the kernels' width (`_padded`, once a call), and the gradients are
    sliced back to h: the pads add exact zeros to every value, and their
    own gradients are exactly 0."""

    @staticmethod
    def forward(ctx_, cfg, temperature, logp0, flags, hms, masks, acts,
                statp, statm, se, ctx, *params):
        ctx_.cfg, ctx_.temperature = cfg, temperature
        ctx_.save_for_backward(flags, hms, masks, acts, statp, statm, se,
                               ctx, *params)
        if logp0 is not None:
            return logp0.detach().clone()
        se, ctx, params = _padded(se, ctx, params)
        if _steps_grid(cfg):
            return replay_logp_fwd_steps(flags, hms, masks, acts,
                                         _prev_rows(acts), se, ctx, statp,
                                         statm, params, cfg, temperature)
        return replay_logp_fwd(flags, hms, masks, acts, se, ctx, statp,
                               statm, params, cfg, temperature)

    @staticmethod
    def backward(ctx_, dlp):
        flags, hms, masks, acts, statp, statm, se0, ctx0, *params0 = \
            ctx_.saved_tensors
        dlp = dlp.contiguous().float()
        h = se0.shape[1]
        se, ctx, params = _padded(se0, ctx0, params0)
        if _steps_grid(ctx_.cfg):
            dse, dctx, dparams = replay_logp_bwd_steps(
                dlp, flags, hms, masks, acts, _prev_rows(acts), se, ctx,
                statp, statm, tuple(params), ctx_.cfg, ctx_.temperature)
        else:
            dse, dctx, dparams = replay_logp_bwd(
                dlp, flags, hms, masks, acts, se, ctx, statp, statm,
                tuple(params), ctx_.cfg, ctx_.temperature)
        dse, dctx = dse[:, :h], dctx[:h]
        grads = [g.to(x.dtype) for g, x in zip(
            (dse, dctx, *unpad_head(dparams, h)), (se0, ctx0, *params0))]
        return (None, None, None, None, None, None, None, None, None,
                *grads)


def _padded(se, ctx, params):
    """se [T, h, B], ctx [h, B] and the head operands padded with zeros to
    the kernels' width `kernel_width(h)` (themselves when it is h)."""
    h = se.shape[1]
    hk = kernel_width(h)
    if hk == h:
        return se, ctx, tuple(params)
    return (pad_hidden(se, hk, 1).contiguous(),
            pad_hidden(ctx, hk, 0).contiguous(),
            tuple(p.contiguous() for p in pad_head(params, hk)))


# ------------------------------------------------------------------ #
# the backward's helper kernels alone (csrc/replay.cu): the main path
# launches them inside `tapnet_replay_logp`; these wrappers launch one on
# given operands, to hold it to its plain version and to time it

GO_NT, GO_NX, GO_RS, GO_NB, GO_SL = 128, 136, 5, 3, 40  # csrc/replay.cu:
#   grad_outer_tf32's tile, widest last tile, raw stages, B tile buffers
#   and floats of a staging row (grad_outer's too, but for its raw
#   stages: `grad_outer_bf16_plan`)


def go_rows(h: int) -> int:
    """Rows of G one block of `grad_outer_tf32` / `grad_outer` takes
    (csrc/replay.cu `go_rows`): all h up to 256, a row half above (the
    grid's third axis)."""
    return h // 2 if h > 256 else h


def grad_outer_smem(h: int) -> int:
    """Bytes of dynamic shared memory of one `grad_outer_tf32` block at
    hidden h, as csrc/replay.cu `go_plan` lays it out: GO_RS raw stages
    (a G part, h rows of 16 f32, and up to GO_NX X rows, 1024-byte
    aligned), GO_NB buffers of the split B tile (hi and lo), the
    mbarriers, the count and the list of acting steps, a [16][GO_SL]
    float staging array a warp, and the slack of aligning the base to
    1024 bytes. Above hidden 256 a block takes a row half of G (`go_rows`),
    and the plan is that of h / 2."""
    h = go_rows(h)
    row, wg = 16 * 4, -(-h // 64)
    stage = (h * row + GO_NX * row + 1023) & ~1023
    return (GO_RS * stage + GO_NB * 2 * GO_NX * row + 8 * GO_RS + 16
            + 4 * MAX_N + 4 * wg * 16 * GO_SL * 4 + 1024)


def grad_outer_bf16_plan(h: int) -> dict:
    """csrc/replay.cu `gb_plan`, the shared-memory plan of one bfloat16
    `grad_outer` block at hidden h, in bytes: warpgroups ("wg"), raw
    stages ("rs": 3 at h <= 128, so that two blocks share an SM; 4
    above), a stage's G (h rows of 32 lanes f32), a raw stage (G, then X's
    rows: up to GO_NX of 64 bytes, the two passes' runs 64 bytes apart;
    1024-byte aligned), a B tile, and the block's whole plan ("bytes": the
    ring, GO_NB B tiles, the mbarriers, the count and the list of acting
    steps and the slack of aligning the base to 1024 bytes). Above hidden
    256 a block takes a row half of G (`go_rows`): the plan of h / 2."""
    h = go_rows(h)
    p = {"wg": -(-h // 64), "rs": 3 if h <= 128 else 4, "g": h * 32 * 4,
         "b": GO_NX * 64}
    p["stage"] = (p["g"] + GO_NX * 64 + 64 + 1023) & ~1023
    p["bytes"] = (p["rs"] * p["stage"] + GO_NB * p["b"] + 8 * p["rs"] + 16
                  + 4 * MAX_N + 1024)
    return p


def _grad_blocks(cfg: TAPConfig, h: int):
    """(param index, columns) of the three weight gradients grad_outer
    writes, W1 [h][W*D+2], W2 [h][h], Wq [h][3h+8], and each one's offset
    in a partial row of [tiles, P] (the head operands' order)."""
    shapes = head_shapes(cfg, h)
    offs = [sum(a * b for a, b in shapes[:i]) for i in range(len(shapes))]
    return [(i, shapes[i][1], offs[i]) for i in (3, 5, 8)]


def grad_outer_ref(rec, sflag, cfg: TAPConfig, h: int, length: int,
                   dtype=F32):
    """Plain version of `grad_outer_tf32` (dtype float32) and of
    `grad_outer_bf16` (bfloat16): from the records rec [rows * length * C
    * record_floats(cfg, h, dtype)] float32 (`rec_offsets`: the gradient
    sections f32, the activation sections f32 or bfloat16 pairs) and
    sflag [rows * length] (nonzero: the step has an action), per partial
    row the gradients of W1, W2 and Wq [rows, h, cols]: the sums over the
    row's acting steps, their containers, the record's passes and lanes
    of de1 feats^T, d_hm e1^T and dq qin^T (float32 products; a step
    without an action, whose record the kernel never wrote, adds
    nothing)."""
    ro = rec_offsets(cfg, h, dtype)
    C, tp = cfg.num_containers, geometry(h)["tp"]
    rows = sflag.numel() // length
    r = rec.view(rows, length, C, TB // tp, ro["pass"])
    on = (sflag.view(rows, length) != 0)[:, :, None, None, None, None]

    def sec(name, n, half=False):  # half: bfloat16 pairs, 2 values a float
        o = ro[name]
        v = (r.view(torch.bfloat16)[..., 2 * o:2 * o + n * tp].float()
             if half else r[..., o:o + n * tp])
        v = v.reshape(rows, length, C, TB // tp, n, tp)
        return torch.where(on, v, torch.zeros((), dtype=v.dtype,
                                              device=v.device))

    WD2 = cfg.target_width * cfg.target_depth + 2
    half = dtype == torch.bfloat16
    return tuple(torch.einsum("rscpjl,rscpnl->rjn", sec(g, h),
                              sec(x, n, half))
                 for g, x, n in (("de1", "feats", WD2), ("dhm", "e1", h),
                                 ("dq", "qin", 3 * h + 8)))


@functools.cache
def _helper_lib():
    lib = _build.load("replay")
    go = lib.tapnet_replay_grad_outer
    go.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    rt = lib.tapnet_replay_reduce_tiles
    rt.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    for fn in (go, rt):
        fn.restype = ctypes.c_int
    n = lib.tapnet_replay_helper_launches
    n.argtypes, n.restype = [ctypes.c_void_p], None
    return go, rt, n


RT_WIDTHS = (1, 2, 4)  # reduce_tiles' loads: floats a thread


def _helper_counts() -> tuple:
    """The launches of grad_outer_tf32, of reduce_tiles at each of
    RT_WIDTHS and of grad_outer (bfloat16) since the library was loaded,
    as csrc/replay.cu counts them where it launches each."""
    buf = (ctypes.c_longlong * 5)()
    _helper_lib()[2](buf)
    return tuple(buf)


def _count_helpers(before):
    """Add the helper launches since `before` (`_helper_counts()`) to the
    wrappers' counters: `grad_outer_tf32.launches`, `reduce_tiles.launches`
    and `reduce_tiles.widths` (launches by load width),
    `grad_outer_bf16.launches`."""
    d = [a - b for a, b in zip(_helper_counts(), before)]
    grad_outer_tf32.launches += d[0]
    reduce_tiles.launches += sum(d[1:4])
    for v, k in zip(RT_WIDTHS, d[1:4]):
        reduce_tiles.widths[v] += k
    grad_outer_bf16.launches += d[4]


def _grad_outer(rec, sflag, cfg, h, length, part, dtype):
    """Launch csrc/replay.cu's `grad_outer_tf32` or `grad_outer` (dtype)
    on given records; checks the operands, returns the views of part."""
    bf = dtype == torch.bfloat16
    name = "grad_outer_bf16" if bf else "grad_outer_tf32"
    if h < (32 if bf else 160) or h > MAX_H or h != kernel_width(h):
        raise NotImplementedError(f"{name}: hidden {h}")
    rows, dev = sflag.numel() // length, rec.device
    _check(rec, "rec", (rows * length * cfg.num_containers
                        * record_floats(cfg, h, dtype),), torch.float32, dev)
    _check(sflag, "sflag", (rows * length,), torch.int32, dev)
    blocks = _grad_blocks(cfg, h)
    P = sum(a * b for a, b in head_shapes(cfg, h))
    if part is None:
        part = torch.zeros((rows, P), dtype=torch.float32, device=dev)
    _check(part, "part", (rows, P), torch.float32, dev)
    before = _helper_counts()
    with torch.cuda.device(dev):
        err = _helper_lib()[0](
            rec.data_ptr(), sflag.data_ptr(),
            ctypes.cast(_build.int_array(_ints(cfg, 1, h)), ctypes.c_void_p),
            rows, length, int(bf), part.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _count_helpers(before)
    _build.check(err, name)
    return tuple(part[:, o:o + h * k].view(rows, h, k) for _, k, o in blocks)


def grad_outer_tf32(rec, sflag, cfg: TAPConfig, h: int, length: int,
                    part=None):
    """The deferred weight-gradient contractions of the float32 backward
    above hidden 128 (csrc/replay.cu `grad_outer_tf32`, wgmma 3xTF32) on
    given records; operands and results as in `grad_outer_ref` (the
    results are views of `part`, a float32 [rows, P] partial-row buffer
    of which the kernel writes the three gradients' columns: zeros by
    default). On CPU tensors the plain version."""
    if not rec.is_cuda:
        return grad_outer_ref(rec, sflag, cfg, h, length)
    return _grad_outer(rec, sflag, cfg, h, length, part, F32)


grad_outer_tf32.launches = 0


def grad_outer_bf16(rec, sflag, cfg: TAPConfig, h: int, length: int,
                    part=None):
    """The deferred weight-gradient contractions of the bfloat16 backward
    at every hidden width 32 .. 256 (csrc/replay.cu `grad_outer`, wgmma,
    the f32 gradients split into bf16 hi + lo) on given bfloat16 records;
    operands and results as in `grad_outer_ref(..., dtype=bfloat16)` (the
    results views of `part`, as `grad_outer_tf32`'s). On CPU tensors the
    plain version."""
    if not rec.is_cuda:
        return grad_outer_ref(rec, sflag, cfg, h, length, torch.bfloat16)
    return _grad_outer(rec, sflag, cfg, h, length, part, torch.bfloat16)


grad_outer_bf16.launches = 0


def reduce_tiles_ref(part):
    """Plain version of `reduce_tiles`: out [P] = part[0] + part[1] + ...,
    a left-to-right float32 sum over the rows of part [tiles, P] from 0,
    in row order (the kernel's bits)."""
    out = torch.zeros(part.shape[1], dtype=torch.float32, device=part.device)
    for t in range(part.shape[0]):
        out += part[t]
    return out


def reduce_tiles(part, out=None):
    """The ordered sum of partial rows (csrc/replay.cu `reduce_tiles`) of a
    float32 [tiles, P] into `out` [P] (a new tensor by default): bit for
    bit `reduce_tiles_ref`. On CPU tensors the plain version."""
    if not part.is_cuda:
        return reduce_tiles_ref(part)
    if part.dim() != 2 or part.dtype != torch.float32 \
            or not part.is_contiguous():
        raise ValueError("reduce_tiles: part must be a contiguous float32 "
                         f"[tiles, P], got {part.dtype} {tuple(part.shape)}")
    if out is None:
        out = torch.empty(part.shape[1], dtype=torch.float32,
                          device=part.device)
    _check(out, "out", (part.shape[1],), torch.float32, part.device)
    before = _helper_counts()
    with torch.cuda.device(part.device):
        err = _helper_lib()[1](
            part.data_ptr(), part.shape[0], part.shape[1], out.data_ptr(),
            torch.cuda.current_stream(part.device).cuda_stream)
    _count_helpers(before)
    _build.check(err, "reduce_tiles")
    return out


reduce_tiles.launches = 0
reduce_tiles.widths = dict.fromkeys(RT_WIDTHS, 0)
