"""Policy rollouts: the batched decode loop, the port of the rollout half of
`tapnet_tpu/train/rollout.py`.

`rollout_batch_record` rolls a batch with the actor under `torch.no_grad()`
and returns (states, RolloutRecord, logp_sum). It picks a path by `routes`,
as the JAX package does, each kernel only where its `eligible` covers the
config at the actor's hidden width:

- sampled decode on a CUDA device where the actor kernel covers the config
  (unbounded height, N <= 62, rolling windows included, C <= 4, hidden a
  multiple of 32 up to 256): `_rollout_record_actorfused`, one
  `actor_select_step` launch per step in its live-column mode;
- otherwise on a CUDA device where `select_step` covers it (W*D <= 256):
  `_rollout_record_stepfused`, the actor head as PyTorch ops and one
  `select_step` launch per step. Greedy decode stays off the actor kernel
  because it sits on argmax ties between duplicate blocks (SPEC.md §12);
- otherwise, and on the CPU: `_rollout_record_general`, the reference path.

On rolling unbounded configs (`_use_windowed_head`) the general and the
step-fused rollout score only the window's tokens per step
(`_make_windowed_head`: gather the <= window observable blocks, score them
through `TAPNetActor.head_ctx`, scatter back to [B, A]); the actor kernel
scores the live (instance, token) columns, the window's unpacked blocks that
fit, and masks the rest, which gives the same softmax.

`step_kernel` / `actor_kernel` force a path; on CPU tensors the kernel
wrappers run their plain versions, which is how the tests drive the fused
paths without a card. The decode loop is a Python loop over the N steps.
Sampling is gumbel-argmax with the JAX draws gumbel(fold_in(keys[b], t)),
so a seed samples the same trajectories on both sides.

`replay_logp_sum` is the differentiable half: sum_t log pi(a_t | s_t) of a
recorded rollout, through the replay kernels (`ops/replay.py`: the
monolithic schedule, or the step-grid one for rolling configs and N > 31)
on the card where they cover the config, else through autograd of
`TAPNetActor.head` over all N steps (`_replay_logp_general`) or, for
rolling unbounded configs, of `head_ctx` over the window's tokens only
(`_replay_logp_windowed`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.models.features import (dynamic_flags, f32_on,
                                          heightmap_grid, mask_from_flags,
                                          merge_tokens, static_tokens,
                                          tokens_from_flags)
from tapnet_torch.models.tapnet import TAPNetActor, embed_static_T
from tapnet_torch.ops import actor_step as AS
from tapnet_torch.ops import env as OE
from tapnet_torch.ops import policy_step as PS
from tapnet_torch.ops import replay as RP
from tapnet_torch.types import EnvState, Instance

NEG = -1e9


class RolloutRecord(NamedTuple):
    """Per-step observations (pre-step state), stacked on a leading decode
    step axis of length N."""

    flags: torch.Tensor      # uint8[N, B, num_blocks]
    heightmap: torch.Tensor  # int32[N, B, C, W, D]
    mask: torch.Tensor       # bool[N, B, A]
    action: torch.Tensor     # int32[N, B] (-1 = no feasible action)


def _masked_logits(logits, mask, temperature):
    return torch.where(mask, logits / temperature, NEG)


def _gumbel_all(keys: torch.Tensor, cfg: TAPConfig) -> torch.Tensor:
    """All decode-step gumbel draws [N, B, A]: gumbel(fold_in(keys[b], t))."""
    ts = torch.arange(cfg.num_blocks, device=keys.device)
    kt = R.fold_in(keys[None, :, :], ts[:, None])             # [N, B, 2]
    return R.gumbel(kt, (cfg.num_actions,))


class Routes(NamedTuple):
    """The kernels a call takes (`routes`)."""

    decode: str    # "actor" (K2), "step" (K1) or "general": the decode loop
    replay: bool   # K5, the replay of a train step
    rollout: bool  # K4, pack(first/random) and evaluate(baselines=True)


def routes(cfg: TAPConfig, on_card: bool, hidden: int = 128,
           greedy: bool = False, dtype=torch.float32) -> Routes:
    """The kernels the routers take for `cfg` at hidden width `hidden` and
    compute dtype `dtype`: on the card each kernel where its `eligible`
    covers the config, as the JAX package's routers ask; on the CPU none.
    Sampled decode takes K2, else K1, else the general loop (greedy decode
    skips K2); the replay takes K5, else the windowed or the general
    replay; a heuristic rollout takes K4, else `env.core.rollout_batch`. A
    pure function of its arguments: the CPU tests rehearse the card's
    choices with on_card=True."""
    if on_card and not greedy and AS.eligible(cfg, hidden, dtype):
        decode = "actor"
    elif on_card and PS.eligible(cfg):
        decode = "step"
    else:
        decode = "general"
    return Routes(decode, on_card and RP.eligible(cfg, hidden, dtype),
                  on_card and OE.eligible(cfg))


@torch.no_grad()
def rollout_batch_record(actor: TAPNetActor, instances: Instance,
                         keys: torch.Tensor, cfg: TAPConfig,
                         greedy: bool = False, temperature: float = 1.0,
                         with_logp: bool = True, step_kernel=None,
                         actor_kernel=None, dtype=torch.float32):
    """Roll a batch; returns (states, RolloutRecord, logp_sum [B]). `dtype`:
    the compute dtype."""
    dt = dtype
    r = routes(cfg, instances.dims.is_cuda, actor.hidden,
               greedy=greedy or actor_kernel is False, dtype=dt)
    if actor_kernel or (actor_kernel is None and r.decode == "actor"):
        route = _rollout_record_actorfused
    elif step_kernel or (step_kernel is None and r.decode == "step"):
        route = _rollout_record_stepfused
    else:
        route = _rollout_record_general
    return route(actor, instances, keys, cfg, greedy, temperature, with_logp,
                 dt)


def _step_mask(flags, state, instances, cfg):
    if cfg.target_height == 0:
        return mask_from_flags(flags, instances, cfg)
    return E.action_mask(state, instances, cfg)


def _head_logits(actor, static, static_emb, flags, heightmap, prev, t, cfg,
                 dtype=torch.float32):
    """Logits [B, A]; `t` steps taken, an int or an int tensor [B]."""
    t_frac = f32_on(t, flags.device) / cfg.num_blocks
    dynamic = merge_tokens(static, tokens_from_flags(flags, t_frac, cfg))
    return actor.head(static_emb, dynamic, heightmap_grid(heightmap, cfg),
                      prev, dtype)


def _log_softmax_at(masked, a):
    lsm = torch.log_softmax(masked, dim=-1)
    return lsm.gather(-1, a.clamp(min=0).long()[:, None])[:, 0]


def _use_windowed_head(cfg: TAPConfig) -> bool:
    """Rolling unbounded-height configs score only the <= window observable
    tokens per decode step (`_make_windowed_head`, `_replay_logp_windowed`)."""
    return 0 < cfg.window < cfg.num_blocks and cfg.target_height == 0


def _window_plan(f: torch.Tensor, Kw: int):
    """The window gather plan from int32 flag words [..., N]: (win [..., N],
    rank [..., N], bidx [..., Kw], validw [..., Kw]). Slot w of the window
    holds block bidx[..., w], the w-th block (in index order) with flag bit
    3 set; an empty slot has bidx == N and validw False. The rollout head
    and the replay share it, so both score the same tokens."""
    N = f.shape[-1]
    win = (f >> 3) & 1
    rank = win.cumsum(-1) - win
    slot = torch.where(win == 1, rank, Kw).long()             # Kw = nowhere
    blocks = torch.arange(N, device=f.device).expand(f.shape)
    bidx = torch.full(f.shape[:-1] + (Kw + 1,), N, dtype=torch.long,
                      device=f.device).scatter(-1, slot, blocks)[..., :Kw]
    return win, rank, bidx, bidx < N


def _pad_blocks(x: torch.Tensor) -> torch.Tensor:
    """[B, N, F] -> [B, N + 1, F] with a zero row for the empty slots."""
    return torch.cat([x, torch.zeros_like(x[:, :1])], 1)


def _gather_blocks(x_pad: torch.Tensor, bidx: torch.Tensor) -> torch.Tensor:
    """x_pad [B, N + 1, F] at bidx [..., B, Kw] -> [..., B, Kw, F] (zeros at
    empty slots, as a one-hot contraction would give)."""
    lead = bidx.shape[:-2]
    x = x_pad.expand(lead + x_pad.shape)
    idx = bidx[..., None].expand(bidx.shape + x_pad.shape[-1:])
    return x.gather(-2, idx)


def _window_dsum(f, win, t_frac, stat_mean, cfg: TAPConfig):
    """The head's mean merged token [..., 8] from integer bit counts of the
    flag words f [..., N] and the static-feature means stat_mean [..., 4],
    in stat_mean's dtype: the counts are float32, cast once (in bfloat16
    these summaries are not the full head's, whose means are taken over
    bfloat16 tokens); t_frac broadcasts against f[..., 0]."""
    N, R_ = cfg.num_blocks, cfg.num_rot
    pk = (f & 1).sum(-1).float()
    a0 = ((f >> 1) & 1).sum(-1).float()
    ar = ((f >> 2) & 1).sum(-1).float()
    wn = win.sum(-1).float()
    acc_mean = (a0 + ar) / (N * R_) if R_ == 2 else a0 / N
    tf = torch.broadcast_to(f32_on(t_frac, f.device), pk.shape)
    dyn4 = torch.stack([pk / N, acc_mean, wn / N, tf], -1).to(stat_mean.dtype)
    return torch.cat([dyn4, torch.broadcast_to(
        stat_mean, dyn4.shape[:-1] + (4,))], -1)


def _make_windowed_head(actor, instances, static, static_emb,
                        cfg: TAPConfig, dtype=torch.float32):
    """Per-step head of a rolling config: gather the <= window observable
    blocks, score their tokens only (`head_ctx`), scatter the scores back
    to the full [B, A] logit vector (0 at the other positions, all of them
    masked). At the window's positions the logits are those of the full
    head in float32: the gathers copy values, and the two full-token
    summaries are ctx (per instance) and exact bit counts of the flags. In
    bfloat16 (`dtype`) the count summary is cast once from float32, as the
    JAX windowed head does, so the logits may differ from the full head's
    by a rounding. An index gather and a scatter stand where the JAX
    package contracts one-hots.

    Returns fn(flags u8[B, N], heightmap [B, C, W, D], prev [B], t_frac)
    -> logits f32[B, A]."""
    N, R_, C, Kw = (cfg.num_blocks, cfg.num_rot, cfg.num_containers,
                    cfg.window)
    B, h = static_emb.shape[0], static_emb.shape[-1]
    ctx = static_emb.mean(1)                                  # [B, h]
    static = static.to(dtype)
    stat_mean = static.mean(1)                                # [B, 4]
    se_pad = _pad_blocks(static_emb.reshape(B, N, R_ * h))
    static_pad = _pad_blocks(static.reshape(B, N, R_ * 4))

    def win_head(flags, heightmap, prev, t_frac):
        f = flags.int()                                       # [B, N]
        win, _, bidx, validw = _window_plan(f, Kw)            # [B, Kw]
        se_g = _gather_blocks(se_pad, bidx).reshape(B, Kw * R_, h)
        gf = torch.cat([f, torch.zeros_like(f[:, :1])], 1).gather(1, bidx)
        static_g = _gather_blocks(static_pad, bidx).reshape(B, Kw * R_, 4)
        t_frac = f32_on(t_frac, f.device)
        merged = torch.cat([tokens_from_flags(gf, t_frac, cfg).to(dtype),
                            static_g], -1)                    # [B, Kw*R, 8]
        dsum = _window_dsum(f, win, t_frac, stat_mean, cfg)   # [B, 8]
        scores = actor.head_ctx(se_g, merged, heightmap_grid(heightmap, cfg),
                                prev, ctx, dsum, dtype)       # [B, Kw*R*C]
        full = torch.zeros((B, N + 1, R_ * C), dtype=scores.dtype,
                           device=scores.device)
        full.scatter_(1, bidx[..., None].expand(B, Kw, R_ * C),
                      scores.reshape(B, Kw, R_ * C))
        return full[:, :N].reshape(B, cfg.num_actions)

    return win_head


def _step_head(actor, instances, static, static_emb, cfg, dtype):
    """fn(flags, heightmap, prev, t) -> logits [B, A] of one decode step:
    the windowed head on rolling unbounded configs, else the full head."""
    if _use_windowed_head(cfg):
        win_head = _make_windowed_head(actor, instances, static, static_emb,
                                       cfg, dtype)
        return lambda flags, hm, prev, t: win_head(
            flags, hm, prev, f32_on(t, flags.device) / cfg.num_blocks)
    return lambda flags, hm, prev, t: _head_logits(
        actor, static, static_emb, flags, hm, prev, t, cfg, dtype)


def _rollout_record_general(actor, instances, keys, cfg, greedy,
                            temperature, with_logp, dtype):
    B = instances.dims.shape[0]
    dev = instances.dims.device
    state = E.reset(instances, cfg)
    static = static_tokens(instances, cfg)                   # [B, T, 4]
    static_emb = actor.embed_static(static, dtype)           # [B, T, h]
    head = _step_head(actor, instances, static, static_emb, cfg, dtype)
    g_all = None if greedy else _gumbel_all(keys, cfg)
    prev = torch.full((B,), -1, dtype=torch.int32, device=dev)
    logp_sum = torch.zeros(B, device=dev)
    recs = []
    for t in range(cfg.num_blocks):
        flags = dynamic_flags(instances, state.packed, cfg)
        mask = _step_mask(flags, state, instances, cfg)
        logits = head(flags, state.heightmap, prev, state.t)
        masked = _masked_logits(logits, mask, temperature)
        score = masked if greedy else masked + g_all[t]
        a = torch.argmax(score, dim=-1).int()
        valid = mask.any(-1)
        if with_logp:
            logp_sum = logp_sum + torch.where(
                valid, _log_softmax_at(masked, a), 0.0)
        a = torch.where(valid, a, -1)
        recs.append((flags, state.heightmap, mask, a))
        state = E.step(state, a, instances, cfg)
        prev = a
    return state, _stack_record(recs), logp_sum


def _stack_record(recs):
    return RolloutRecord(*(torch.stack(x, 0) for x in zip(*recs)))


def _batch_last(instances, cfg):
    """dims_w/d/h i32[N, B] and the reset state, batch-last."""
    B = instances.dims.shape[0]
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    dev = instances.dims.device
    dims = [instances.dims[:, :, k].T.int().contiguous() for k in range(3)]
    packed0 = E.reset(instances, cfg).packed.T.int().contiguous()
    hm0 = torch.zeros((C * W, D, B), dtype=torch.int32, device=dev)
    plc0 = torch.full((N * 6, B), -1, dtype=torch.int32, device=dev)
    return dims, packed0, hm0, plc0


def _final_state(packed, hm, plc, actions, cfg):
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    B = packed.shape[1]
    return EnvState(
        heightmap=hm.reshape(C, W, D, B).permute(3, 0, 1, 2).contiguous(),
        packed=packed.T.bool().contiguous(),
        placements=plc.reshape(N, 6, B).permute(2, 0, 1).contiguous(),
        t=(actions >= 0).int().sum(0).int())


def _hm_batch_major(hm_bl, cfg):
    C, W, D = cfg.num_containers, cfg.target_width, cfg.target_depth
    return hm_bl.reshape(C, W, D, -1).permute(3, 0, 1, 2)


def _rollout_record_stepfused(actor, instances, keys, cfg, greedy,
                              temperature, with_logp, dtype):
    """Actor head as PyTorch ops (windowed on rolling configs); one
    `select_step` per decode step places the block on the batch-last env
    state."""
    B = instances.dims.shape[0]
    dev = instances.dims.device
    static = static_tokens(instances, cfg)
    static_emb = actor.embed_static(static, dtype)
    head = _step_head(actor, instances, static, static_emb, cfg, dtype)
    (dw, dd, dh), packed, hm, plc = _batch_last(instances, cfg)
    g_all = None if greedy else _gumbel_all(keys, cfg)
    prev = torch.full((B,), -1, dtype=torch.int32, device=dev)
    logp_sum = torch.zeros(B, device=dev)
    recs = []
    for t in range(cfg.num_blocks):
        hm_b = _hm_batch_major(hm, cfg)
        packed_b = packed.T.bool()
        flags = dynamic_flags(instances, packed_b, cfg)
        state_b = EnvState(heightmap=hm_b, packed=packed_b,
                           placements=None, t=None)
        mask = _step_mask(flags, state_b, instances, cfg)
        logits = head(flags, hm_b, prev, t)
        masked = _masked_logits(logits, mask, temperature)
        score = masked if greedy else masked + g_all[t]
        packed, hm_n, plc, a = PS.select_step(
            score.T.contiguous(), mask.T.int().contiguous(), packed, hm, plc,
            dw, dd, dh, cfg)
        if with_logp:
            logp_sum = logp_sum + torch.where(
                a >= 0, _log_softmax_at(masked, a), 0.0)
        recs.append((flags, hm_b, mask, a))
        hm = hm_n
        prev = a
    record = _stack_record(recs)
    return _final_state(packed, hm, plc, record.action, cfg), record, logp_sum


def _rollout_record_actorfused(actor, instances, keys, cfg, greedy,
                               temperature, with_logp, dtype):
    """One `actor_select_step` per decode step in its live-column mode
    (`logits=False`): flags, mask, the head over the live columns, the
    gumbel argmax, select/place and log pi in one launch. Only the static
    embedding (as the kernel's [B, T, h] rows, built once), in float32 up
    to hidden 128 the transposed W1, W2, Wq (once), above it the weight
    ring's slabs (once) and the gumbel sweep run as PyTorch ops; above hidden 128 the
    query's step-invariant part is one `query_parts` launch a rollout.
    The float operands are in the compute dtype `dtype` (the head's v and
    the gumbel stay float32), which picks the kernel's instantiation. A
    hidden width the kernel does not take runs at `kernel_width` on se,
    ctx and head operands padded with zeros once a rollout (`pad_head`),
    which changes no output."""
    B = instances.dims.shape[0]
    dev = instances.dims.device
    N, R_, A = cfg.num_blocks, cfg.num_rot, cfg.num_actions
    T = N * R_
    static = static_tokens(instances, cfg)                   # [B, T, 4]
    static_t4 = static.permute(2, 1, 0).reshape(4, T * B)    # [4, T*B]
    se_htb = embed_static_T(actor, static_t4, dtype).reshape(-1, T, B)
    se = se_htb.permute(2, 1, 0).contiguous()                # [B, T, h]
    ctx = se_htb.mean(1).contiguous()                        # [h, B]
    statp = static_t4.to(dtype).reshape(4, T, B).contiguous()
    statm = static.to(dtype).mean(1).T.contiguous()          # [4, B]
    upm, rotm = AS.precedence_bitmasks(instances, cfg)
    fits = AS.fits_planes(instances, cfg)
    params = AS.head_operands(actor, cfg, dtype)
    hk = AS.kernel_width(actor.hidden)
    if hk != actor.hidden:  # the kernel's width: zero units, once
        params = AS.pad_head(params, hk)
        se = AS.pad_hidden(se, hk, 2).contiguous()
        ctx = AS.pad_hidden(ctx, hk, 0).contiguous()
    params_t = (AS.transposed(params) if dtype == torch.float32
                and params[8].shape[0] <= 128 else None)
    wide = AS.wide_operands(params, ctx, cfg)  # above 128, on the card
    (dw, dd, dh), packed, hm, plc = _batch_last(instances, cfg)
    g_all = (torch.zeros((N, A, B), device=dev) if greedy
             else _gumbel_all(keys, cfg).transpose(1, 2).contiguous())
    prev = torch.full((1, B), -1, dtype=torch.int32, device=dev)
    logp_sum = torch.zeros(B, device=dev)
    recs = []
    for t in range(N):
        tf = torch.full((1, 1), t, dtype=torch.float32, device=dev) / N
        packed_n, hm_n, plc, a, flags, mask, _, lp = AS.actor_select_step(
            tf, packed, hm, plc, prev, dw, dd, dh, upm, rotm, fits, g_all[t],
            se, ctx, statp, statm, params, cfg, temperature, logits=False,
            params_t=params_t, wide=wide)
        if with_logp:
            logp_sum = logp_sum + lp
        recs.append((flags.T.to(torch.uint8), _hm_batch_major(hm, cfg),
                     mask.T.bool(), a))
        packed, hm, prev = packed_n, hm_n, a[None]
    record = _stack_record(recs)
    return _final_state(packed, hm, plc, record.action, cfg), record, logp_sum


# ------------------------------------------------------------------ #
# replay: differentiable log-probs of a recorded rollout

def replay_logp_sum(actor: TAPNetActor, instances: Instance,
                    record: RolloutRecord, cfg: TAPConfig,
                    temperature: float = 1.0, chunk: int = 0, kernel=None,
                    logp0=None, windowed=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Differentiable sum_t log pi(a_t | s_t) [B] of the recorded actions,
    computed in `dtype` (the value is float32).

    kernel (auto: on for CUDA tensors where `routes` takes the replay
    kernels, i.e. `ops.replay.eligible(cfg, hidden)`): the replay kernel
    path, `_replay_logp_kernel`, whose schedule `ops.replay` picks per
    config (monolithic, or step-grid for rolling windows and N > 31); on
    CPU tensors `kernel=True` runs the kernels' plain versions through the
    same autograd Function. A config the kernels do not cover takes the
    replays below, on the card too.
    `logp0` (kernel path only) is the rollout's own logp, returned as the
    value while the gradient comes from the replay backward (the JAX custom
    VJP's primal).

    windowed (auto: on for rolling unbounded-height configs, kernel off):
    `_replay_logp_windowed`, which scores only the <= window observable
    tokens of each decode row. Otherwise the general replay differentiates
    the actor head over all N steps and all tokens (a window then enters
    through the recorded flags and the mask); `chunk` > 0 (0 = auto: at
    most ~40960 decode rows live) runs the step axis in chunks recomputed
    in the backward (torch.utils.checkpoint)."""
    dt = dtype
    if kernel is None:
        kernel = windowed is None and routes(
            cfg, record.action.is_cuda, actor.hidden, dtype=dt).replay
    if kernel:
        return _replay_logp_kernel(actor, instances, record, cfg,
                                   temperature, logp0, dt)
    if windowed is None:
        windowed = _use_windowed_head(cfg)
    if windowed:
        if cfg.window <= 0 or cfg.target_height != 0:
            raise ValueError("the windowed replay needs a rolling window and "
                             "an unbounded height (it rebuilds the mask from "
                             "the flags)")
        return _replay_logp_windowed(actor, instances, record, cfg,
                                     temperature, chunk, dt)
    return _replay_logp_general(actor, instances, record, cfg, temperature,
                                chunk, dt)


def replay_operands(actor, instances, record, cfg, grad: bool = True,
                    dtype=torch.float32):
    """The replay kernels' operands, batch-last: (flags, hms, masks, acts,
    statp, statm) from the record and the instances, and se [T, h, B], ctx
    [h, B] and the head operands from the actor, the float ones in the
    compute dtype `dtype` (v stays float32). With `grad`
    the embed_static_T chain, ctx = mean(se) and the head operands keep the
    autograd graph, so d_se, d_ctx and the weight gradients flow back into
    the actor's parameters."""
    dt = dtype
    B = record.action.shape[1]
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    T = N * cfg.num_rot
    static = static_tokens(instances, cfg)                    # [B, T, 4]
    static_t4 = static.permute(2, 1, 0).reshape(4, T * B)
    with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
        se_htb = embed_static_T(actor, static_t4, dt).reshape(-1, T, B)
        se = se_htb.permute(1, 0, 2).contiguous()             # [T, h, B]
        ctx = se_htb.mean(1).contiguous()                     # [h, B]
    data = (record.flags.int().transpose(1, 2).contiguous(),  # [S, N, B]
            record.heightmap.permute(0, 2, 3, 4, 1).reshape(
                N, C * W, D, B).int().contiguous(),
            record.mask.transpose(1, 2).int().contiguous(),   # [S, A, B]
            record.action.int().contiguous(),
            static_t4.to(dt).reshape(4, T, B).contiguous(),
            static.to(dt).mean(1).T.contiguous())
    return data, se, ctx, AS.head_operands(actor, cfg, dt, grad=grad)


def _replay_logp_kernel(actor, instances, record, cfg, temperature, logp0,
                        dtype):
    data, se, ctx, params = replay_operands(actor, instances, record, cfg,
                                            dtype=dtype)
    if logp0 is not None:
        logp0 = logp0.detach().float()
    return RP.ReplayLogp.apply(cfg, float(temperature), logp0, *data, se,
                               ctx, *params)


def _replay_logp_general(actor, instances, record, cfg, temperature, chunk,
                         dtype):
    N = cfg.num_blocks
    B = record.action.shape[1]
    if chunk <= 0:
        chunk = max(1, min(N, 40960 // max(B, 1)))
    while N % chunk:
        chunk -= 1
    static = static_tokens(instances, cfg)                    # [B, T, 4]
    static_emb = actor.embed_static(static, dtype)            # [B, T, h]
    ts = torch.arange(N, device=record.action.device)
    prev = torch.cat([torch.full_like(record.action[:1], -1),
                      record.action[:-1]], 0)

    def logp_steps(se, flags_c, hm_c, mask_c, act_c, prev_c, ts_c):
        """logp [K, B] of a slab of K decode steps."""
        K = ts_c.shape[0]
        if cfg.target_height == 0:
            mask_c = mask_from_flags(flags_c, instances, cfg)
        dynamic = merge_tokens(static, tokens_from_flags(
            flags_c, ts_c[:, None].float() / N, cfg))        # [K, B, T, 8]
        hmg = heightmap_grid(hm_c, cfg)                 # [K, B, C, W, D, 1]
        se_kb = se.expand((K,) + se.shape).reshape((K * B,) + se.shape[1:])
        logits = actor.head(se_kb, dynamic.flatten(0, 1), hmg.flatten(0, 1),
                            prev_c.flatten(0, 1), dtype).reshape(K, B, -1)
        masked = _masked_logits(logits, mask_c, temperature)
        lsm = torch.log_softmax(masked, dim=-1)
        onehot = (act_c.clamp(min=0).long()[..., None]
                  == torch.arange(masked.shape[-1], device=masked.device))
        lp = torch.where(onehot, lsm, 0.0).sum(-1)
        return torch.where(act_c >= 0, lp, 0.0)

    xs = (record.flags, record.heightmap, record.mask, record.action, prev,
          ts)
    if chunk >= N:
        return logp_steps(static_emb, *xs).sum(0)
    total = torch.zeros(B, device=record.action.device)
    for s0 in range(0, N, chunk):
        args = tuple(x[s0:s0 + chunk] for x in xs)
        total = total + checkpoint(
            lambda se, *a: logp_steps(se, *a).sum(0), static_emb, *args,
            use_reentrant=False)
    return total


def _replay_logp_windowed(actor, instances, record, cfg, temperature,
                          chunk: int, dtype):
    """Windowed replay: per decode row, gather the <= window observable
    blocks and compute logits for those tokens only.

    Every action outside the window is masked to -1e9 and exp(-1e9 - max)
    is exactly 0 in float32, so the full softmax's logp equals the softmax
    over the window's candidates alone. The head's only full-token inputs
    are ctx (per instance) and the mean merged token, which is exact
    bit-count arithmetic over the recorded flags (`_window_dsum`).

    The integer plan (which block sits in which slot, the candidates' mask,
    the chosen action's position) is built once for all N steps; the float
    pass runs over slabs of instances, recomputed in the backward
    (torch.utils.checkpoint) when the batch is cut. `chunk` counts decode
    steps as in the general replay: a slab holds chunk * B / N instances;
    0 = one slab while ~6 tensors of [B, N, Kw*R, h] stay under 8 GB, else
    slabs of ~163840 decode rows."""
    N, R_, C, Kw = (cfg.num_blocks, cfg.num_rot, cfg.num_containers,
                    cfg.window)
    B = record.action.shape[1]
    dev = record.action.device
    h = actor.hidden
    if chunk <= 0:
        est = B * N * Kw * R_ * h * dtype.itemsize * 6
        chunk = N if est <= 8e9 else max(1, min(N, 163840 // max(B, 1)))
    while N % chunk:
        chunk -= 1

    static = static_tokens(instances, cfg)                    # [B, T, 4]
    static_emb = actor.embed_static(static, dtype)            # [B, T, h]
    static = static.to(dtype)
    ctx = static_emb.mean(1)                                  # [B, h]
    stat_mean = static.mean(1)                                # [B, 4]
    se_bn = static_emb.reshape(B, N, R_ * h)
    static_pad = _pad_blocks(static.reshape(B, N, R_ * 4))
    ts = torch.arange(N, device=dev)
    t_frac = ts[:, None].float() / N                          # [N, 1]
    act = record.action
    prev = torch.cat([torch.full_like(act[:1], -1), act[:-1]], 0)

    # ---- the plan: every integer tensor of every step, built once
    f = record.flags.int()                                    # [N, B, Nb]
    win, rank, bidx, validw = _window_plan(f, Kw)             # [N, B, Kw]
    zero = torch.zeros_like(f[..., :1])
    gf = torch.cat([f, zero], -1).gather(-1, bidx)            # [N, B, Kw]
    static_g = _gather_blocks(static_pad, bidx)               # [N,B,Kw,R*4]
    merged = torch.cat([tokens_from_flags(gf, t_frac, cfg).to(dtype),
                        static_g.reshape(N, B, Kw * R_, 4)], -1)
    accr_g = ((gf >> 2) & 1).bool()
    per_rot = []
    for r in range(R_):
        d = E.rotated_dims_all(instances.dims, r, cfg)
        fits = ((d[..., 0] <= cfg.target_width)
                & (d[..., 1] <= cfg.target_depth))            # [B, N]
        fits_g = torch.cat([fits, torch.zeros_like(fits[:, :1])], 1).expand(
            N, B, N + 1).gather(-1, bidx)
        per_rot.append((validw if r == 0 else validw & accr_g) & fits_g)
    mask_g = torch.stack(per_rot, -1)[..., None].expand(
        N, B, Kw, R_, C).reshape(N, B, Kw * R_ * C)
    dsum = _window_dsum(f, win, t_frac, stat_mean[None], cfg)  # [N, B, 8]
    rc = R_ * C
    a0 = act.clamp(min=0).long()
    rank_a = rank.gather(-1, (a0 // rc)[..., None])[..., 0]   # [N, B]
    pos = (rank_a * rc + a0 % rc).clamp(0, Kw * rc - 1)

    def logp_rows(se_bn_c, ctx_c, bidx_c, merged_c, mask_c, dsum_c, hm_c,
                  prev_c, pos_c, act_c):
        """logp [Bc] of a slab of instances (step-major [N, Bc, ...])."""
        Bc = bidx_c.shape[1]
        se_g = _gather_blocks(_pad_blocks(se_bn_c), bidx_c).reshape(
            N * Bc, Kw * R_, h)
        hmg = heightmap_grid(hm_c, cfg).flatten(0, 1)
        ctx_ns = ctx_c.expand((N,) + ctx_c.shape).reshape(N * Bc, -1)
        scores = actor.head_ctx(se_g, merged_c.flatten(0, 1), hmg,
                                prev_c.flatten(0, 1), ctx_ns,
                                dsum_c.flatten(0, 1), dtype).reshape(N, Bc, -1)
        lsm = torch.log_softmax(_masked_logits(scores, mask_c, temperature),
                                -1)
        lp = lsm.gather(-1, pos_c[..., None])[..., 0]         # [N, Bc]
        return torch.where(act_c >= 0, lp, 0.0).sum(0)

    plan = (bidx, merged, mask_g, dsum, record.heightmap, prev, pos, act)
    bc = max(1, chunk * B // N if chunk < N else B)
    while B % bc:
        bc -= 1
    if bc >= B:
        return logp_rows(se_bn, ctx, *plan)
    parts = []
    for b0 in range(0, B, bc):
        sl = slice(b0, b0 + bc)
        parts.append(checkpoint(logp_rows, se_bn[sl], ctx[sl],
                                *(x[:, sl] for x in plan),
                                use_reentrant=False))
    return torch.cat(parts, 0)


# ------------------------------------------------------------------ #
# public API (eval / inference / tests)

def policy_rollout_batch(actor, instances: Instance, keys, cfg: TAPConfig,
                         greedy: bool = False, temperature: float = 1.0):
    """Batched (states, actions [B, N], rewards [B], logp_sum [B])."""
    states, record, logp = rollout_batch_record(
        actor, instances, keys, cfg, greedy, temperature)
    return states, record.action.T, E.reward(states, instances, cfg), logp


def policy_rollout(actor, instance: Instance, key, cfg: TAPConfig,
                   greedy: bool = False, temperature: float = 1.0):
    """Roll ONE instance (fields without the batch axis); returns
    (state, actions [N], reward, logp)."""
    batch = Instance(*(torch.as_tensor(x)[None] for x in instance))
    states, actions, rewards, logp = policy_rollout_batch(
        actor, batch, key[None], cfg, greedy, temperature)
    return (EnvState(*(x[0] for x in states)), actions[0], rewards[0],
            logp[0])


def policy_rollout_best_of(actor, instances: Instance, key, cfg: TAPConfig,
                           n_samples: int = 16, temperature: float = 1.0):
    """Best-of-K sampled decode: K sampled rollouts per instance in one
    K-times-wider batch, keeping each instance's best-reward trajectory.
    Returns (states, actions [B, N], rewards [B])."""
    B = instances.dims.shape[0]
    K = n_samples
    rep = Instance(*(x.repeat_interleave(K, dim=0) for x in instances))
    keys = R.split(key, B * K)
    states, record, _ = rollout_batch_record(
        actor, rep, keys, cfg, greedy=False, temperature=temperature,
        with_logp=False)
    rewards = E.reward(states, rep, cfg)
    best = torch.argmax(rewards.reshape(B, K), dim=1)
    rows = torch.arange(B, device=best.device) * K + best
    states_b = EnvState(*(x[rows] for x in states))
    return states_b, record.action.T[rows], rewards.reshape(B, K)[
        torch.arange(B, device=best.device), best]
