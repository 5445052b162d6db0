"""Policy rollouts: the batched decode loop, the port of the rollout half of
`tapnet_tpu/train/rollout.py`.

`rollout_batch_record` rolls a batch with the actor under `torch.no_grad()`
and returns (states, RolloutRecord, logp_sum). It picks a path as the JAX
package does:

- sampled decode on a CUDA device, for configs the actor kernel covers:
  `_rollout_record_actorfused`, one `actor_select_step` launch per step;
- otherwise on a CUDA device (greedy decode, or configs the actor kernel
  does not cover): `_rollout_record_stepfused`, the actor head as PyTorch
  ops and one `select_step` launch per step. Greedy decode stays off the
  actor kernel because it sits on argmax ties between duplicate blocks
  (SPEC.md §12);
- on the CPU: `_rollout_record_general`, the reference path.

`step_kernel` / `actor_kernel` force a path; on CPU tensors the kernel
wrappers run their plain versions, which is how the tests drive the fused
paths without a card. The decode loop is a Python loop over the N steps.
Sampling is gumbel-argmax with the JAX draws gumbel(fold_in(keys[b], t)),
so a seed samples the same trajectories on both sides.

`replay_logp_sum` is the differentiable half: sum_t log pi(a_t | s_t) of a
recorded rollout, through the replay kernel (`ops/replay.py`) on the card
or through autograd of `TAPNetActor.head` over all N steps on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.models.features import (dynamic_flags, heightmap_grid,
                                          mask_from_flags, merge_tokens,
                                          static_tokens, tokens_from_flags)
from tapnet_torch.models.tapnet import TAPNetActor, embed_static_T
from tapnet_torch.ops import actor_step as AS
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
    return torch.where(mask, logits / temperature,
                       torch.tensor(NEG, dtype=logits.dtype,
                                    device=logits.device))


def _gumbel_all(keys: torch.Tensor, cfg: TAPConfig) -> torch.Tensor:
    """All decode-step gumbel draws [N, B, A]: gumbel(fold_in(keys[b], t))."""
    ts = torch.arange(cfg.num_blocks, device=keys.device)
    kt = R.fold_in(keys[None, :, :], ts[:, None])             # [N, B, 2]
    return R.gumbel(kt, (cfg.num_actions,))


@torch.no_grad()
def rollout_batch_record(actor: TAPNetActor, instances: Instance,
                         keys: torch.Tensor, cfg: TAPConfig,
                         greedy: bool = False, temperature: float = 1.0,
                         with_logp: bool = True, step_kernel=None,
                         actor_kernel=None):
    """Roll a batch; returns (states, RolloutRecord, logp_sum [B])."""
    on_card = instances.dims.is_cuda
    if actor_kernel is None:
        actor_kernel = on_card and not greedy and AS.eligible(cfg)
    if actor_kernel:
        return _rollout_record_actorfused(actor, instances, keys, cfg,
                                          greedy, temperature, with_logp)
    if step_kernel is None:
        step_kernel = on_card
    if step_kernel:
        return _rollout_record_stepfused(actor, instances, keys, cfg,
                                         greedy, temperature, with_logp)
    return _rollout_record_general(actor, instances, keys, cfg, greedy,
                                   temperature, with_logp)


def _step_mask(flags, state, instances, cfg):
    if cfg.target_height == 0:
        return mask_from_flags(flags, instances, cfg)
    return E.action_mask(state, instances, cfg)


def _head_logits(actor, static, static_emb, flags, heightmap, prev, t, cfg):
    """Logits [B, A]; `t` steps taken, an int or an int tensor [B]."""
    t_frac = torch.as_tensor(t, device=flags.device).float() / cfg.num_blocks
    dynamic = merge_tokens(static, tokens_from_flags(flags, t_frac, cfg))
    return actor.head(static_emb, dynamic, heightmap_grid(heightmap, cfg),
                      prev)


def _log_softmax_at(masked, a):
    lsm = torch.log_softmax(masked, dim=-1)
    return lsm.gather(-1, a.clamp(min=0).long()[:, None])[:, 0]


def _rollout_record_general(actor, instances, keys, cfg, greedy,
                            temperature, with_logp):
    B = instances.dims.shape[0]
    dev = instances.dims.device
    state = E.reset(instances, cfg)
    static = static_tokens(instances, cfg)                   # [B, T, 4]
    static_emb = actor.embed_static(static)                  # [B, T, h]
    g_all = None if greedy else _gumbel_all(keys, cfg)
    prev = torch.full((B,), -1, dtype=torch.int32, device=dev)
    logp_sum = torch.zeros(B, device=dev)
    recs = []
    for t in range(cfg.num_blocks):
        flags = dynamic_flags(instances, state.packed, cfg)
        mask = _step_mask(flags, state, instances, cfg)
        logits = _head_logits(actor, static, static_emb, flags,
                              state.heightmap, prev, state.t, cfg)
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
                              temperature, with_logp):
    """Actor head as PyTorch ops; one `select_step` per decode step places
    the block on the batch-last env state."""
    B = instances.dims.shape[0]
    dev = instances.dims.device
    static = static_tokens(instances, cfg)
    static_emb = actor.embed_static(static)
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
        logits = _head_logits(actor, static, static_emb, flags, hm_b, prev,
                              t, cfg)
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
                               temperature, with_logp):
    """One `actor_select_step` per decode step: flags, mask, the head, the
    gumbel argmax, select/place and log pi in one launch. Only the static
    embedding and the gumbel sweep run as PyTorch ops."""
    B = instances.dims.shape[0]
    dev = instances.dims.device
    N, R_, A = cfg.num_blocks, cfg.num_rot, cfg.num_actions
    T = N * R_
    static = static_tokens(instances, cfg)                   # [B, T, 4]
    static_t4 = static.permute(2, 1, 0).reshape(4, T * B)    # [4, T*B]
    se_htb = embed_static_T(actor, static_t4).reshape(-1, T, B)
    se = se_htb.permute(1, 0, 2).contiguous()                # [T, h, B]
    ctx = se_htb.mean(1).contiguous()                        # [h, B]
    statp = static_t4.reshape(4, T, B).contiguous()
    statm = static.mean(1).T.contiguous()                    # [4, B]
    upm, rotm = AS.precedence_bitmasks(instances, cfg)
    fits = AS.fits_planes(instances, cfg)
    params = AS.head_operands(actor, cfg)
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
            se, ctx, statp, statm, params, cfg, temperature)
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
                    logp0=None) -> torch.Tensor:
    """Differentiable sum_t log pi(a_t | s_t) [B] of the recorded actions.

    kernel (auto: on for CUDA tensors): the replay kernel path,
    `_replay_logp_kernel`; on CPU tensors `kernel=True` runs the kernels'
    plain versions through the same autograd Function. On the card a
    config the kernel does not cover raises NotImplementedError; pass
    `kernel=False` for the general replay. `logp0` (kernel path only) is the
    rollout's own logp, returned as the value while the gradient comes from
    the replay backward (the JAX custom VJP's primal).

    The general replay (`kernel=False`) differentiates the actor head over
    all N steps and all tokens at once (a rolling window enters through the
    recorded flags and the mask; the JAX package's windowed replay, which
    scores only the window's tokens, is not ported); `chunk` > 0 (0 = auto:
    at most ~40960 decode rows live) runs the step axis in chunks
    recomputed in the backward (torch.utils.checkpoint)."""
    if kernel is None:
        kernel = record.action.is_cuda
    if kernel:
        return _replay_logp_kernel(actor, instances, record, cfg,
                                   temperature, logp0)
    return _replay_logp_general(actor, instances, record, cfg, temperature,
                                chunk)


def replay_operands(actor, instances, record, cfg, grad: bool = True):
    """The replay kernels' operands, batch-last: (flags, hms, masks, acts,
    statp, statm) from the record and the instances, and se [T, h, B], ctx
    [h, B] and the head operands from the actor. With `grad` the
    embed_static_T chain, ctx = mean(se) and the head operands keep the
    autograd graph, so d_se, d_ctx and the weight gradients flow back into
    the actor's parameters."""
    B = record.action.shape[1]
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    T = N * cfg.num_rot
    static = static_tokens(instances, cfg)                    # [B, T, 4]
    static_t4 = static.permute(2, 1, 0).reshape(4, T * B)
    with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
        se_htb = embed_static_T(actor, static_t4).reshape(-1, T, B)
        se = se_htb.permute(1, 0, 2).contiguous()             # [T, h, B]
        ctx = se_htb.mean(1).contiguous()                     # [h, B]
    data = (record.flags.int().transpose(1, 2).contiguous(),  # [S, N, B]
            record.heightmap.permute(0, 2, 3, 4, 1).reshape(
                N, C * W, D, B).int().contiguous(),
            record.mask.transpose(1, 2).int().contiguous(),   # [S, A, B]
            record.action.int().contiguous(),
            static_t4.reshape(4, T, B).contiguous(),
            static.mean(1).T.contiguous())
    return data, se, ctx, AS.head_operands(actor, cfg, grad=grad)


def _replay_logp_kernel(actor, instances, record, cfg, temperature, logp0):
    data, se, ctx, params = replay_operands(actor, instances, record, cfg)
    if logp0 is not None:
        logp0 = logp0.detach().float()
    return RP.ReplayLogp.apply(cfg, float(temperature), logp0, *data, se,
                               ctx, *params)


def _replay_logp_general(actor, instances, record, cfg, temperature, chunk):
    N = cfg.num_blocks
    B = record.action.shape[1]
    if chunk <= 0:
        chunk = max(1, min(N, 40960 // max(B, 1)))
    while N % chunk:
        chunk -= 1
    static = static_tokens(instances, cfg)                    # [B, T, 4]
    static_emb = actor.embed_static(static)                   # [B, T, h]
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
                            prev_c.flatten(0, 1)).reshape(K, B, -1)
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
