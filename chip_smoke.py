#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tapnet_torch/csrc/` (one nvcc per
source, all started at once), then runs, and fails on the first fault:

1. device: the card's name and power limit (nvidia-smi); TF32 off;
2. select_step (K1) vs its plain version: greedy rollouts of 2d-basic at
   batch 4096 and 2d-rot, 3d-basic, multi-container at batch 512 (plus
   2d-basic at a ragged batch of 100 and a capped lb-hard 2D config), every
   step through both on the same scores; every integer output equal;
3. actor_select_step (K2) vs its plain version: sampled rollouts of the same
   configs (less the capped one) at hidden 128, every step through both
   modes and the full plain version on the same inputs: the full mode's
   integer outputs equal, logits and logp within 1e-5; the main path's
   mode (live columns, no logits) integer outputs equal, logp within 1e-5;
4. the main path: `tapnet_torch.pack()` on 2d-basic, hidden 128, seeded
   weights: greedy and sample at batch 4096, best-of-16 on 256 instances;
   every instance complete, heightmaps replayed from the placements,
   rewards in (0, 3], the launch counters up by N per rollout, and a small
   batch agreeing with the CPU reference path;
5. times (CUDA events, median of 25): each kernel per launch, its plain
   version (K2: both modes, the live columns of the timed step, the bound
   over them and the all-token bound beside it, its registers and spills
   from ptxas), and a whole pack() per policy;
6. heightmap_reductions (K3) vs its plain version, bit-equal, on the final
   heightmaps of sampled rollouts (2d-basic at batch 4096, 3d-basic and
   multi-container at 512) and on all-zero heightmaps;
7. replay_logp forward and backward (K5) vs their plain versions on the
   card's own rollout records: 2d-basic at 4096, 2d-rot, 3d-basic,
   multi-container and multi-container-capped at 512, 2d-basic at a
   ragged 100, a padded 8-block config at temperature 0.7, a 3D and a 2D
   config with 4 containers at 512; values within
   1e-5 relative, every gradient within 5e-5 of the plain result's max
   magnitude (sums over instances in another order); two backward
   launches bit-identical; the forward against the rollout's own logp
   (the train step's primal) within the same value tolerance;
8. the train path: `init_train_state` + `make_train_step` on 2d-basic at
   hidden 128 and batch 4096 for 5 steps, the launch counts per step
   (actor_select_step 10, replay backward 1, heightmap_reductions 1,
   replay forward 0) and finite metrics; one step repeated from a copy of
   the state bit for bit; a step at batch 256 against the CPU reference
   path; `train()` for 2 epochs x 5 steps with metrics and checkpoints, and
   a resume from the epoch-1 checkpoint ending on the same params;
9. times: K3 and K5 per launch with their plain versions (K3 also against
   amax + sum; K5's bound over its live columns, the all-token bound
   beside it), and the whole train step (host clock, median of 10);
10. fused_rollout_batch (K4) vs its plain version, bit-equal on every state
   field, the actions and the rewards, for `first` and `random`: the six
   CONFIGS (2d-rolling too: 50 blocks, window 10, ragged block counts) and
   one case per remaining branch (lb-hard with rotation, two containers
   uncapped, a tight cap that strands blocks, capped with 2 and 3
   containers, 3D capped, a 3D rolling window, five mcs cases) at batch
   512, 2d-basic at a ragged 100 and at 4096;
11. select_step (K1) and actor_select_step (K2, both modes) under the mcs
   placement rule vs their plain versions, lockstep rollouts as in 2 and
   3, on a 2D mcs-soft and a 3D two-container mcs-hard config at batch
   512;
12. the heuristic main path: `pack(policy="first")` and `pack("random")` on
   each of the six CONFIGS at batch 4096: one K4 and one K3 launch per
   call, plans complete (or, under a cap, every unpacked block a no-op
   step), heightmaps replayed from the placements; then a repeated call
   bit-identical, the card against the `device="cpu"` path on every field
   at batch 256, and `evaluate(baselines=True)` against the CPU path;
13. times: K4 per launch for `random` on each of the six CONFIGS at batch
   4096 with the plain version beside it, and `pack(first)` /
   `pack(random)` on 2d-basic (host clock, median of 20);
14. actor_select_step (K2, both modes) with a rolling window and two
   precedence limbs vs its plain version, lockstep rollouts as in 3:
   2d-rolling (50 blocks,
   window 10), a 12-block window-4 config with rotation, a 34-block
   window-6 config (two limbs) and a 3D window config, at batch 512 and a
   ragged 100, 2d-rolling also at 4096;
15. the step-grid replay (K5f-steps, K5b-steps) vs its plain version on the
   same configs' records and a 4-container window config (tolerances of
   7), forced onto 2d-basic at 4096
   against the monolithic kernels, against the rollout's own logp, and two
   backward launches bit-identical;
16. the rolling main path, 2d-rolling at hidden 128: `pack()` greedy and
   sample at 4096, best-of-16 on 256 (K1 x50 per greedy call, K2 x50 per
   sampled one), plans complete and replayed, card vs CPU at 256; 3 train
   steps at batch 4096 (per step K2 50, K5b-steps 1, K3 1, no forward
   replay), a bit-identical repeat, a step at batch 64 against the CPU path,
   `train()` for 2 epochs x 2 steps with a resume; then one train step of
   multi-container-capped at batch 256 (K1 x10, K5b x1 on the recorded mask,
   K3 x1) against the CPU path;
17. times at 2d-rolling, batch 4096: K2 per launch (both modes, as in 5),
   K5f-steps and K5b-steps per call, each with its plain version and its
   bound counted over the (instance, step) pairs that have an action in
   this run (the token work over the live columns only, whose share it
   prints; the all-token bound beside it); `pack()` per policy and the
   train step (host clock);
18. past a kernel's coverage, the fallbacks the routers pick
   (`train.rollout.routes`) on the card: 2 train steps of 2d-basic at
   hidden 256, batch 256 (K1 x10 and K3 x1 per step, no K2, no K5: the
   general replay) and a step against the CPU path; sampled pack() at
   hidden 256 (K1 x10) against the CPU path; pack(first/random) on a
   17 x 16 3D target (no K4) equal to the CPU path; and K2, K5b, K1 and K4
   called directly outside their coverage raise NotImplementedError.

It prints the kernel table as one JSON line, then the nvidia-smi line, then
`{"ok": true, "device": {...}}` as the last line. Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
HIDDEN = 128
REPS = 25
TOL = 1e-5            # logits / logp, kernel vs plain (accumulation order)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)
F32_OPS_S = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)
# int32 adds, compares and max: the data sheet's f32 rate counts 2 operations
# per FMA on 128 lanes per SM; integer instructions run on 64 lanes per SM
# and count 1 each (132 SMs x 64 lanes x 1.98 GHz)
I32_OPS_S = F32_OPS_S / 4
B_MAIN = 4096          # the main paths' batch


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ #
# phases 2 and 3: kernels vs plain versions, lockstep rollouts

def _instances(cfg, B, dev, seed):
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch
    return sample_batch(R.key(seed, dev), B, cfg)


def _equal(name, got, want):
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"{name}: {bad} of {got.numel()} differ")


def check_select_step(cfg, B, actor, dev, keep=None):
    """Greedy rollout; at every step select_step and select_place_ref get
    the same scores and state and must agree on every output. Returns the
    operands of the middle step when `keep` is set (for timing)."""
    from tapnet_torch.models.features import dynamic_flags, static_tokens
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.train import rollout as RO
    from tapnet_torch.types import EnvState

    inst = _instances(cfg, B, dev, SEED + 1)
    static = static_tokens(inst, cfg)
    kept = None
    with torch.no_grad():
        se = actor.embed_static(static)
        (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
        prev = torch.full((B,), -1, dtype=torch.int32, device=dev)
        for t in range(cfg.num_blocks):
            hm_b = RO._hm_batch_major(hm, cfg)
            flags = dynamic_flags(inst, packed.T.bool(), cfg)
            mask = RO._step_mask(flags, EnvState(hm_b, packed.T.bool(), None,
                                                 None), inst, cfg)
            logits = RO._head_logits(actor, static, se, flags, hm_b, prev,
                                     t, cfg)
            score = RO._masked_logits(logits, mask, 1.0).T.contiguous()
            ops = (score, mask.T.int().contiguous(), packed, hm, plc,
                   dw, dd, dh)
            if keep and t == cfg.num_blocks // 2:
                kept = ops
            got = PS.select_step(*ops, cfg=cfg)
            want = PS.select_place_ref(cfg, *ops)
            for name, g, w in zip(("packed", "hm", "plc", "act"), got, want):
                _equal(f"select_step {name} step {t}", g, w)
            packed, hm, plc, prev = got
    if cfg.target_height == 0 and not bool(packed.bool().all()):
        raise AssertionError("select_step rollout left blocks unpacked")
    return kept


def actor_operands(actor, inst, cfg, keys):
    """Per-rollout operands of actor_select_step (as the rollout builds)."""
    from tapnet_torch.models.features import static_tokens
    from tapnet_torch.models.tapnet import embed_static_T
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO

    B = inst.dims.shape[0]
    T = cfg.num_blocks * cfg.num_rot
    static = static_tokens(inst, cfg)
    static_t4 = static.permute(2, 1, 0).reshape(4, T * B)
    se_htb = embed_static_T(actor, static_t4).reshape(-1, T, B)
    upm, rotm = AS.precedence_bitmasks(inst, cfg)
    g_all = RO._gumbel_all(keys, cfg).transpose(1, 2).contiguous()
    o = dict(se=se_htb.permute(2, 1, 0).contiguous(),
                ctx=se_htb.mean(1).contiguous(),
                statp=static_t4.reshape(4, T, B).contiguous(),
                statm=static.mean(1).T.contiguous(), upm=upm, rotm=rotm,
                fits=AS.fits_planes(inst, cfg),
                params=AS.head_operands(actor, cfg), g_all=g_all)
    o["params_t"] = AS.transposed(o["params"])
    return o


def check_actor_step(cfg, B, actor, dev, keep=None):
    """Sampled rollout; at every step both modes of actor_select_step and
    the full plain version get the same inputs. The full mode: integer
    outputs equal, logits and logp within TOL; the main path's mode
    (logits=False, live columns): integer outputs equal to the full plain
    version's, logp within TOL. The rollout advances on the main-path
    mode's outputs. Returns the middle step's operands when `keep` is set
    and the max logit/logp error."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO

    N = cfg.num_blocks
    inst = _instances(cfg, B, dev, SEED + 2)
    kept, err = None, 0.0
    names = ("packed", "hm", "plc", "act", "flags", "mask", "logits", "logp")
    with torch.no_grad():
        o = actor_operands(actor, inst, cfg, R.split(R.key(SEED + 3, dev), B))
        (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
        prev = torch.full((1, B), -1, dtype=torch.int32, device=dev)
        for t in range(N):
            tf = torch.full((1, 1), t, dtype=torch.float32, device=dev) / N
            ops = (tf, packed, hm, plc, prev, dw, dd, dh, o["upm"],
                   o["rotm"], o["fits"], o["g_all"][t], o["se"], o["ctx"],
                   o["statp"], o["statm"], o["params"])
            if keep and t == N // 2:
                kept = ops
            want = AS.actor_select_step_ref(*ops, cfg)
            for logits in (True, False):
                got = AS.actor_select_step(*ops, cfg, logits=logits,
                                           params_t=o["params_t"])
                what = f"actor_select_step(logits={logits})"
                for name, g, w in zip(names, got, want):
                    if name == "logits" and not logits:
                        if g is not None:
                            raise AssertionError(f"{what} returned logits")
                    elif name in ("logits", "logp"):
                        d = (g - w).abs()
                        lim = TOL + TOL * w.abs()
                        if not bool((d <= lim).all()):
                            raise AssertionError(
                                f"{what} {name} step {t}: max err "
                                f"{d.max().item()}")
                        err = max(err, d.max().item())
                    else:
                        _equal(f"{what} {name} step {t}", g, w)
            packed, hm, plc, prev = got[0], got[1], got[2], got[3][None]
    return kept, err


# ------------------------------------------------------------------ #
# phase 4: the main path

def replay_heightmaps(plan, dims, cfg):
    """Rebuild each heightmap from the plan's placements in transport order;
    every block must land on the footprint's maximum. dims int[B, N, 3]."""
    B = len(plan)
    C, W, D = cfg.num_containers, cfg.target_width, cfg.target_depth
    hm = np.zeros((B, C, W, D), np.int64)
    bi = np.arange(B)
    xs = np.arange(W)[None, :, None]
    ys = np.arange(D)[None, None, :]
    for a in plan.actions.T:
        live = a >= 0
        blk = np.maximum(a, 0) // (cfg.num_rot * C)
        c, r, x, y, z, _ = plan.states.placements[bi, blk].T
        d = dims[bi, blk]
        if cfg.dim == 2:
            w, dd, h = (np.where(r == 1, d[:, 2], d[:, 0]), d[:, 1],
                        np.where(r == 1, d[:, 0], d[:, 2]))
        else:
            w, dd, h = (np.where(r == 1, d[:, 1], d[:, 0]),
                        np.where(r == 1, d[:, 0], d[:, 1]), d[:, 2])
        fp = ((xs >= x[:, None, None]) & (xs < (x + w)[:, None, None])
              & (ys >= y[:, None, None]) & (ys < (y + dd)[:, None, None]))
        cur = hm[bi, c]
        land = np.where(fp, cur, 0).max(axis=(1, 2))
        if not np.array_equal(land[live], z[live]):
            raise AssertionError("a block does not land on its footprint")
        new = np.where(fp & live[:, None, None], (z + h)[:, None, None], cur)
        hm[bi, c] = new
    if not np.array_equal(hm, plan.states.heightmap):
        raise AssertionError("heightmaps disagree with the placements")


def check_plan(plan, inst, cfg, name):
    B = len(plan)
    if not all(plan.complete(i) for i in range(B)):
        raise AssertionError(f"{name}: incomplete plans")
    r = plan.rewards
    if not (np.isfinite(r).all() and (r > 0).all() and (r <= 3).all()):
        raise AssertionError(f"{name}: rewards outside (0, 3]")
    replay_heightmaps(plan, inst.dims.cpu().numpy(), cfg)
    log(f"  {name}: B={B} complete, heightmaps replayed, reward mean "
        f"{r.mean():.6f} min {r.min():.6f} max {r.max():.6f}")


def main_path(cfg, actor, dev):
    """pack() greedy / sample at 4096, best-of-16 on 256; returns the
    launch counts of the run and the plans."""
    from tapnet_torch import pack
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import policy_step as PS

    N = cfg.num_blocks
    inst = _instances(cfg, 4096, dev, SEED + 4)
    best_inst = inst.index(slice(0, 256))
    PS.select_step.launches = 0
    AS.actor_select_step.launches = 0
    runs = {}
    for policy, x, want in (("greedy", inst, (N, 0)),
                            ("sample", inst, (0, N)),
                            ("best", best_inst, (0, N))):
        s0, a0 = PS.select_step.launches, AS.actor_select_step.launches
        plan = pack(x, cfg, actor, policy=policy, key=SEED + 5,
                    n_samples=16)
        got = (PS.select_step.launches - s0,
               AS.actor_select_step.launches - a0)
        if got != want:
            raise AssertionError(f"pack({policy}) launches "
                                 f"(select_step, actor_select_step) = {got}, "
                                 f"expected {want}")
        runs[policy] = (plan, x)
    launches = {"select_step": PS.select_step.launches,
                "actor_select_step": AS.actor_select_step.launches}
    for policy, (plan, x) in runs.items():
        check_plan(plan, x, cfg, f"pack({policy})")
    return launches, inst


def check_against_cpu(cfg, actor, inst, dev):
    """A small batch: the card's kernel paths vs the CPU reference path."""
    from tapnet_torch import pack

    small = inst.index(slice(0, 256))
    actor_cpu = type(actor)(cfg, actor.hidden)
    actor_cpu.load_state_dict({k: v.cpu() for k, v in
                               actor.state_dict().items()})
    out = {}
    for policy in ("greedy", "sample"):
        a = pack(small, cfg, actor, policy=policy, key=SEED + 6)
        b = pack(small.to("cpu"), cfg, actor_cpu, policy=policy,
                 key=SEED + 6, device="cpu")
        same = (a.actions == b.actions).all(axis=1)
        frac = float(same.mean())
        if frac < 0.95:
            raise AssertionError(f"pack({policy}) card vs CPU: only {frac} "
                                 "of the trajectories agree")
        if not np.allclose(a.rewards[same], b.rewards[same], atol=1e-6):
            raise AssertionError(f"pack({policy}) rewards differ")
        out[policy] = frac
        log(f"  pack({policy}) B=256 card vs CPU reference: {frac:.4f} of "
            "trajectories equal, their rewards within 1e-6")
    return out


# ------------------------------------------------------------------ #
# phase 5: times

def time_gpu(fn, reps=REPS, sleep_cycles=2_000_000, warm=3):
    """Median device time of fn() in ms. Each rep first queues a spin kernel
    so the host has enqueued fn's launches before the start event runs:
    the event pair then brackets device time, not host overhead."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_host(fn, reps=REPS):
    """Median wall time of fn() ending in a synchronize, ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def actor_ops_count(cfg, B, h, tokens=None):
    """f32 operations of one actor_select_step on B instances: 2 per
    multiply-add of every matrix-vector product, plus tanh, the +v and the
    score adds of the attention (4 per (token, container, unit)).
    `tokens`: the (instance, token) columns to count for the token work
    instead of B * T (the live columns of the main path's mode)."""
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD, T = cfg.target_width * cfg.target_depth, N * R
    tokens = B * T if tokens is None else tokens
    enc = C * (h * (WD + 2) + h * h + h * (3 * h + 8))
    return 2 * B * enc + tokens * (2 * (32 * 8 + 32 * h) + C * h * 4)


def time_actor_step(ops, cfg, h, plain_reps=REPS, plain_sleep=100_000_000):
    """Both modes of K2 on one step's operands (CUDA events) and the full
    plain version; the bound of the main path's mode counted over its
    acting instances and live columns (bytes: every operand but the keys
    and the gumbel rows, the keys of the live columns, the gumbel of the
    valid actions, the outputs), the all-token bound beside it. Returns a
    dict."""
    from tapnet_torch.ops import actor_step as AS

    pt = AS.transposed(ops[16])  # as the decode loop: once per rollout
    ms = time_gpu(lambda: AS.actor_select_step(*ops, cfg, logits=False,
                                               params_t=pt))
    full = time_gpu(lambda: AS.actor_select_step(*ops, cfg, params_t=pt))
    plain = time_gpu(lambda: AS.actor_select_step_ref(*ops, cfg),
                     reps=plain_reps, sleep_cycles=plain_sleep)
    out = AS.actor_select_step(*ops, cfg, logits=False, params_t=pt)
    out_full = AS.actor_select_step(*ops, cfg, params_t=pt)
    B = ops[1].shape[1]
    b, _ = AS.live_columns(out[5], cfg)
    cols = int(b.numel())
    acting = int((out[3] >= 0).sum())
    valid = int((out[5] == 1).sum())
    se, g = ops[12], ops[11]
    rest = nbytes([x for i, x in enumerate(ops[:16]) if i not in (11, 12)])
    outs = nbytes([x for x in out if x is not None])
    live_b = rest + nbytes(ops[16]) + cols * h * 4 + valid * 4 + outs
    all_b = nbytes(ops[:16]) + nbytes(ops[16]) + nbytes(out_full)
    live_o = actor_ops_count(cfg, acting, h, cols)
    all_o = actor_ops_count(cfg, B, h)
    bound = max(1e3 * live_b / HBM_BYTES_S, 1e3 * live_o / F32_OPS_S)
    return {"ms": ms, "full_ms": full, "plain_ms": plain, "cols": cols,
            "acting": acting, "pairs": B * cfg.num_blocks * cfg.num_rot,
            "bytes": live_b, "ops": live_o, "bound": bound,
            "bound_by": ("operations" if live_o / F32_OPS_S
                         >= live_b / HBM_BYTES_S else "bytes"),
            "all_bound": max(1e3 * all_b / HBM_BYTES_S,
                             1e3 * all_o / F32_OPS_S),
            "all_ops": all_o, "se_bytes": nbytes([se]), "g_bytes":
            nbytes([g])}


def log_actor_times(tag, cfg, k):
    log(f"{tag} actor_select_step {cfg.num_blocks}-block step "
        f"{cfg.num_blocks // 2}: main-path mode (live columns) "
        f"{k['ms']:.4f} ms/launch, full mode {k['full_ms']:.4f} ms/launch "
        f"(plain {k['plain_ms']:.4f}); {k['acting']} instances act, "
        f"{k['cols']} of {k['pairs']} (instance, token) columns live; "
        f"{k['bytes']} B, {k['ops']} f32 ops over the live columns, bound "
        f"{k['bound']:.5f} ms ({k['bound_by']}); all tokens {k['all_ops']} "
        f"f32 ops, bound {k['all_bound']:.5f} ms")


# ------------------------------------------------------------------ #
# phase 6: heightmap_reductions (K3) vs its plain version

def check_reward(cfg, B, actor, dev):
    """K3 on the final heightmaps of a sampled rollout: bit-equal to the
    plain version. Returns the heightmaps."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import reward as RW
    from tapnet_torch.train import rollout as RO

    inst = _instances(cfg, B, dev, SEED + 8)
    states, _, _ = RO.rollout_batch_record(actor, inst,
                                           R.split(R.key(SEED + 9, dev), B),
                                           cfg)
    for hm in (states.heightmap, torch.zeros_like(states.heightmap)):
        got = RW.heightmap_reductions(hm)
        want = RW.heightmap_reductions_ref(hm)
        _equal("heightmap_reductions max", got[0], want[0])
        _equal("heightmap_reductions sum", got[1], want[1])
    return states.heightmap


# ------------------------------------------------------------------ #
# phase 7: replay_logp forward / backward (K5) vs their plain versions

GRAD_TOL = 5e-5       # K5b vs plain, of the plain result's max magnitude


def replay_operands(actor, cfg, B, dev, seed, temperature):
    """Replay operands in `replay_logp_fwd` order from a sampled rollout on
    the card at `temperature`, and the rollout's own logp [B]."""
    from tapnet_torch import random as R
    from tapnet_torch.train import rollout as RO

    inst = _instances(cfg, B, dev, seed)
    with torch.no_grad():
        _, rec, lp0 = RO.rollout_batch_record(
            actor, inst, R.split(R.key(seed + 1, dev), B), cfg,
            temperature=temperature)
        (flags, hms, masks, acts, statp, statm), se, ctx, params = \
            RO.replay_operands(actor, inst, rec, cfg, grad=False)
    return (flags, hms, masks, acts, se, ctx, statp, statm, params), lp0


def replay_fns(ops, cfg, temperature, steps):
    """(fwd, fwd plain, bwd(dlp), bwd plain(dlp)) of one schedule on the
    operands of `replay_operands`."""
    from tapnet_torch.ops import replay as RP

    if not steps:
        return (lambda: RP.replay_logp_fwd(*ops, cfg, temperature),
                lambda: RP.replay_logp_fwd_ref(*ops, cfg, temperature),
                lambda d: RP.replay_logp_bwd(d, *ops, cfg, temperature),
                lambda d: RP.replay_logp_bwd_ref(d, *ops, cfg, temperature))
    so = ops[:4] + (RP._prev_rows(ops[3]),) + ops[4:]
    return (lambda: RP.replay_logp_fwd_steps(*so, cfg, temperature),
            lambda: RP.replay_logp_fwd_steps_ref(*so, cfg, temperature),
            lambda d: RP.replay_logp_bwd_steps(d, *so, cfg, temperature),
            lambda d: RP.replay_logp_bwd_steps_ref(d, *so, cfg, temperature))


def _flat_grads(g):
    return [g[0], g[1], *g[2]]


GRAD_NAMES = ["d_se", "d_ctx"] + [f"d_params[{i}]" for i in range(11)]


def check_replay(cfg, B, actor, dev, temperature=1.0, repeat=False,
                 steps=False):
    """K5f values within 1e-5 relative and K5b outputs within GRAD_TOL of
    the plain results' max magnitude (`steps`: the step-grid kernels and
    their plain versions); with `repeat`, two K5b launches bit-identical;
    K5f also agrees with the rollout's own logp. Returns (operands, dlp,
    fwd max abs err, (bwd max scaled err, bwd max abs err), max abs diff of
    K5f and the rollout's logp)."""
    ops, lp0 = replay_operands(actor, cfg, B, dev, SEED + 10, temperature)
    fwd, fwd_ref, bwd, bwd_ref = replay_fns(ops, cfg, temperature, steps)
    what = "replay_logp_fwd_steps" if steps else "replay_logp_fwd"
    dlp = torch.linspace(-1.0, 1.0, B, device=dev)
    with torch.no_grad():
        got = fwd()
        want = fwd_ref()
        d = (got - want).abs()
        if not bool((d <= TOL * want.abs() + 1e-6).all()):
            raise AssertionError(f"{what}: max err {d.max().item()}")
        f_err = d.max().item()
        # the train step's value is the rollout's logp (the primal): the
        # rollout head and the replay head must agree on it
        d0 = (got - lp0).abs()
        if not bool((d0 <= TOL * lp0.abs() + 1e-5).all()):
            raise AssertionError(f"{what} vs the rollout's logp: max err "
                                 f"{d0.max().item()}")
        g1 = bwd(dlp)
        gr = bwd_ref(dlp)
        b_err = b_abs = 0.0
        for name, a, w in zip(GRAD_NAMES, _flat_grads(g1), _flat_grads(gr)):
            e = ((a - w).abs().max() / (w.abs().max() + 1e-12)).item()
            if not e <= GRAD_TOL:
                raise AssertionError(f"{what} backward {name}: scaled err "
                                     f"{e}")
            b_err = max(b_err, e)
            b_abs = max(b_abs, (a - w).abs().max().item())
        if repeat:
            g2 = bwd(dlp)
            for name, a, b in zip(GRAD_NAMES, _flat_grads(g1),
                                  _flat_grads(g2)):
                _equal(f"{what} backward repeat {name}", a, b)
    return ops, dlp, f_err, (b_err, b_abs), d0.max().item()


def check_steps_against_monolithic(ops, dlp, cfg):
    """The step-grid kernels forced onto a config the monolithic ones cover:
    the same value within TOL and the same gradients within GRAD_TOL."""
    fwd, _, bwd, _ = replay_fns(ops, cfg, 1.0, False)
    fwd_s, _, bwd_s, _ = replay_fns(ops, cfg, 1.0, True)
    with torch.no_grad():
        a, b = fwd(), fwd_s()
        d = (a - b).abs()
        if not bool((d <= TOL * a.abs() + 1e-6).all()):
            raise AssertionError("replay_logp_fwd_steps vs monolithic: max "
                                 f"err {d.max().item()}")
        worst = 0.0
        for name, x, y in zip(GRAD_NAMES, _flat_grads(bwd(dlp)),
                              _flat_grads(bwd_s(dlp))):
            e = ((x - y).abs().max() / (x.abs().max() + 1e-12)).item()
            if not e <= GRAD_TOL:
                raise AssertionError("replay_logp_bwd_steps vs monolithic "
                                     f"{name}: scaled err {e}")
            worst = max(worst, e)
    return d.max().item(), worst


def replay_ops_count(cfg, B, h, bwd, pairs=None, tokens=None):
    """f32 operations of the replay over B instances and N steps: per
    (instance, step) pair the encoder and the query, per token the dyn MLP
    and the attention (4 per (container, unit)), 2 per multiply-add; the
    backward adds the weight gradients, the input gradients of Wq (3h of
    its columns), W2 and Wp, and ~6 elementwise per (token, container,
    unit). `pairs`: the (instance, step) pairs to count instead of all
    B * N (a step without an action adds nothing); `tokens`: the
    (instance, step, token) triples to count for the token work instead of
    pairs * T (a token the mask rules out adds exact zeros)."""
    N, R_, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD, T = cfg.target_width * cfg.target_depth, N * R_
    FQ = 3 * h + 8
    pairs = B * N if pairs is None else pairs
    tokens = pairs * T if tokens is None else tokens
    enc = C * (h * (WD + 2) + h * h + h * FQ)
    fwd = pairs * 2 * enc + tokens * (2 * (32 * 8 + 32 * h) + C * h * 4)
    if not bwd:
        return fwd
    enc_grad = C * (h * FQ + h * h + h * (WD + 2)) + C * (h * 3 * h + h * h)
    tok_grad = (h * 32 + 32 * 8) + 32 * h
    return (fwd + pairs * 2 * enc_grad
            + tokens * (2 * tok_grad + C * h * 6))


def live_counts(cfg, masks, acts):
    """(pairs, triples): the (instance, step) pairs with an action and the
    (instance, step, token) triples among them whose mask allows the token
    in some container: the live columns of the replay kernels."""
    T, C = cfg.num_blocks * cfg.num_rot, cfg.num_containers
    live = ((masks.reshape(masks.shape[0], T, C, -1) == 1).any(2)
            & (acts >= 0)[:, None])
    return int((acts >= 0).sum()), int(live.sum())


# ------------------------------------------------------------------ #
# phase 8: the train path

def _state_dicts(ts):
    return {**{f"actor.{k}": v for k, v in ts.actor.state_dict().items()},
            **{f"critic.{k}": v for k, v in ts.critic.state_dict().items()}}


def train_counters():
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.ops import replay as RP
    from tapnet_torch.ops import reward as RW
    return {"select_step": PS.select_step,
            "actor_select_step": AS.actor_select_step,
            "replay_logp_bwd": RP.replay_logp_bwd,
            "replay_logp_fwd": RP.replay_logp_fwd,
            "replay_logp_bwd_steps": RP.replay_logp_bwd_steps,
            "replay_logp_fwd_steps": RP.replay_logp_fwd_steps,
            "heightmap_reductions": RW.heightmap_reductions}


def train_main_path(cfg, dev, per_step=None, n_steps=5, batch=B_MAIN,
                    hidden=HIDDEN):
    """init_train_state + `n_steps` steps of make_train_step(batch) on the
    card with the launch counts of every step held to `per_step` (default:
    the monolithic-replay route, actor_select_step N, replay_logp_bwd 1,
    heightmap_reductions 1, nothing else). Returns the counts, the state
    and the step."""
    from tapnet_torch import init_train_state, make_train_step

    ts = init_train_state(SEED, cfg, hidden=hidden, device=dev)
    step = make_train_step(cfg, batch=batch, hidden=hidden, device=dev)
    counters = train_counters()
    for f in counters.values():
        f.launches = 0
    want = dict.fromkeys(counters, 0)
    want.update(per_step or {"actor_select_step": cfg.num_blocks,
                             "replay_logp_bwd": 1,
                             "heightmap_reductions": 1})
    for i in range(n_steps):
        before = {k: f.launches for k, f in counters.items()}
        ts, m = step(ts)
        got = {k: f.launches - before[k] for k, f in counters.items()}
        if got != want:
            raise AssertionError(f"train step {i} launches {got}, expected "
                                 f"{want}")
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"train step {i}: metrics {vals}")
        log(f"  train step {i}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
    return {k: f.launches for k, f in counters.items()}, ts, step


def check_train_against_cpu(cfg, ts, dev, B=256, hidden=HIDDEN):
    """One step at batch B on the card and on the CPU reference path from
    the same state: instances equal, >= 95% of the trajectories equal,
    R/C/P/S exactly equal on those; then the whole step on both, the losses
    within 1e-4 relative when every trajectory agrees."""
    import copy

    from tapnet_torch import make_train_step
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.ops.reward import batched_reward_terms
    from tapnet_torch.train import reinforce as TR
    from tapnet_torch.train import rollout as RO

    gpu = copy.deepcopy(ts)
    cpu = TR.train_state(copy.deepcopy(ts.actor).cpu(),
                         copy.deepcopy(ts.critic).cpu(), ts.key.cpu())
    side = {}
    for name, st in (("card", gpu), ("cpu", cpu)):
        ks = R.split(st.key, 3)
        inst = sample_batch(ks[1], B, cfg)
        states, rec, _ = RO.rollout_batch_record(st.actor, inst,
                                                 R.split(ks[2], B), cfg)
        terms = batched_reward_terms(states.heightmap, states.placements,
                                     inst.dims)
        side[name] = (inst, rec.action.T, terms)
    for a, b in zip(side["card"][0], side["cpu"][0]):
        _equal("train instances card vs CPU", a.cpu(), b)
    same = (side["card"][1].cpu() == side["cpu"][1]).all(1)
    frac = same.float().mean().item()
    if frac < 0.95:
        raise AssertionError(f"train rollout card vs CPU: only {frac} of the "
                             "trajectories agree")
    for a, b in zip(side["card"][2], side["cpu"][2]):
        _equal("train R/C/P/S terms card vs CPU", a.cpu()[same], b[same])
    _, m_g = make_train_step(cfg, batch=B, hidden=hidden, device=dev)(gpu)
    _, m_c = make_train_step(cfg, batch=B, hidden=hidden, device="cpu")(cpu)
    diffs = {k: abs(float(m_g[k]) - float(m_c[k])) for k in m_g}
    if frac == 1.0:
        for k in ("loss_actor", "loss_critic"):
            if diffs[k] > 1e-4 * max(1.0, abs(float(m_c[k]))):
                raise AssertionError(f"train step card vs CPU: {k} differs "
                                     f"by {diffs[k]}")
    log(f"  train step B={B} card vs CPU: {frac:.4f} of trajectories equal, "
        f"their reward terms equal; |metric diff| {diffs}")
    return frac


def check_trainer(cfg, dev, tmp, spe=5):
    """train() for 2 epochs x `spe` steps writes metrics and checkpoints; a
    resume from the epoch-1 checkpoint ends on the same params."""
    import json
    import os
    import shutil

    from tapnet_torch import TrainLoopConfig, train
    from tapnet_torch.train import checkpoints as ckpt

    loop = TrainLoopConfig(epochs=2, steps_per_epoch=spe, batch=B_MAIN,
                           hidden=HIDDEN, valid_batch=B_MAIN,
                           ckpt_dir=os.path.join(tmp, "a"),
                           metrics_path=os.path.join(tmp, "a.jsonl"))
    full = train(cfg, loop, device=dev)
    lines = [json.loads(x) for x in open(loop.metrics_path)]
    epochs = [r for r in lines if "epoch" in r]
    if len(epochs) != 2 or not all(np.isfinite(r["loss_actor"])
                                   for r in epochs):
        raise AssertionError(f"train() metrics: {lines}")
    name = f"ckpt_{spe:08d}.pt"
    first = os.path.join(loop.ckpt_dir, name)
    resumed_dir = os.path.join(tmp, "b")
    os.makedirs(resumed_dir)
    shutil.copy(first, resumed_dir)
    with open(os.path.join(resumed_dir, "latest.json"), "w") as f:
        json.dump({"step": spe, "path": os.path.join(resumed_dir, name)}, f)
    loop_b = TrainLoopConfig(epochs=2, steps_per_epoch=spe, batch=B_MAIN,
                             hidden=HIDDEN, valid_batch=B_MAIN,
                             ckpt_dir=resumed_dir)
    resumed = train(cfg, loop_b, device=dev)
    a, b = _state_dicts(full), _state_dicts(resumed)
    for k in a:
        _equal(f"resumed params {k}", b[k], a[k])
    if not ckpt.latest_checkpoint(resumed_dir).endswith(
            f"ckpt_{2 * spe:08d}.pt"):
        raise AssertionError(f"resumed run wrote no step-{2 * spe} "
                             "checkpoint")
    rewards = [(r["step"], round(r["reward"], 6)) for r in epochs]
    log(f"  train(): epoch lines (step, reward) {rewards}, "
        f"valid_reward {epochs[-1]['valid_reward']:.6f}, "
        f"{epochs[-1]['env_steps_per_s']:.0f} env-steps/s; resume from "
        f"step {spe} ends on bit-identical params")


# ------------------------------------------------------------------ #
# phases 10-13: the heuristic whole-rollout kernel (K4) and the mcs rule

def heuristic_cases():
    """Configs beyond CONFIGS, one per branch of the rollout kernel."""
    from tapnet_torch import TAPConfig as T
    cube6 = dict(dim=3, container_width=6, container_depth=6,
                 container_height=6, target_width=6, target_depth=6)
    cube8 = dict(dim=3, container_width=8, container_depth=8,
                 container_height=8, target_width=8, target_depth=8)
    return {
        "2d-rot-lb-hard": T(allow_rot=True, reward_type="C+P+S-lb-hard"),
        "2d-two-containers": T(num_containers=2, container_height=20,
                               allow_rot=True),
        "2d-capped-tight": T(target_height=3, reward_type="C+P-lb-soft"),
        "2d-capped-mc": T(container_height=20, target_height=7,
                          num_containers=2, allow_rot=True),
        "2d-capped-3c": T(container_height=24, target_height=5,
                          num_containers=3, allow_rot=True),
        "3d-capped": T(**cube8, target_height=5, allow_rot=True),
        "3d-window": T(**cube6, num_blocks=16, min_blocks=8, window=4,
                       allow_rot=True),
        "2d-mcs-soft": T(reward_type="C+P+S-mcs-soft"),
        "2d-mcs-hard": T(allow_rot=True, reward_type="C+P-mcs-hard"),
        "3d-mcs-soft": T(**cube6, allow_rot=True,
                         reward_type="C+S-mcs-soft"),
        "3d-mcs-hard-multicont": T(**cube6, num_blocks=8, min_blocks=8,
                                   num_containers=2,
                                   reward_type="C+P+S-mcs-hard"),
        "3d-capped-mc-mcs": T(**cube6, target_height=4, num_containers=2,
                              allow_rot=True,
                              reward_type="C+P+S-mcs-hard"),
    }


def check_fused_rollout(cfg, B, dev, policy):
    """K4 against its plain version on the same instances and keys: every
    state field, the actions and the rewards bit-equal. Returns the number
    of no-op steps (blocks a cap stranded, and padding steps)."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import env as OE

    inst = _instances(cfg, B, dev, SEED + 20)
    keys = R.split(R.key(SEED + 21, dev), B)
    s_k, a_k, r_k = OE.fused_rollout_batch(inst, keys, cfg, policy)
    s_p, a_p, r_p = OE.fused_rollout_batch_ref(inst, keys, cfg, policy)
    for f in s_k._fields:
        _equal(f"fused_rollout_batch {policy} {f}", getattr(s_k, f),
               getattr(s_p, f))
    _equal(f"fused_rollout_batch {policy} actions", a_k, a_p)
    _equal(f"fused_rollout_batch {policy} rewards", r_k, r_p)
    return int((a_k < 0).sum())


def check_heuristic_plan(plan, inst, cfg, name):
    """A heuristic plan: complete without a cap; under a cap every block
    left unpacked is a no-op step. Heightmaps replayed from the placements,
    rewards in (0, 3]."""
    B = len(plan)
    stranded = int((~plan.states.packed).sum())
    if cfg.target_height == 0 and stranded:
        raise AssertionError(f"{name}: incomplete plans")
    real = inst.n_total.cpu().numpy()
    noop = (plan.actions < 0).sum(1) - (cfg.num_blocks - real)
    if not np.array_equal(noop, (~plan.states.packed).sum(1)):
        raise AssertionError(f"{name}: no-op steps and unpacked blocks "
                             "disagree")
    r = plan.rewards
    placed_any = (plan.actions >= 0).any(1)
    if not (np.isfinite(r).all() and (r[placed_any] > 0).all()
            and (r[~placed_any] == 0).all() and (r <= 3).all()):
        raise AssertionError(f"{name}: rewards outside (0, 3]")
    replay_heightmaps(plan, inst.dims.cpu().numpy(), cfg)
    log(f"  {name}: B={B}, {stranded} blocks stranded, heightmaps replayed, "
        f"reward mean {r.mean():.6f} min {r.min():.6f} max {r.max():.6f}")


def _plans_equal(name, a, b):
    for f in a.states._fields:
        if not np.array_equal(getattr(a.states, f), getattr(b.states, f)):
            raise AssertionError(f"{name}: {f} differs")
    if not (np.array_equal(a.actions, b.actions)
            and np.array_equal(a.rewards, b.rewards)):
        raise AssertionError(f"{name}: actions or rewards differ")


def heuristic_main_path(configs, dev):
    """pack(first) and pack(random) on every config at B_MAIN: one K4 and
    one K3 launch per call. Returns the launch counts of the run, the plans
    and the instances."""
    from tapnet_torch import pack
    from tapnet_torch.ops import env as OE
    from tapnet_torch.ops import reward as RW

    insts = {n: _instances(cfg, B_MAIN, dev, SEED + 22)
             for n, cfg in configs.items()}
    OE.fused_rollout_batch.launches = 0
    RW.heightmap_reductions.launches = 0
    plans = {}
    for name, cfg in configs.items():
        for policy in ("first", "random"):
            k4, k3 = (OE.fused_rollout_batch.launches,
                      RW.heightmap_reductions.launches)
            plans[name, policy] = pack(insts[name], cfg, policy=policy,
                                       key=SEED + 23)
            got = (OE.fused_rollout_batch.launches - k4,
                   RW.heightmap_reductions.launches - k3)
            if got != (1, 1):
                raise AssertionError(
                    f"pack({policy}) on {name}: launches (fused_rollout_batch"
                    f", heightmap_reductions) = {got}, expected (1, 1)")
    launches = {"fused_rollout_batch": OE.fused_rollout_batch.launches,
                "heightmap_reductions": RW.heightmap_reductions.launches}
    return launches, plans, insts


def check_heuristic_against_cpu(configs, insts, actor, dev):
    """Two card calls bit-identical; the card against the CPU path on every
    field at B=256; evaluate(baselines=True) on the card against the CPU."""
    from tapnet_torch import TrainLoopConfig, pack
    from tapnet_torch.train.trainer import evaluate

    for name, cfg in configs.items():
        small = insts[name].index(slice(0, 256))
        for policy in ("first", "random"):
            a = pack(small, cfg, policy=policy, key=SEED + 24)
            _plans_equal(f"pack({policy}) {name} repeated", a,
                         pack(small, cfg, policy=policy, key=SEED + 24))
            _plans_equal(f"pack({policy}) {name} card vs CPU", a,
                         pack(small.to("cpu"), cfg, policy=policy,
                              key=SEED + 24, device="cpu"))
        log(f"  pack(first/random) {name} B=256: two calls bit-identical, "
            "card == CPU path on every field")
    cfg = configs["2d-basic"]
    loop = TrainLoopConfig(valid_batch=256, hidden=HIDDEN)
    on_card = evaluate(actor, cfg, loop, baselines=True, device=dev)
    actor_cpu = type(actor)(cfg, actor.hidden)
    actor_cpu.load_state_dict({k: v.cpu() for k, v in
                               actor.state_dict().items()})
    on_cpu = evaluate(actor_cpu, cfg, loop, baselines=True, device="cpu")
    for k in ("random_reward", "first_reward"):
        a, b = float(on_card[k]), float(on_cpu[k])
        if not (np.isfinite(a) and abs(a - b) <= 1e-6):
            raise AssertionError(f"evaluate(baselines=True) {k}: card {a}, "
                                 f"CPU {b}")
    log("  evaluate(baselines=True) 2d-basic B=256: random_reward "
        f"{float(on_card['random_reward']):.6f}, first_reward "
        f"{float(on_card['first_reward']):.6f}, equal to the CPU path's "
        "within 1e-6")


def rollout_int_ops(cfg, ops, actions, plc):
    """int32 operations this run's rollouts need, counted from their own
    actions and placements: per step with an action, 2 per (block, graph) for
    accessibility, 1 per (block, rot) for the fit, 1 per block for the rank,
    and per offset the block may take a max and a compare per footprint cell
    plus 4 for the key and the running best (mcs: a sum per cell and ~24 for
    the fraction and its comparison). The placeability scans a finite cap
    adds to the mask are not counted."""
    N, R_, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    W, D = cfg.target_width, cfg.target_depth
    dw, dd, dh = (o.long() for o in ops[:3])                 # [N, B]
    live = actions >= 0
    blk = (actions.clamp(min=0) // (R_ * C)).long()          # [N, B]
    rot = plc.reshape(N, 6, -1)[:, 1].long().gather(0, blk)
    w0, d0, h0 = (x.gather(0, blk) for x in (dw, dd, dh))
    if cfg.dim == 2:
        w, d = torch.where(rot == 1, h0, w0), d0
    else:
        w, d = torch.where(rot == 1, d0, w0), torch.where(rot == 1, w0, d0)
    offsets = (W - w + 1) * (D - d + 1)
    per_offset = 2 * w * d + 4
    if cfg.placement_rule == "mcs":
        per_offset = per_offset + w * d + 24
    per_step = 2 * N * R_ + N * R_ + N + offsets * per_offset
    return int(torch.where(live, per_step, 0).sum())


def time_fused_rollout(cfg, B, dev):
    """K4 on prebuilt operands (`random` draws) and the plain loop on the
    same draws. Returns (ms, plain ms, bytes moved, int32 operations,
    max |kernel - plain| over the outputs)."""
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.ops import env as OE

    inst = _instances(cfg, B, dev, SEED + 25)
    rbits = E.policy_bits(R.split(R.key(SEED + 26, dev), B), cfg, "random")
    ops = OE.rollout_operands(inst, rbits, cfg)
    ms = time_gpu(lambda: OE.rollout_kernel(ops, cfg))
    plain = time_gpu(lambda: E.rollout_bits(inst, rbits, cfg), reps=3,
                     sleep_cycles=200_000_000)
    hm, packed, actions, plc = OE.rollout_kernel(ops, cfg)
    state, a_p = E.rollout_bits(inst, rbits, cfg)
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    err = max((actions.T - a_p).abs().max().item(),
              (hm.reshape(C, W, D, B).permute(3, 0, 1, 2)
               - state.heightmap).abs().max().item(),
              (plc.reshape(N, 6, B).permute(2, 0, 1)
               - state.placements).abs().max().item(),
              (packed.T - state.packed.int()).abs().max().item())
    moved = nbytes(ops) + nbytes((hm, packed, actions, plc))
    return ms, plain, moved, rollout_int_ops(cfg, ops, actions, plc), err


def rolling_cases():
    """Configs that need K2's window or its second precedence limb, and the
    step-grid replay."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import TAPConfig as T
    return {
        "2d-rolling": CONFIGS["2d-rolling"],
        "rolling-small": T(num_blocks=12, min_blocks=6, container_width=8,
                           container_height=12, target_width=8, window=4,
                           allow_rot=True),
        "two-limb": T(num_blocks=34, min_blocks=20, container_width=8,
                      container_height=40, target_width=8, window=6),
        "3d-window": heuristic_cases()["3d-window"],
    }


# ------------------------------------------------------------------ #
# phase 18: configs past a kernel's coverage take the fallbacks

def check_fallback_routes(dev):
    """On the card, configs a kernel does not cover run through the path
    `routes` picks instead, with the CPU path's results: a train step and
    sampled pack() at hidden 256 (past K2 and the replay kernels: K1 and
    the general replay), pack(first/random) on a 17 x 16 target (past K4,
    K1 and K2: the env's own rollout). The wrappers called directly
    outside their coverage still raise. Returns the launch counts of the
    run."""
    from tapnet_torch import CONFIGS, TAPConfig, pack
    from tapnet_torch import random as R
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import env as OE
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.ops import replay as RP
    from tapnet_torch.train import rollout as RO

    cfg, h = CONFIGS["2d-basic"], 256
    want = RO.Routes("step", False, True)
    if RO.routes(cfg, True, h) != want:
        raise AssertionError(f"routes at hidden {h}: "
                             f"{RO.routes(cfg, True, h)}")
    per_step = {"select_step": cfg.num_blocks, "heightmap_reductions": 1}
    counts, ts, _ = train_main_path(cfg, dev, per_step, n_steps=2, batch=256,
                                    hidden=h)
    log(f"phase 18 train step 2d-basic hidden {h} batch 256 (no K2, no K5): "
        f"launches (2 steps) {counts}")
    check_train_against_cpu(cfg, ts, dev, B=256, hidden=h)

    actor = init_params(SEED, cfg, h, dev)
    actor_cpu = type(actor)(cfg, h)
    actor_cpu.load_state_dict({k: v.cpu() for k, v in
                               actor.state_dict().items()})
    inst = _instances(cfg, 256, dev, SEED + 30)
    k1, k2 = PS.select_step.launches, AS.actor_select_step.launches
    a = pack(inst, cfg, actor, policy="sample", key=SEED + 31)
    got = (PS.select_step.launches - k1, AS.actor_select_step.launches - k2)
    if got != (cfg.num_blocks, 0):
        raise AssertionError(f"pack(sample) hidden {h}: launches "
                             f"(select_step, actor_select_step) = {got}")
    b = pack(inst.to("cpu"), cfg, actor_cpu, policy="sample", key=SEED + 31,
             device="cpu")
    same = (a.actions == b.actions).all(axis=1)
    if same.mean() < 0.95 or not np.allclose(a.rewards[same],
                                             b.rewards[same], atol=1e-6):
        raise AssertionError(f"pack(sample) hidden {h} card vs CPU: "
                             f"{same.mean()} of the trajectories agree")
    log(f"phase 18 pack(sample) 2d-basic hidden {h} B=256: select_step x"
        f"{got[0]}, actor_select_step x0; {same.mean():.4f} of the "
        "trajectories equal to the CPU path's, their rewards within 1e-6")

    wide = TAPConfig(dim=3, container_width=17, container_depth=16,
                     container_height=8, target_width=17, target_depth=16,
                     allow_rot=True)
    if RO.routes(wide, True, HIDDEN) != RO.Routes("general", True, False):
        raise AssertionError(f"routes on 17 x 16: {RO.routes(wide, True)}")
    inst_w = _instances(wide, 256, dev, SEED + 32)
    k4 = OE.fused_rollout_batch.launches
    for policy in ("first", "random"):
        plan = pack(inst_w, wide, policy=policy, key=SEED + 33)
        check_heuristic_plan(plan, inst_w, wide, f"phase 18 pack({policy}) "
                             "17 x 16 target (no K4)")
        _plans_equal(f"pack({policy}) 17 x 16 card vs CPU", plan,
                     pack(inst_w.to("cpu"), wide, policy=policy,
                          key=SEED + 33, device="cpu"))
    if OE.fused_rollout_batch.launches != k4:
        raise AssertionError("pack(first/random) on a 17 x 16 target "
                             "launched fused_rollout_batch")
    log("phase 18 pack(first/random) 17 x 16 target B=256: no K4 launch, "
        "plans equal to the CPU path's on every field")

    # the wrappers outside their coverage: NotImplementedError, no fallback
    keys = R.split(R.key(SEED + 34, dev), 256)
    o = actor_operands(actor, inst, cfg, keys)
    (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
    tf = torch.zeros((1, 1), device=dev)
    prev = torch.full((1, 256), -1, dtype=torch.int32, device=dev)
    ops_r, _ = replay_operands(actor, cfg, 256, dev, SEED + 35, 1.0)
    score = torch.zeros((wide.num_actions, 256), device=dev)
    _, packed_w, hm_w, plc_w = RO._batch_last(inst_w, wide)
    (dw_w, dd_w, dh_w), _, _, _ = RO._batch_last(inst_w, wide)
    refusals = {
        f"actor_select_step hidden {h}": lambda: AS.actor_select_step(
            tf, packed, hm, plc, prev, dw, dd, dh, o["upm"], o["rotm"],
            o["fits"], o["g_all"][0], o["se"], o["ctx"], o["statp"],
            o["statm"], o["params"], cfg, logits=False),
        f"replay_logp_bwd hidden {h}": lambda: RP.replay_logp_bwd(
            torch.zeros(256, device=dev), *ops_r, cfg),
        "select_step 17 x 16": lambda: PS.select_step(
            score, score.int(), packed_w, hm_w, plc_w, dw_w, dd_w, dh_w,
            wide),
        "fused_rollout_batch 17 x 16": lambda: OE.fused_rollout_batch(
            inst_w, keys, wide, "first"),
    }
    for name, call in refusals.items():
        try:
            call()
        except NotImplementedError:
            continue
        raise AssertionError(f"{name} did not raise")
    log("phase 18 called directly outside their coverage, "
        f"{', '.join(refusals)} raise NotImplementedError")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS, TAPConfig
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import policy_step as PS

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"phase 0 build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # the four serving configs, plus a ragged batch (not a multiple of the
    # kernels' tiles) and, for select_step, a capped lb-hard config
    configs = dict(CONFIGS)
    configs["2d-capped-hard"] = TAPConfig(allow_rot=True, target_height=12,
                                          reward_type="C+P+S-lb-hard")
    cases = [("2d-basic", 4096), ("2d-rot", 512), ("3d-basic", 512),
             ("multi-container", 512), ("2d-basic", 100)]
    actors = {n: init_params(SEED, configs[n], HIDDEN, dev)
              for n in ("2d-basic", "2d-rot", "3d-basic", "multi-container",
                        "2d-capped-hard")}
    kept_k1 = kept_k2 = None
    for name, B in cases + [("2d-capped-hard", 512)]:
        k = check_select_step(configs[name], B, actors[name], dev,
                              keep=(name, B) == ("2d-basic", 4096))
        kept_k1 = kept_k1 or k
        log(f"phase 2 select_step == plain: {name} B={B}, "
            f"{configs[name].num_blocks} steps")
    k2_err = 0.0
    for name, B in cases:
        k, err = check_actor_step(configs[name], B, actors[name], dev,
                                  keep=(name, B) == ("2d-basic", 4096))
        kept_k2 = kept_k2 or k
        k2_err = max(k2_err, err)
        log(f"phase 3 actor_select_step == plain: {name} B={B}, max "
            f"logit/logp err {err:.3e}")
    torch.cuda.synchronize()

    cfg = CONFIGS["2d-basic"]
    actor = actors["2d-basic"]
    launches, inst = main_path(cfg, actor, dev)
    log(f"phase 4 main path launches: {launches}")
    check_against_cpu(cfg, actor, inst, dev)

    # ---- phase 5: times at the main path's shapes (2d-basic, B=4096)
    k1_ms = time_gpu(lambda: PS.select_step(*kept_k1, cfg=cfg))
    k1_plain = time_gpu(lambda: PS.select_place_ref(cfg, *kept_k1),
                        sleep_cycles=50_000_000)
    k1_out = PS.select_step(*kept_k1, cfg=cfg)
    k1_bytes = nbytes(kept_k1) + nbytes(k1_out)
    k1_bound = 1e3 * k1_bytes / HBM_BYTES_S
    k1_err = 0.0
    for g, w in zip(k1_out, PS.select_place_ref(cfg, *kept_k1)):
        k1_err = max(k1_err, (g - w).abs().max().item())
    log(f"phase 5 select_step: {k1_ms:.4f} ms/launch (plain {k1_plain:.4f}),"
        f" {k1_bytes} B moved, bound {k1_bound:.4f} ms")
    k2 = time_actor_step(kept_k2, cfg, HIDDEN)
    log_actor_times("phase 5", cfg, k2)
    ptxas = _build.ptxas_report()
    for line in ptxas.splitlines():
        if line.startswith("actor_step.cu"):
            log(f"phase 5 ptxas {line}")

    from tapnet_torch import pack
    best_inst = inst.index(slice(0, 256))
    for policy, x in (("greedy", inst), ("sample", inst),
                      ("best", best_inst)):
        ms = time_host(lambda: pack(x, cfg, actor, policy=policy,
                                    key=SEED + 7, n_samples=16), reps=20)
        rows = x.dims.shape[0] * (16 if policy == "best" else 1)
        log(f"phase 5 pack({policy}): {ms:.3f} ms for {rows} rollouts x "
            f"{cfg.num_blocks} steps = {rows * cfg.num_blocks / ms * 1e3:.0f}"
            " env-steps/s")

    # ---- phase 6: K3 on final heightmaps of sampled rollouts
    from tapnet_torch.ops import reward as RW
    hm_main = check_reward(cfg, 4096, actor, dev)
    for name in ("3d-basic", "multi-container"):
        check_reward(configs[name], 512, actors[name], dev)
    log("phase 6 heightmap_reductions == plain, bit-equal: 2d-basic "
        "B=4096, 3d-basic and multi-container B=512, all-zero heightmaps")

    # ---- phase 7: K5 forward and backward on the card's own records
    from tapnet_torch.ops import replay as RP
    configs["padded"] = TAPConfig(num_blocks=8, min_blocks=4,
                                  container_width=8, container_height=8,
                                  target_width=8, allow_rot=True)
    configs["4-container"] = TAPConfig(
        dim=3, container_width=8, container_depth=8, container_height=8,
        target_width=8, target_depth=8, num_containers=4, allow_rot=True)
    configs["2d-4-container"] = TAPConfig(num_containers=4,
                                          container_height=20,
                                          allow_rot=True)
    for name in ("multi-container-capped", "padded", "4-container",
                 "2d-4-container"):
        actors[name] = init_params(SEED, configs[name], HIDDEN, dev)
    k5f_err = k5b_err = 0.0
    kept_k5 = None
    for name, B, temp in (("2d-basic", 4096, 1.0), ("2d-rot", 512, 1.0),
                          ("3d-basic", 512, 1.0),
                          ("multi-container", 512, 1.0),
                          ("multi-container-capped", 512, 1.0),
                          ("2d-basic", 100, 1.0), ("padded", 512, 0.7),
                          ("4-container", 512, 1.0),
                          ("2d-4-container", 512, 1.0)):
        main_shape = (name, B) == ("2d-basic", 4096)
        ops, dlp, fe, (be, ba), e0 = check_replay(
            configs[name], B, actors[name], dev, temp, repeat=main_shape)
        if main_shape:
            kept_k5 = (ops, dlp)
        k5f_err, k5b_err = max(k5f_err, fe), max(k5b_err, ba)
        log(f"phase 7 replay_logp == plain: {name} B={B} temperature "
            f"{temp}: fwd max err {fe:.3e}, bwd max err {ba:.3e} (scaled "
            f"{be:.3e}); fwd vs the rollout's logp {e0:.3e}"
            + ("; two bwd launches bit-identical" if main_shape else ""))
    torch.cuda.synchronize()

    # ---- phase 8: the train path
    from tapnet_torch.train.trainer import assert_deterministic
    train_launches, ts, step = train_main_path(cfg, dev)
    log(f"phase 8 train path launches (5 steps): {train_launches}")
    assert_deterministic(step, ts)
    log("phase 8 one train step run twice from a copy of one state: params, "
        "optimizer state, key and metrics bit-identical")
    check_train_against_cpu(cfg, ts, dev)
    with tempfile.TemporaryDirectory() as tmp:
        check_trainer(cfg, dev, tmp)

    # ---- phase 9: times of K3, K5 and the train step (2d-basic, B=4096)
    C = cfg.num_containers
    k3_ms = time_gpu(lambda: RW.heightmap_reductions(hm_main))
    k3_plain = time_gpu(lambda: RW.heightmap_reductions_ref(hm_main))
    k3_lib = time_gpu(lambda: (hm_main.amax((2, 3)), hm_main.sum((2, 3))))
    k3_bytes = nbytes([hm_main]) + 2 * 4 * B_MAIN * C
    k3_bound = 1e3 * k3_bytes / HBM_BYTES_S
    ops, dlp = kept_k5
    k5f_ms = time_gpu(lambda: RP.replay_logp_fwd(*ops, cfg))
    k5f_plain = time_gpu(lambda: RP.replay_logp_fwd_ref(*ops, cfg),
                         sleep_cycles=100_000_000)
    k5b_ms = time_gpu(lambda: RP.replay_logp_bwd(dlp, *ops, cfg))
    k5b_plain = time_gpu(lambda: RP.replay_logp_bwd_ref(dlp, *ops, cfg),
                         sleep_cycles=200_000_000)
    in_bytes = nbytes(ops[:8]) + nbytes(ops[8])
    d_se, d_ctx, d_par = RP.replay_logp_bwd(dlp, *ops, cfg)
    k5f_b = in_bytes + 4 * B_MAIN
    k5b_b = in_bytes + nbytes([dlp, d_se, d_ctx]) + nbytes(d_par)
    pairs, triples = live_counts(cfg, ops[2], ops[3])
    k5f_o = replay_ops_count(cfg, B_MAIN, HIDDEN, False, pairs, triples)
    k5b_o = replay_ops_count(cfg, B_MAIN, HIDDEN, True, pairs, triples)
    k5f_all = replay_ops_count(cfg, B_MAIN, HIDDEN, False)
    k5b_all = replay_ops_count(cfg, B_MAIN, HIDDEN, True)
    bound = lambda b, o, rate=F32_OPS_S: (
        max(1e3 * b / HBM_BYTES_S, 1e3 * o / rate),
        "operations" if o / rate >= b / HBM_BYTES_S else "bytes")
    k5f_bound, k5f_by = bound(k5f_b, k5f_o)
    k5b_bound, k5b_by = bound(k5b_b, k5b_o)
    log(f"phase 9 heightmap_reductions: {k3_ms:.4f} ms/launch (plain "
        f"{k3_plain:.4f}, library amax+sum {k3_lib:.4f}), {k3_bytes} B, "
        f"bound {k3_bound:.5f} ms")
    log(f"phase 9 replay live columns 2d-basic B={B_MAIN}: {pairs} "
        f"(instance, step) pairs with an action, {triples} of "
        f"{B_MAIN * cfg.num_blocks * cfg.num_blocks * cfg.num_rot} "
        "(instance, step, token) triples live")
    log(f"phase 9 replay_logp_fwd: {k5f_ms:.4f} ms/launch (plain "
        f"{k5f_plain:.4f}), {k5f_b} B, {k5f_o} f32 ops over live columns "
        f"({k5f_all} over all tokens), bound {k5f_bound:.4f} ms ({k5f_by}; "
        f"all tokens {bound(k5f_b, k5f_all)[0]:.4f})")
    log(f"phase 9 replay_logp_bwd: {k5b_ms:.4f} ms/launch (plain "
        f"{k5b_plain:.4f}), {k5b_b} B, {k5b_o} f32 ops over live columns "
        f"({k5b_all} over all tokens), bound {k5b_bound:.4f} ms ({k5b_by}; "
        f"all tokens {bound(k5b_b, k5b_all)[0]:.4f})")
    step_ms = time_host(lambda: step(ts), reps=10)
    log(f"phase 9 train step 2d-basic hidden {HIDDEN} batch {B_MAIN}: "
        f"{step_ms:.3f} ms/step = "
        f"{B_MAIN * cfg.num_blocks / step_ms * 1e3:.0f} env-steps/s")

    # ---- phase 10: K4 vs its plain version, bit-equal
    from tapnet_torch.ops import env as OE
    extra = heuristic_cases()
    k4_cases = ([(n, CONFIGS[n], 512) for n in CONFIGS]
                + [(n, c, 512) for n, c in extra.items()]
                + [("2d-basic", cfg, 100), ("2d-basic", cfg, B_MAIN)])
    for name, c4, B4 in k4_cases:
        noops = [check_fused_rollout(c4, B4, dev, policy)
                 for policy in ("first", "random")]
        log(f"phase 10 fused_rollout_batch == plain, bit-equal: {name} "
            f"B={B4}, first and random ({noops[0]} and {noops[1]} no-op "
            "steps)")
    torch.cuda.synchronize()

    # ---- phase 11: K1 and K2 under the mcs rule
    mcs_cases = {
        "2d-mcs-soft": extra["2d-mcs-soft"],
        "3d-mcs-hard-2c": TAPConfig(
            dim=3, container_width=6, container_depth=6, container_height=6,
            target_width=6, target_depth=6, num_containers=2, allow_rot=True,
            reward_type="C+P+S-mcs-hard")}
    for name, cm in mcs_cases.items():
        actor_m = init_params(SEED, cm, HIDDEN, dev)
        check_select_step(cm, 512, actor_m, dev)
        _, err = check_actor_step(cm, 512, actor_m, dev)
        k2_err = max(k2_err, err)
        log(f"phase 11 select_step and actor_select_step == plain under "
            f"mcs: {name} B=512, max logit/logp err {err:.3e}")
    torch.cuda.synchronize()

    # ---- phase 12: the heuristic main path
    heur_launches, plans, insts = heuristic_main_path(CONFIGS, dev)
    log(f"phase 12 heuristic main path launches (12 pack calls): "
        f"{heur_launches}")
    for (name, policy), plan in plans.items():
        check_heuristic_plan(plan, insts[name], CONFIGS[name],
                             f"pack({policy}) {name}")
    check_heuristic_against_cpu(CONFIGS, insts, actor, dev)

    # ---- phase 13: times of K4 and of pack(first/random)
    k4 = {}
    for name, c4 in CONFIGS.items():
        k4[name] = time_fused_rollout(c4, B_MAIN, dev)
        ms, plain, moved, iops, _ = k4[name]
        log(f"phase 13 fused_rollout_batch {name} B={B_MAIN} random: "
            f"{ms:.4f} ms/launch (plain {plain:.3f}), {moved} B, {iops} "
            f"int32 ops, bound "
            f"{1e3 * max(moved / HBM_BYTES_S, iops / I32_OPS_S):.5f} ms = "
            f"{B_MAIN * c4.num_blocks / ms * 1e3:.0f} env-steps/s")
    k4_ms, k4_plain, k4_bytes, k4_iops, k4_err = k4["2d-basic"]
    k4_bound, k4_by = bound(k4_bytes, k4_iops, I32_OPS_S)
    for policy in ("first", "random"):
        ms = time_host(lambda: pack(insts["2d-basic"], cfg, policy=policy,
                                    key=SEED + 7), reps=20)
        log(f"phase 13 pack({policy}): {ms:.3f} ms for {B_MAIN} rollouts x "
            f"{cfg.num_blocks} steps = "
            f"{B_MAIN * cfg.num_blocks / ms * 1e3:.0f} env-steps/s")

    # ---- phase 14: K2 with a rolling window / two precedence limbs
    roll = rolling_cases()
    roll_actors = {n: init_params(SEED, c, HIDDEN, dev)
                   for n, c in roll.items()}
    rcfg, ractor = roll["2d-rolling"], roll_actors["2d-rolling"]
    kept_k2r = None
    for name, Br in ([(n, b) for n in roll for b in (512, 100)]
                     + [("2d-rolling", B_MAIN)]):
        k, err = check_actor_step(roll[name], Br, roll_actors[name], dev,
                                  keep=(name, Br) == ("2d-rolling", B_MAIN))
        kept_k2r = kept_k2r or k
        k2_err = max(k2_err, err)
        log(f"phase 14 actor_select_step == plain (window {roll[name].window}"
            f", {AS._num_limbs(roll[name].num_blocks)} limb(s)): {name} "
            f"B={Br}, {roll[name].num_blocks} steps, max logit/logp err "
            f"{err:.3e}")
    torch.cuda.synchronize()

    # ---- phase 15: the step-grid replay on the card's own records
    k5fs_err = k5bs_err = 0.0
    kept_k5s = None
    # plus four containers under a rolling window
    roll_k5 = dict(roll, **{"rolling-4c": TAPConfig(
        num_blocks=12, min_blocks=6, container_width=8, container_height=12,
        target_width=8, window=4, num_containers=4, allow_rot=True)})
    k5_actors = dict(roll_actors, **{"rolling-4c": init_params(
        SEED, roll_k5["rolling-4c"], HIDDEN, dev)})
    for name, Br in ([(n, b) for n in roll_k5 for b in (512, 100)]
                     + [("2d-rolling", B_MAIN)]):
        main_shape = (name, Br) == ("2d-rolling", B_MAIN)
        ops_s, dlp_s, fe, (be, ba), e0 = check_replay(
            roll_k5[name], Br, k5_actors[name], dev, repeat=main_shape,
            steps=True)
        if main_shape:
            kept_k5s = (ops_s, dlp_s)
        k5fs_err, k5bs_err = max(k5fs_err, fe), max(k5bs_err, ba)
        log(f"phase 15 step-grid replay == plain: {name} B={Br} "
            f"({RP.step_chunks(roll_k5[name], Br)} step chunks): fwd max err "
            f"{fe:.3e}, bwd max err {ba:.3e} (scaled {be:.3e}); fwd vs the "
            f"rollout's logp {e0:.3e}"
            + ("; two bwd launches bit-identical" if main_shape else ""))
    fe, be = check_steps_against_monolithic(*kept_k5, cfg)
    log(f"phase 15 step-grid replay forced onto 2d-basic B={B_MAIN} == "
        f"monolithic kernels: fwd max err {fe:.3e}, bwd max scaled err "
        f"{be:.3e}")
    torch.cuda.synchronize()

    # ---- phase 16: the rolling main path (2d-rolling, hidden 128)
    roll_launches, rinst = main_path(rcfg, ractor, dev)
    log(f"phase 16 rolling main path launches: {roll_launches}")
    check_against_cpu(rcfg, ractor, rinst, dev)
    roll_step = {"actor_select_step": rcfg.num_blocks,
                 "replay_logp_bwd_steps": 1, "heightmap_reductions": 1}
    roll_train, rts, rstep = train_main_path(rcfg, dev, roll_step, n_steps=3)
    log(f"phase 16 rolling train path launches (3 steps): {roll_train}")
    assert_deterministic(rstep, rts)
    log("phase 16 one rolling train step run twice from a copy of one "
        "state: params, optimizer state, key and metrics bit-identical")
    check_train_against_cpu(rcfg, rts, dev, B=64)
    with tempfile.TemporaryDirectory() as tmp:
        check_trainer(rcfg, dev, tmp, spe=2)
    ccfg = CONFIGS["multi-container-capped"]
    capped_step = {"select_step": ccfg.num_blocks, "replay_logp_bwd": 1,
                   "heightmap_reductions": 1}
    capped_train, cts, _ = train_main_path(ccfg, dev, capped_step, n_steps=1,
                                           batch=256)
    log(f"phase 16 capped train step (multi-container-capped, batch 256) "
        f"launches: {capped_train}")
    check_train_against_cpu(ccfg, cts, dev)

    # ---- phase 17: times at 2d-rolling, batch 4096
    k2r = time_actor_step(kept_k2r, rcfg, HIDDEN, plain_reps=5,
                          plain_sleep=200_000_000)
    log_actor_times("phase 17", rcfg, k2r)
    ops_s, dlp_s = kept_k5s
    fwd_s, fwd_s_ref, bwd_s, bwd_s_ref = replay_fns(ops_s, rcfg, 1.0, True)
    k5fs_ms = time_gpu(fwd_s, reps=10)
    k5fs_plain = time_gpu(fwd_s_ref, reps=2, sleep_cycles=400_000_000,
                          warm=1)
    k5bs_ms = time_gpu(lambda: bwd_s(dlp_s), reps=10)
    k5bs_plain = time_gpu(lambda: bwd_s_ref(dlp_s), reps=2,
                          sleep_cycles=400_000_000, warm=1)
    pairs, triples = live_counts(rcfg, ops_s[2], ops_s[3])
    T_r = rcfg.num_blocks * rcfg.num_rot
    log(f"phase 17 replay live columns 2d-rolling B={B_MAIN}: {pairs} of "
        f"{B_MAIN * rcfg.num_blocks} (instance, step) pairs with an action, "
        f"{triples} of {B_MAIN * rcfg.num_blocks * T_r} (instance, step, "
        f"token) triples live = "
        f"{triples / (B_MAIN * rcfg.num_blocks * T_r):.6f}")
    in_bytes_s = nbytes(ops_s[:8]) + nbytes(ops_s[8]) + nbytes([ops_s[3]])
    d_se, d_ctx, d_par = bwd_s(dlp_s)
    k5fs_b = in_bytes_s + 4 * B_MAIN
    k5bs_b = in_bytes_s + nbytes([dlp_s, d_se, d_ctx]) + nbytes(d_par)
    del d_se, d_ctx, d_par
    k5fs_o = replay_ops_count(rcfg, B_MAIN, HIDDEN, False, pairs, triples)
    k5bs_o = replay_ops_count(rcfg, B_MAIN, HIDDEN, True, pairs, triples)
    k5fs_all = replay_ops_count(rcfg, B_MAIN, HIDDEN, False)
    k5bs_all = replay_ops_count(rcfg, B_MAIN, HIDDEN, True)
    k5fs_bound, k5fs_by = bound(k5fs_b, k5fs_o)
    k5bs_bound, k5bs_by = bound(k5bs_b, k5bs_o)
    scratch = RP.scratch_bytes(rcfg, B_MAIN, HIDDEN)
    log(f"phase 17 replay_logp_fwd_steps 2d-rolling B={B_MAIN}: "
        f"{k5fs_ms:.4f} ms/call (plain {k5fs_plain:.3f}), {k5fs_b} B, "
        f"{k5fs_o} f32 ops over the live columns ({k5fs_all} over all "
        f"pairs and tokens), bound {k5fs_bound:.4f} ms ({k5fs_by}; all "
        f"tokens {bound(k5fs_b, k5fs_all)[0]:.4f})")
    log(f"phase 17 replay_logp_bwd_steps 2d-rolling B={B_MAIN}: "
        f"{k5bs_ms:.4f} ms/call (plain {k5bs_plain:.3f}), {k5bs_b} B, "
        f"{k5bs_o} f32 ops over the live columns ({k5bs_all} over all "
        f"pairs and tokens), bound {k5bs_bound:.4f} ms ({k5bs_by}; all "
        f"tokens {bound(k5bs_b, k5bs_all)[0]:.4f}); scratch {scratch}")
    rbest = rinst.index(slice(0, 256))
    for policy, x in (("greedy", rinst), ("sample", rinst),
                      ("best", rbest)):
        ms = time_host(lambda: pack(x, rcfg, ractor, policy=policy,
                                    key=SEED + 7, n_samples=16), reps=5)
        rows = x.dims.shape[0] * (16 if policy == "best" else 1)
        log(f"phase 17 pack({policy}) 2d-rolling: {ms:.3f} ms for {rows} "
            f"rollouts x {rcfg.num_blocks} steps = "
            f"{rows * rcfg.num_blocks / ms * 1e3:.0f} env-steps/s")
    rstep_ms = time_host(lambda: rstep(rts), reps=5)
    log(f"phase 17 train step 2d-rolling hidden {HIDDEN} batch {B_MAIN}: "
        f"{rstep_ms:.3f} ms/step = "
        f"{B_MAIN * rcfg.num_blocks / rstep_ms * 1e3:.0f} env-steps/s")

    # ---- phase 18: past a kernel's coverage, the fallbacks on the card
    fallback = check_fallback_routes(dev)

    kernels = [
        {"name": "select_step", "route": "cuda",
         "source": "tapnet_torch/csrc/policy_step.cu",
         "replaces": "tapnet_tpu/ops/pallas_policy_step.py:298",
         "launches": (launches["select_step"] + roll_launches["select_step"]
                      + capped_train["select_step"]),
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "actor_select_step", "route": "cuda",
         "source": "tapnet_torch/csrc/actor_step.cu",
         "replaces": "tapnet_tpu/ops/pallas_actor_step.py:316",
         "launches": (launches["actor_select_step"]
                      + train_launches["actor_select_step"]
                      + roll_launches["actor_select_step"]
                      + roll_train["actor_select_step"]),
         "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "reward_reductions", "route": "cuda",
         "source": "tapnet_torch/csrc/reward.cu",
         "replaces": "tapnet_tpu/ops/pallas_reward.py:39",
         "launches": (train_launches["heightmap_reductions"]
                      + heur_launches["heightmap_reductions"]
                      + roll_train["heightmap_reductions"]
                      + capped_train["heightmap_reductions"]),
         "max_abs_err": 0.0, "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound, "bound_by": "bytes", "library_ms": k3_lib},
        {"name": "fused_rollout_batch", "route": "cuda",
         "source": "tapnet_torch/csrc/env.cu",
         "replaces": "tapnet_tpu/ops/pallas_env.py:669",
         "launches": heur_launches["fused_rollout_batch"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None},
        {"name": "replay_logp_fwd", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:562",
         "launches": train_launches["replay_logp_fwd"],
         "max_abs_err": k5f_err, "ms": k5f_ms, "plain_ms": k5f_plain,
         "bound_ms": k5f_bound, "bound_by": k5f_by, "library_ms": None},
        {"name": "replay_logp_bwd", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:610",
         "launches": (train_launches["replay_logp_bwd"]
                      + capped_train["replay_logp_bwd"]),
         "max_abs_err": k5b_err, "ms": k5b_ms, "plain_ms": k5b_plain,
         "bound_ms": k5b_bound, "bound_by": k5b_by, "library_ms": None},
        {"name": "replay_logp_fwd_steps", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:582",
         "launches": roll_train["replay_logp_fwd_steps"],
         "max_abs_err": k5fs_err, "ms": k5fs_ms, "plain_ms": k5fs_plain,
         "bound_ms": k5fs_bound, "bound_by": k5fs_by, "library_ms": None},
        {"name": "replay_logp_bwd_steps", "route": "cuda",
         "source": "tapnet_torch/csrc/replay.cu",
         "replaces": "tapnet_tpu/ops/pallas_replay.py:635",
         "launches": roll_train["replay_logp_bwd_steps"],
         "max_abs_err": k5bs_err, "ms": k5bs_ms, "plain_ms": k5bs_plain,
         "bound_ms": k5bs_bound, "bound_by": k5bs_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
