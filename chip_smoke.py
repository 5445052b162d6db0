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
   configs (less the capped one) at hidden 128, every step through both on
   the same inputs; integer outputs equal, logits and logp within 1e-5;
4. the main path: `tapnet_torch.pack()` on 2d-basic, hidden 128, seeded
   weights: greedy and sample at batch 4096, best-of-16 on 256 instances;
   every instance complete, heightmaps replayed from the placements,
   rewards in (0, 3], the launch counters up by N per rollout, and a small
   batch agreeing with the CPU reference path;
5. times (CUDA events, median of 25): each kernel per launch, its plain
   version, and a whole pack() per policy.

It prints the kernel table as one JSON line, then the nvidia-smi line, then
`{"ok": true, "device": {...}}` as the last line. Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HIDDEN = 128
REPS = 25
TOL = 1e-5            # logits / logp, kernel vs plain (accumulation order)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)
F32_OPS_S = 67e12      # H100 SXM f32 outside the tensor cores (data sheet)


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
    return dict(se=se_htb.permute(1, 0, 2).contiguous(),
                ctx=se_htb.mean(1).contiguous(),
                statp=static_t4.reshape(4, T, B).contiguous(),
                statm=static.mean(1).T.contiguous(), upm=upm, rotm=rotm,
                fits=AS.fits_planes(inst, cfg),
                params=AS.head_operands(actor, cfg), g_all=g_all)


def check_actor_step(cfg, B, actor, dev, keep=None):
    """Sampled rollout; at every step actor_select_step and its plain
    version get the same inputs: integer outputs equal, logits and logp
    within TOL. Returns the middle step's operands when `keep` is set."""
    from tapnet_torch import random as R
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO

    N = cfg.num_blocks
    inst = _instances(cfg, B, dev, SEED + 2)
    kept, err = None, 0.0
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
            got = AS.actor_select_step(*ops, cfg)
            want = AS.actor_select_step_ref(*ops, cfg)
            names = ("packed", "hm", "plc", "act", "flags", "mask",
                     "logits", "logp")
            for name, g, w in zip(names, got, want):
                if name in ("logits", "logp"):
                    d = (g - w).abs()
                    lim = TOL + TOL * w.abs()
                    if not bool((d <= lim).all()):
                        raise AssertionError(
                            f"actor_select_step {name} step {t}: max err "
                            f"{d.max().item()}")
                    err = max(err, d.max().item())
                else:
                    _equal(f"actor_select_step {name} step {t}", g, w)
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

def time_gpu(fn, reps=REPS, sleep_cycles=2_000_000):
    """Median device time of fn() in ms. Each rep first queues a spin kernel
    so the host has enqueued fn's launches before the start event runs:
    the event pair then brackets device time, not host overhead."""
    for _ in range(3):
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


def actor_ops_count(cfg, B, h):
    """f32 operations of one actor_select_step on B instances: 2 per
    multiply-add of every matrix-vector product, plus tanh, the +v and the
    score adds of the attention (4 per (token, container, unit))."""
    N, R, C = cfg.num_blocks, cfg.num_rot, cfg.num_containers
    WD, T = cfg.target_width * cfg.target_depth, N * R
    macs = C * (h * (WD + 2) + h * h + h * (3 * h + 8)) + T * (32 * 8 + 32 * h)
    return B * (2 * macs + T * C * h * 4)


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
    k2_ms = time_gpu(lambda: AS.actor_select_step(*kept_k2, cfg))
    k2_plain = time_gpu(lambda: AS.actor_select_step_ref(*kept_k2, cfg),
                        sleep_cycles=100_000_000)
    k1_out = PS.select_step(*kept_k1, cfg=cfg)
    k2_out = AS.actor_select_step(*kept_k2, cfg)
    B = 4096
    k1_bytes = nbytes(kept_k1) + nbytes(k1_out)
    k2_bytes = (nbytes(kept_k2[:16]) + nbytes(kept_k2[16])
                + nbytes(k2_out))
    k2_ops = actor_ops_count(cfg, B, HIDDEN)
    k1_bound = 1e3 * k1_bytes / HBM_BYTES_S
    k2_bound_b = 1e3 * k2_bytes / HBM_BYTES_S
    k2_bound_o = 1e3 * k2_ops / F32_OPS_S
    k1_err = 0.0
    for g, w in zip(k1_out, PS.select_place_ref(cfg, *kept_k1)):
        k1_err = max(k1_err, (g - w).abs().max().item())
    log(f"phase 5 select_step: {k1_ms:.4f} ms/launch (plain {k1_plain:.4f}),"
        f" {k1_bytes} B moved, bound {k1_bound:.4f} ms")
    log(f"phase 5 actor_select_step: {k2_ms:.4f} ms/launch (plain "
        f"{k2_plain:.4f}), {k2_bytes} B, {k2_ops} f32 ops, bound "
        f"{max(k2_bound_b, k2_bound_o):.4f} ms")

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

    kernels = [
        {"name": "select_step", "route": "cuda",
         "source": "tapnet_torch/csrc/policy_step.cu",
         "replaces": "tapnet_tpu/ops/pallas_policy_step.py:298",
         "launches": launches["select_step"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "actor_select_step", "route": "cuda",
         "source": "tapnet_torch/csrc/actor_step.cu",
         "replaces": "tapnet_tpu/ops/pallas_actor_step.py:316",
         "launches": launches["actor_select_step"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": max(k2_bound_b, k2_bound_o),
         "bound_by": "operations" if k2_bound_o >= k2_bound_b else "bytes",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
