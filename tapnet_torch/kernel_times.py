"""Device times of K1, K2, K4 and K5 at the main paths' shapes, as one JSON
line.

    python -m tapnet_torch.kernel_times [--tag NAME] [--out FILE]
        [--expect FILE] [--hidden 128]

select_step (K1) on the middle step of a greedy rollout of 2d-basic and
2d-rolling at batch 4096 and of multi-container-capped at batch 256 (the
capped train step's shape); actor_select_step (K2) in both modes and both
dtypes on the middle decode step of a sampled rollout of 2d-basic and
2d-rolling at batch 4096 (the state from the float32 kernel, the float
operands in each dtype; f32, bf16, bf16, f32 in turns, each key the mean
of its two turns); fused_rollout_batch (K4) on `random` draws of the six
CONFIGS at batch 4096; the replay (K5) forward and backward, monolithic on
2d-basic and step-grid on 2d-rolling, at batch 4096 in float32 and
bfloat16 on one record of a sampled float32 rollout
(`chip_smoke.replay_operands`, dlp a ramp). Each time is the median of 50
launches (10 for the step-grid backward; CUDA events after a spin kernel,
`chip_smoke.time_gpu`). K2 and K5 run at hidden width `--hidden` (128 by
default; above 128 K2 reads its once-per-rollout operands, made once
here as the decode loop makes them; any width up to 512, one the kernels
do not take, such as 48 or 288, on operands padded with zeros to
`ops.actor_step.kernel_width` as the routes pad them), K1 and K4 do not
depend on it. The
line also holds the hidden width and the SHA-256 of the operands' and the
outputs' bytes of K2 (both modes) and of every K5 kernel, each in both
dtypes: `--expect FILE` (the line another run wrote with `--out`) checks
that those kernels gave bit-identical outputs on bit-identical operands
there and here, and exits 1 if they did not.

    python -m tapnet_torch.kernel_times --csrc DIR[,DIR...] [--hidden 256]
        [--dtype bfloat16] [--kernel replay|actor_select_step]

times only the replay (K5b, K5f, K5b-steps, K5f-steps at batch 4096, in
float32 or, with `--dtype bfloat16`, the bfloat16 instantiations on the
same record's bfloat16 operands), or with `--kernel actor_select_step`
only K2 (both modes on the middle decode step of 2d-basic and 2d-rolling
at batch 4096, in the dtype given), built from this package's source
and from each DIR's (another checkout's csrc/, or an edited copy whose C
interface takes the same pointers or a prefix of them), in turns: the
builds in order, then in reverse (`replay_builds`, `actor_builds`).

    python -m tapnet_torch.kernel_times --kernel query_parts
        [--csrc DIR[,DIR...]] [--hidden 256] [--dtype bfloat16]

times K2's once-per-rollout `query_parts` on one sampled rollout's
operands of 2d-basic and 2d-rolling at batch 4096, at hidden `--hidden`
(every width of `chip_smoke.WIDE` when it is 128, the default), in the
dtype given, built from this package's csrc/actor_step.cu and from each
DIR's, beside the library's two `torch.mm` on float32 operands, in turns
(`query_parts_builds`).

    python -m tapnet_torch.kernel_times --kernel replay_helpers
        [--csrc DIR[,DIR...]]

times the replay backward's helper kernels (`grad_outer`,
`grad_outer_tf32`, `reduce_tiles`, `sum_transpose`) launch by launch from
a torch.profiler trace of K5b (2d-basic) and K5b-steps (2d-rolling) at
batch 4096, hidden 128 and 256, float32 and bfloat16, each beside its
bound, its launches a train step and the one PyTorch call that computes
its function, where there is one, read from the same trace; with
`--csrc`, those of this package's replay.cu and of each DIR's in turns
(`replay_helpers`).

    python -m tapnet_torch.kernel_times --kernel fresh_sum

times, at the same shapes, the sum of the backward's partial rows as the
backward launches it (`reduce_tiles`, right after the kernels that wrote
the rows) beside `torch.sum(part, 0)` launched right after the backward
of an edited copy of csrc/ whose launch() skips that sum, then again on
the same rows, in turns (`fresh_sums`): whether rows just written, not
the kernel, make `reduce_tiles` trail the library in the backward.

To compare two checkouts on one card in one call,

    python -m tapnet_torch.kernel_times --tree ../parent --tag parent

runs this file in a child process from the root of the other checkout, so
that it times that checkout's `tapnet_torch` with its `chip_smoke.py`
(which needs only `time_gpu`, `check_select_step`, `actor_operands`,
`_instances`, `replay_operands` and `replay_fns` there). Run from the
repository root; needs a CUDA device and nvcc. The K5 comparison of a
change with its parent in one call, in turns:

    python -m tapnet_torch.kernel_times --tree _verify/parent --tag parent \
        --out _verify/kt_parent.json
    python -m tapnet_torch.kernel_times --tag change \
        --expect _verify/kt_parent.json
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def _sha(tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def replay_times(CS, dev, hidden=128) -> dict:
    """K5f, K5b (2d-basic) and K5f-steps, K5b-steps (2d-rolling) at batch
    4096 and hidden width `hidden` in float32 and bfloat16 on one float32
    rollout's record: ms per call and the hashes of operands and
    outputs."""
    import torch
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params

    out = {}
    for name, steps in (("2d-basic", False), ("2d-rolling", True)):
        cfg, B = CONFIGS[name], 4096
        actor = init_params(0, cfg, hidden, dev)
        ops_f, _, ops_b = CS.replay_operands(
            actor, cfg, B, dev, 10, 1.0, dtype=torch.float32,
            also=torch.bfloat16)
        dlp = torch.linspace(-1.0, 1.0, B, device=dev)
        suffix = "-steps" if steps else ""
        for dt, ops in (("f32", ops_f), ("bf16", ops_b)):
            fwd, _, bwd, _ = CS.replay_fns(ops, cfg, 1.0, steps)
            flat = [*ops[:8], *ops[8]]
            with torch.no_grad():
                got_f, got_b = fwd(), bwd(dlp)
                for k, fn, got, reps in (
                        (f"K5f{suffix} {dt} {name}", fwd, [got_f], 50),
                        (f"K5b{suffix} {dt} {name}", lambda: bwd(dlp),
                         [got_b[0], got_b[1], *got_b[2]],
                         10 if steps else 50)):
                    out[k] = CS.time_gpu(fn, reps=reps)
                    out[f"{k} sha"] = {"operands": _sha(flat + [dlp]),
                                       "outputs": _sha(got)}
    return out


def _turn_fns(dirs, source, symbol, like) -> dict:
    """{DIR: the C function `symbol` of DIR/<source>.cu} for each DIR of
    `dirs`, built with DIR's headers (one nvcc each, started together)
    into _build/<source>_turns_<i>.so and typed as `like`."""
    import ctypes

    from tapnet_torch.ops import _build

    _build.BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, d in enumerate(dirs):
        so = _build.BUILD / f"{source}_turns_{i}.so"
        procs.append((d, so, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(so),
             os.path.join(d, f"{source}.cu")])))
    fns = {}
    for d, so, proc in procs:
        if proc.wait():
            raise RuntimeError(f"nvcc failed on {d}/{source}.cu")
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes, fn.restype = like.argtypes, ctypes.c_int
        fns[d] = fn
    return fns


def replay_builds(CS, dev, hidden, dirs, dtype="float32") -> dict:
    """The replay in `dtype` ("float32" or "bfloat16": the operands of
    `replay_times`) at batch 4096 and hidden width `hidden` (K5b and K5f
    on 2d-basic, K5b-steps and K5f-steps on 2d-rolling, one float32
    rollout's record each) built from this package's csrc/replay.cu
    ("csrc") and from each DIR/replay.cu of `dirs` with DIR's headers
    (another checkout's csrc/, or an edited copy: the same C interface),
    timed in turns: the builds in order, then in reverse. ms per launch,
    one reading a turn."""
    import torch
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    fns = {"csrc": RP._lib(),
           **_turn_fns(dirs, "replay", "tapnet_replay_logp", RP._lib())}
    order = list(fns) + list(fns)[::-1]
    lib_of, out = RP._lib, {"builds": list(fns), "dtype": dtype}
    dt = "bf16" if dtype == "bfloat16" else "f32"
    try:
        for name, steps in (("2d-basic", False), ("2d-rolling", True)):
            cfg, B = CONFIGS[name], 4096
            actor = init_params(0, cfg, hidden, dev)
            ops_f, _, ops_b = CS.replay_operands(
                actor, cfg, B, dev, 10, 1.0, dtype=torch.float32,
                also=torch.bfloat16)
            ops = ops_b if dt == "bf16" else ops_f
            dlp = torch.linspace(-1.0, 1.0, B, device=dev)
            fwd, _, bwd, _ = CS.replay_fns(ops, cfg, 1.0, steps)
            suffix = "-steps" if steps else ""
            with torch.no_grad():
                for tag in order:
                    RP._lib = lambda fn=fns[tag]: fn
                    for k, fn, reps in (
                            (f"K5b{suffix} {dt} {name}", lambda: bwd(dlp),
                             5 if steps else 20),
                            (f"K5f{suffix} {dt} {name}", fwd, 10 if steps
                             else 20)):
                        out.setdefault(f"{k} {tag}", []).append(
                            CS.time_gpu(fn, reps=reps))
    finally:
        RP._lib = lib_of
    return out


def _wide_operands(AS, params, ctx, cfg):
    """`AS.wide_operands` of this checkout or, under `--tree`, of another,
    whose version before hidden 512 takes (params, ctx)."""
    import inspect

    if len(inspect.signature(AS.wide_operands).parameters) == 2:
        return AS.wide_operands(params, ctx)
    return AS.wide_operands(params, ctx, cfg)


def k2_operands(CS, dev, name, hidden):
    """K2's operands on the middle decode step of a sampled rollout of
    config `name` at batch 4096 and hidden width `hidden` (the state from
    the float32 kernel): the float32 and the bfloat16 step operands, the
    transposed weights and each dtype's once-per-rollout wide operands
    (None at hidden <= 128)."""
    import torch
    from tapnet_torch import CONFIGS
    from tapnet_torch import random as R
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO

    cfg, B, N = CONFIGS[name], 4096, CONFIGS[name].num_blocks
    actor = init_params(0, cfg, hidden, dev)
    inst = CS._instances(cfg, B, dev, 9)
    keys = R.split(R.key(3, dev), B)
    with torch.no_grad():  # to the middle step on the kernel's outputs
        o = CS.actor_operands(actor, inst, cfg, keys)
        (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
        prev = torch.full((1, B), -1, dtype=torch.int32, device=dev)
        wide = _wide_operands(AS, o["params"], o["ctx"], cfg)
        for t in range(N // 2 + 1):
            tf = torch.full((1, 1), t / N, device=dev)
            ops = (tf, packed, hm, plc, prev, dw, dd, dh, o["upm"],
                   o["rotm"], o["fits"], o["g_all"][t], o["se"],
                   o["ctx"], o["statp"], o["statm"], o["params"])
            if t == N // 2:
                break
            got = AS.actor_select_step(*ops, cfg, logits=False,
                                       params_t=o["params_t"], wide=wide)
            packed, hm, plc, prev = got[0], got[1], got[2], got[3][None]
        ob = CS.actor_operands(actor, inst, cfg, keys, torch.bfloat16)
        wide_b = _wide_operands(AS, ob["params"], ob["ctx"], cfg)
    ops_b = ops[:12] + (ob["se"], ob["ctx"], ob["statp"], ob["statm"],
                        ob["params"])
    return ops, ops_b, o["params_t"], wide, wide_b


def actor_builds(CS, dev, hidden, dirs, dtype="float32") -> dict:
    """K2 in `dtype` at hidden width `hidden`, both modes, on the middle
    decode step of 2d-basic and 2d-rolling at batch 4096 (`k2_operands`),
    built from this package's csrc/actor_step.cu ("csrc") and from each
    DIR/actor_step.cu of `dirs` with DIR's headers, timed in turns: the
    builds in order, then in reverse. ms per launch, one reading (the
    median of 20 launches) a turn."""
    from tapnet_torch import CONFIGS
    from tapnet_torch.ops import actor_step as AS

    fns = {"csrc": AS._lib(),
           **_turn_fns(dirs, "actor_step", "tapnet_actor_select_step",
                       AS._lib())}
    order = list(fns) + list(fns)[::-1]
    lib_of, out = AS._lib, {"builds": list(fns), "dtype": dtype}
    dt = "bf16" if dtype == "bfloat16" else "f32"
    try:
        for name in ("2d-basic", "2d-rolling"):
            cfg = CONFIGS[name]
            ops, ops_b, pt, wide, wide_b = k2_operands(CS, dev, name, hidden)
            o, w, p = ((ops_b, wide_b, None) if dt == "bf16"
                       else (ops, wide, pt))
            for tag in order:
                AS._lib = lambda fn=fns[tag]: fn
                for mode, lg in (("main", False), ("full", True)):
                    out.setdefault(f"K2 {mode} {dt} {name} {tag}", []).append(
                        CS.time_gpu(lambda: AS.actor_select_step(
                            *o, cfg, logits=lg, params_t=p, wide=w),
                            reps=20))
    finally:
        AS._lib = lib_of
    return out


def query_parts_builds(CS, dev, hidden, dirs, dtype="float32") -> dict:
    """`query_parts` in `dtype` at hidden `hidden` (every width of
    `chip_smoke.WIDE` when it is 128 or less) on one sampled rollout's
    operands of 2d-basic and 2d-rolling at batch 4096, built from this
    package's csrc/actor_step.cu ("csrc") and from each DIR/actor_step.cu
    of `dirs`, and the library's two `torch.mm` on float32 operands
    ("library"; the casts made before the timing), timed in turns: the
    builds and the library in order, then in reverse. ms per launch, one
    reading (the median of 25 launches) a turn."""
    import torch
    from tapnet_torch import CONFIGS
    from tapnet_torch import random as R
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS

    fns = {"csrc": AS._qp_lib(),
           **_turn_fns(dirs, "actor_step", "tapnet_actor_query_parts",
                       AS._qp_lib())}
    order = list(fns) + ["library"]
    order += order[::-1]
    lib_of, out = AS._qp_lib, {"builds": list(fns), "dtype": dtype}
    dt = "bf16" if dtype == "bfloat16" else "f32"
    cdt = getattr(torch, dtype)
    widths = (hidden,) if hidden > 128 else CS.WIDE
    try:
        for h in widths:
            for name in ("2d-basic", "2d-rolling"):
                cfg, B = CONFIGS[name], 4096
                actor = init_params(0, cfg, h, dev)
                inst = CS._instances(cfg, B, dev, 9)
                with torch.no_grad():
                    o = CS.actor_operands(actor, inst, cfg,
                                          R.split(R.key(3, dev), B), cdt)
                p, ctx = o["params"], o["ctx"]
                wq, et = p[8].float(), p[7].float()
                wc, we, c32 = wq[:, h:2 * h], wq[:, 2 * h:3 * h], ctx.float()
                for tag in order:
                    if tag == "library":
                        fn = lambda: (torch.mm(wc, c32), torch.mm(we, et))
                    else:
                        AS._qp_lib = lambda fn=fns[tag]: fn
                        fn = lambda: AS.query_parts(p, ctx)
                    out.setdefault(f"query_parts {dt} h{h} {name} {tag}",
                                   []).append(CS.time_gpu(fn))
    finally:
        AS._qp_lib = lib_of
    return out


HELPERS = r"grad_outer_tf32|grad_outer|reduce_tiles|sum_transpose"


def _trace_events(prof) -> list:
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def helper_launches(fn, calls: int = 5, library=None, after=None) -> tuple:
    """({kernel: [device ms of each launch]}, {label: [device ms of each
    call]}): the replay's helper kernels over `calls` calls of fn() and the
    kernels of `calls` calls of each library function of `library`
    ({label: fn}), all under one torch.profiler session, so that both are
    read by the same clock from the same trace; `after` ({label: fn}) are
    library functions called right after each call of fn(), before the
    next. Helpers are found by name in launch order (`reduce_tiles`
    launched after `sum_transpose` in a call, the step-grid schedule's
    d_ctx partials, is "reduce_tiles d_ctx"); a library call's kernels by
    the correlation of each kernel with its launch, which lies inside that
    call's record_function range (a call's time is the sum of its
    kernels')."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    library, after = library or {}, after or {}
    fn()
    for f in (*library.values(), *after.values()):
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            for label, f in after.items():
                with record_function(f"library {label}"):
                    f()
            torch.cuda.synchronize()
        for label, f in library.items():
            for _ in range(calls):
                with record_function(f"library {label}"):
                    f()
                torch.cuda.synchronize()
    events = _trace_events(prof)
    kernels = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "kernel"), key=lambda e: e["ts"])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"][len("library "):])
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"].startswith("library ")]
    out, lib, after_sum = {}, {}, False
    for e in kernels:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        inside = [r for r in ranges if ts is not None and r[0] <= ts <= r[1]]
        if inside:
            r = inside[0]
            lib.setdefault(r[2], {}).setdefault(r[0], 0.0)
            lib[r[2]][r[0]] += float(e["dur"]) / 1e3
            continue
        if "replay_kernel" in e["name"]:
            after_sum = False
        m = re.search(HELPERS, e["name"])
        if m is None:
            continue
        key = m.group(0)
        if key == "sum_transpose":
            after_sum = True
        elif key == "reduce_tiles" and after_sum:
            key = "reduce_tiles d_ctx"
        out.setdefault(key, []).append(float(e["dur"]) / 1e3)
    return out, {k: list(v.values()) for k, v in lib.items()}


def helper_work(CS, kernel, cfg, B, h, acts, nc) -> tuple:
    """(bytes, operations, ops/s, input shape) of one launch of a replay
    helper kernel at these shapes: each input read once and each output
    written once; `grad_outer`'s products over the (tile, step) pairs in
    which an instance of the tile acts (`acts` [N, B], this record's), at
    the rate of the passes it runs: bfloat16 hi and lo passes at the dense
    bf16 peak, 3xTF32 at 495/3 TFLOP/s; the sums' additions at the f32
    rate (`chip_smoke`'s peaks). The input shape is that of the summed
    partials (None for `grad_outer`)."""
    import torch.nn.functional as Fn
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import replay as RP

    tiles = (B + RP.TB - 1) // RP.TB
    P = sum(a * b for a, b in AS.head_shapes(cfg, h))
    E = cfg.num_blocks * cfg.num_rot * h  # sum_transpose's rows
    if kernel == "reduce_tiles":
        n = tiles * nc * P
        return 4 * (n + P), n, CS.F32_OPS_S, (tiles * nc, P)
    if kernel == "reduce_tiles d_ctx":
        n = nc * h * B
        return 4 * (n + h * B), n, CS.F32_OPS_S, (nc, h * B)
    if kernel == "sum_transpose":
        n = nc * B * E
        return 4 * (n + E * B), n, CS.F32_OPS_S, (nc, B, E)
    tp = AS.geometry(h)["tp"]
    pad = Fn.pad(acts, (0, tiles * RP.TB - B), value=-1)
    active = int((pad.view(acts.shape[0], tiles, RP.TB) >= 0).any(-1)
                 .sum())
    parts = active * cfg.num_containers * (RP.TB // tp)
    cols = 3 * h + 8 + h + cfg.target_width * cfg.target_depth + 2
    xs = 2 if kernel == "grad_outer" else 4  # bfloat16 activations
    nb = parts * tp * (3 * h * 4 + cols * xs) + 4 * tiles * nc * h * cols
    mac = parts * h * cols * tp
    if kernel == "grad_outer":
        return nb, 2 * 2 * mac, CS.BF16_TC_OPS_S, None
    return nb, 2 * mac, CS.TF32X3_OPS_S, None


def replay_helpers(CS, dev, dirs=()) -> dict:
    """The replay backward's helper kernels at the train step's shapes:
    K5b on 2d-basic and K5b-steps on 2d-rolling at batch 4096, hidden 128
    and 256, float32 and bfloat16, on one sampled float32 rollout's record
    (`chip_smoke.replay_operands`, dlp a ramp), built from this package's
    csrc/replay.cu ("csrc") and from each DIR/replay.cu of `dirs`, in
    turns: the builds in order, then in reverse. For each kernel that
    runs: ms per launch a turn and build (the median of `helper_launches`
    over 5 calls), its launches per train step, its bound (`helper_work`),
    the loss a step and the one PyTorch call that computes its function on
    a tensor of its input's shape, timed in the same trace as the kernel
    each turn (`torch.sum(part, 0)`; for `sum_transpose`, `torch.sum`
    over the chunk axis of the transposed view into an [E, B] output), or
    None for `grad_outer`: it reads the records' interleaved (step,
    container, pass) parts and skips the steps without an action
    (`sflag`), which no single call does. "ms" and "library_ms" are this
    package's and the library's medians over their turns; for
    `reduce_tiles`, "alone_ms" is this package's kernel launched alone
    (`ops.replay.reduce_tiles`) on the library's own input right after
    the library's calls in the same trace, so that both read a tensor in
    the same state of the caches (the library's input, read five times
    over, stays in L2 where it fits; the kernel's, in the backward, was
    written by the kernels before it)."""
    import statistics

    import torch
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    fns = {"csrc": RP._lib(),
           **_turn_fns(dirs, "replay", "tapnet_replay_logp", RP._lib())}
    order = list(fns) + list(fns)[::-1]
    lib_of = RP._lib
    out, B, calls = {"builds": list(fns)}, 4096, 5
    try:
        for h in (128, 256):
            for name, steps in (("2d-basic", False), ("2d-rolling", True)):
                cfg = CONFIGS[name]
                actor = init_params(0, cfg, h, dev)
                ops_f, _, ops_b = CS.replay_operands(
                    actor, cfg, B, dev, 10, 1.0, dtype=torch.float32,
                    also=torch.bfloat16)
                dlp = torch.linspace(-1.0, 1.0, B, device=dev)
                nc = RP.step_chunks(cfg, B) if steps else 1
                shapes = {k: helper_work(CS, k, cfg, B, h, ops_f[3], nc)[3]
                          for k in ("reduce_tiles", "reduce_tiles d_ctx",
                                    "sum_transpose")}
                xs = {k: torch.randn(s, device=dev)
                      for k, s in shapes.items() if k != "reduce_tiles d_ctx"
                      or nc > 1}
                y = torch.empty(shapes["sum_transpose"][2], B, device=dev)
                # sum_transpose's first (its input passes through L2);
                # then each sum by the library and, right after it on the
                # same input, this package's kernel alone
                library = {"sum_transpose": lambda: torch.sum(
                    xs["sum_transpose"].permute(0, 2, 1), 0, out=y)}
                for k, x in xs.items():
                    if k.startswith("reduce_tiles"):
                        o = torch.empty(x.shape[1], device=dev)
                        library[k] = lambda x=x: torch.sum(x, 0)
                        library[f"{k} alone"] = (
                            lambda x=x, o=o: RP.reduce_tiles(x, out=o))
                for dt, ops in (("f32", ops_f), ("bf16", ops_b)):
                    bwd = CS.replay_fns(ops, cfg, 1.0, steps)[2]
                    for tag in order:
                        RP._lib = lambda fn=fns[tag]: fn
                        with torch.no_grad():
                            got, libt = helper_launches(lambda: bwd(dlp),
                                                        calls, library)
                        for k, times in got.items():
                            key = f"{k} {dt} h{h} {name}"
                            if key not in out:
                                nb, n_ops, rate, _ = helper_work(
                                    CS, k, cfg, B, h, ops[3], nc)
                                by_b = 1e3 * nb / CS.HBM_BYTES_S
                                by_o = 1e3 * n_ops / rate
                                out[key] = {
                                    "launches_per_step": len(times) // calls,
                                    "bound_ms": max(by_b, by_o),
                                    "bound_by": "bytes" if by_b >= by_o
                                    else "operations",
                                    "turns": {}, "library_turns": [],
                                    "alone_turns": []}
                            r = out[key]
                            r["turns"].setdefault(tag, []).append(
                                sorted(times)[len(times) // 2])
                            for lk, rk in ((k, "library_turns"),
                                           (f"{k} alone", "alone_turns")):
                                if lk in libt:
                                    lt = libt[lk]
                                    r[rk].append(sorted(lt)[len(lt) // 2])
    finally:
        RP._lib = lib_of
    for k, r in out.items():
        if k == "builds":
            continue
        r["ms"] = statistics.median(r["turns"]["csrc"])
        r["library_ms"] = (statistics.median(r["library_turns"])
                           if r["library_turns"] else None)
        r["alone_ms"] = (statistics.median(r["alone_turns"])
                         if r["alone_turns"] else None)
        r["loss_ms_per_step"] = r["launches_per_step"] * (r["ms"]
                                                          - r["bound_ms"])
    return out


def fresh_sums(CS, dev) -> dict:
    """Whether rows just written slow their sum (`reduce_tiles` trails
    `torch.sum(part, 0)` in the backward, but not alone on the library's
    input): K5b on 2d-basic and K5b-steps on 2d-rolling at batch 4096,
    hidden 128 and 256, float32 and bfloat16, on one sampled float32
    rollout's record, each from its own profiler traces (`helper_launches`)
    in turns: "reduce_tiles", the sum of the partial rows as this
    package's backward launches it (right after the kernels that wrote
    them); "fresh", `torch.sum(part, 0)` launched right after the backward
    of an edited copy of this package's csrc/ whose launch() skips that
    sum, so that the library, too, is the first to read the rows; "again",
    the same call on the same rows right after it (their second read).
    Median ms per call of 5 calls a turn, each key's turns."""
    import shutil

    import torch
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import replay as RP

    edited = _build.BUILD / "csrc_no_row_sum"
    shutil.rmtree(edited, ignore_errors=True)
    shutil.copytree(_build.CSRC, edited)
    src = (edited / "replay.cu").read_text()
    skip = ("  err = launch_reduce_tiles((const float*)p[23], tiles * nc, P,\n"
            "                            (float*)p[24], st);\n")
    if src.count(skip) != 1:
        raise RuntimeError("fresh_sums: launch()'s sum of the partial rows "
                           "not found in csrc/replay.cu")
    (edited / "replay.cu").write_text(src.replace(skip, "  (void)P;\n"))
    fns = {"csrc": RP._lib(),
           "edited": _turn_fns([str(edited)], "replay",
                               "tapnet_replay_logp", RP._lib())[str(edited)]}
    lib_of, B, out = RP._lib, 4096, {}
    med = lambda v: sorted(v)[len(v) // 2]
    try:
        for h in (128, 256):
            for name, steps in (("2d-basic", False), ("2d-rolling", True)):
                cfg = CONFIGS[name]
                ops_f, _, ops_b = CS.replay_operands(
                    init_params(0, cfg, h, dev), cfg, B, dev, 10, 1.0,
                    dtype=torch.float32, also=torch.bfloat16)
                dlp = torch.linspace(-1.0, 1.0, B, device=dev)
                for dt, ops in (("f32", ops_f), ("bf16", ops_b)):
                    bwd = CS.replay_fns(ops, cfg, 1.0, steps)[2]
                    r = out.setdefault(f"{dt} h{h} {name}", {
                        "reduce_tiles": [], "fresh": [], "again": []})

                    def run():
                        RP.kept.clear()
                        bwd(dlp)

                    def total():
                        return torch.sum(RP.kept[-1]["part"], 0)

                    for tag in ("csrc", "edited", "edited", "csrc"):
                        RP._lib = lambda fn=fns[tag]: fn
                        RP.kept = []
                        try:
                            with torch.no_grad():
                                if tag == "csrc":
                                    got, _ = helper_launches(run)
                                    r["reduce_tiles"].append(
                                        med(got["reduce_tiles"]))
                                else:
                                    _, lib = helper_launches(
                                        run, after={"fresh": total,
                                                    "again": total})
                                    r["fresh"].append(med(lib["fresh"]))
                                    r["again"].append(med(lib["again"]))
                        finally:
                            RP.kept = None
                del ops_f, ops_b
    finally:
        RP._lib = lib_of
    return out


def check_expected(out: dict, path: str) -> bool:
    """Whether every kernel of `out` with hashes (K2 float32, K5) saw the
    operands and gave the outputs that the run recorded in `path` did, bit
    for bit."""
    with open(path) as f:
        ref = json.loads(f.read().strip().splitlines()[-1])
    ok = True
    for k, v in out.items():
        if k.endswith(" sha"):
            same = ref.get(k) == v
            ok &= same
            print(f"{k[:-4]}: operands and outputs bit-identical to "
                  f"{ref.get('tag')!r}: {same}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--tree", default="",
                    help="time the kernels of the checkout at this path")
    ap.add_argument("--out", default="", help="also write the line here")
    ap.add_argument("--expect", default="",
                    help="a line written by --out: hold the K2 float32 "
                         "and K5 outputs to it bit for bit")
    ap.add_argument("--hidden", type=int, default=128,
                    help="the hidden width of K2 and K5")
    ap.add_argument("--csrc", default="",
                    help="instead: the replay of this package's replay.cu "
                         "and of each DIR/replay.cu of this comma list, in "
                         "turns (replay_builds)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="with --csrc: the instantiation timed")
    ap.add_argument("--kernel", default="replay",
                    choices=("replay", "actor_select_step", "query_parts",
                             "replay_helpers", "fresh_sum"),
                    help="with --csrc: the kernel timed; query_parts and "
                         "replay_helpers also without")
    args = ap.parse_args(argv)
    if args.tree:
        fwd = ["--tag", args.tag]
        if args.hidden != 128:
            fwd += ["--hidden", str(args.hidden)]
        for flag, path in (("--out", args.out), ("--expect", args.expect)):
            if path:
                fwd += [flag, os.path.abspath(path)]
        code = (f"import runpy, sys; sys.argv = ['kernel_times', *{fwd!r}]; "
                f"runpy.run_path({os.path.abspath(__file__)!r}"
                ", run_name='__main__')")
        return subprocess.run([sys.executable, "-c", code],
                              cwd=args.tree).returncode
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from tapnet_torch import CONFIGS
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import env as OE
    from tapnet_torch.ops import policy_step as PS

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    _build.build_all()
    out = {"tag": args.tag, "device": torch.cuda.get_device_name(0),
           "hidden": args.hidden}
    dirs = args.csrc.split(",") if args.csrc else []
    if args.csrc or args.kernel in ("query_parts", "replay_helpers",
                                    "fresh_sum"):
        if args.kernel == "replay_helpers":
            out.update(replay_helpers(CS, dev, dirs))
        elif args.kernel == "fresh_sum":
            out.update(fresh_sums(CS, dev))
        else:
            builds = {"actor_select_step": actor_builds,
                      "query_parts": query_parts_builds}.get(args.kernel,
                                                             replay_builds)
            out.update(builds(CS, dev, args.hidden, dirs, args.dtype))
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(out) + "\n")
        return 0
    for name, B in (("2d-basic", 4096), ("2d-rolling", 4096),
                    ("multi-container-capped", 256)):
        cfg = CONFIGS[name]
        ops = CS.check_select_step(cfg, B, init_params(0, cfg, 128, dev),
                                   dev, keep=True)
        out[f"K1 {name}"] = CS.time_gpu(
            lambda: PS.select_step(*ops, cfg=cfg), reps=50)
    for name in ("2d-basic", "2d-rolling"):
        cfg = CONFIGS[name]
        ops, ops_b, pt, wide, wide_b = k2_operands(CS, dev, name, args.hidden)
        for mode, lg in (("main", False), ("full", True)):
            run = {"f32": lambda: AS.actor_select_step(
                       *ops, cfg, logits=lg, params_t=pt, wide=wide),
                   "bf16": lambda: AS.actor_select_step(
                       *ops_b, cfg, logits=lg, wide=wide_b)}
            turns = {"f32": [], "bf16": []}
            for dt in ("f32", "bf16", "bf16", "f32"):
                turns[dt].append(CS.time_gpu(run[dt], reps=50))
            for dt, ts in turns.items():
                out[f"K2 {mode} {dt} {name}"] = sum(ts) / 2
            with torch.no_grad():  # the kernel --expect holds
                for dt, o in (("f32", [*ops[:16], *ops[16], *pt]),
                              ("bf16", [*ops_b[:16], *ops_b[16]])):
                    got = run[dt]()
                    out[f"K2 {mode} {dt} {name} sha"] = {
                        "operands": _sha(o),
                        "outputs": _sha([g for g in got if g is not None])}
    for name, cfg in CONFIGS.items():
        inst = CS._instances(cfg, 4096, dev, 25)
        rbits = E.policy_bits(R.split(R.key(26, dev), 4096), cfg, "random")
        kops = OE.rollout_operands(inst, rbits, cfg)
        out[f"K4 {name}"] = CS.time_gpu(lambda: OE.rollout_kernel(kops, cfg),
                                        reps=50)
    out.update(replay_times(CS, dev, args.hidden))
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if args.expect and not check_expected(out, args.expect):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
