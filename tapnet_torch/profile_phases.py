"""Where one actor_select_step, fused_rollout_batch or replay backward
launch spends its cycles, phase by phase.

    python -m tapnet_torch.profile_phases [--config 2d-rolling]
        [--batch 4096] [--hidden 128] [--dtype bfloat16|float32]
        [--csrc DIR] [--out phases.json]
    python -m tapnet_torch.profile_phases --kernel fused_rollout_batch
        [--config 2d-basic,2d-rolling] [--batch 4096]
    python -m tapnet_torch.profile_phases --kernel replay_logp_bwd
        [--config 2d-basic] [--dtype bfloat16|float32] [--csrc DIR]
    python -m tapnet_torch.profile_phases --kernel replay_logp_bwd_steps
        [--config 2d-rolling] [--dtype bfloat16|float32] [--csrc DIR]

actor_select_step (K2): builds a copy of `csrc/actor_step.cu` (or of
DIR/actor_step.cu: `--csrc _verify/parent/tapnet_torch/csrc` profiles a
parent checkout's body on this tree's operands; the C interface is the
same) in which thread 0 of every block adds the cycles since its last
read to the phase it just ended, at the source's named marks (`K2_MARK`,
`K2_PHASES`: each right after the barrier that ends a phase, one per
product), rolls a sampled batch out to its middle decode step with the
real kernel in the compute dtype `--dtype` and hidden width
`--hidden`, then launches the copy on that step's operands in both modes
and prints, per phase, the mean cycles over the blocks and the share of a
block's total, with the launch's time (CUDA events, median of 10).

fused_rollout_batch (K4): a copy of `csrc/env.cu` in which thread 0 of
every block adds the cycles since its last read to the phase it just
ended, over all N steps (the phases repeat every step; inside warp 0's
selection too), launched on `random` draws of each named config; it
prints the mean cycles per phase over the blocks, their share, and the
copy's time per launch (CUDA events, median of 15).

replay_logp_bwd / replay_logp_bwd_steps (K5b, K5b-steps): a copy of
`csrc/replay.cu` (or of DIR/replay.cu: `--csrc _verify/parent/tapnet_torch/
csrc` profiles a parent checkout's body on this tree's operands; the C
interface is the same) in which thread 0 of every block adds the cycles
since its last read to the phase it just ended (`REPLAY_PHASES`: 0, the
encoder and query, the scores, C, the token backward, the query and encoder
backward, F), summed over the block's steps; launched through the wrapper
on a sampled record of each named config in the given compute dtype. It
prints the mean cycles per phase over the blocks, their share, the time
per launch (CUDA events, median of 10) and each kernel of the launch's
device time (torch.profiler): the clocks time `replay_kernel` only, and
the encoder/query weight-gradient contractions of the bfloat16 backward,
and of the float32 one above hidden 128, run in a second kernel,
`grad_outer` (`grad_outer_tf32`, counted under `grad_outer`).

The reads add a few cycles per phase. Needs a CUDA device and nvcc; the
copies are built into `tapnet_torch/_build/phases/`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys

import torch

# K2's named marks (csrc/actor_step.cu `K2_MARK(k)`: phase k ends there;
# nothing in the normal build): the phases, in order.
K2_PHASES = ["0: staging", "0: bit words (all warps)",
             "0: tokens, summary, columns (warp 0)", "flags, mask",
             "1: qin rows", "1: feats (heightmap, max, mean)",
             "1: W1 feats", "1: W2 e1", "1: Wq qin",
             "2: token groups", "3: scores, argmax partials",
             "3: argmax, log pi (warp 0)", "3: placement (all warps)",
             "3: placement join (warp 0)", "3: state writes"]
SLOTS = len(K2_PHASES)
_ACC = ("if (threadIdx.x == 0 && threadIdx.y == 0) {{ long long nw = "
        "clock64(); {} += nw - prof_last; prof_last = nw; }}\n")


def instrumented_source(src: str) -> str:
    """`src` with thread 0's cycle accumulators per phase: K2_MARK(k)
    defined so that the cycles since the last read go to phase k, the last
    phase's at the end of the kernel, where they are stored to
    prof_ts[block * SLOTS + k]."""
    start = "  const float tf = ai.tf[0];\n"
    if src.count(start) != 1:
        raise RuntimeError(f"kernel start not found once: {start!r}")
    src = src.replace(start, start + "long long prof_acc[%d] = {0}; long "
                      "long prof_last = clock64();\n" % SLOTS)
    src = "#define K2_MARK(k) " + _ACC.format("prof_acc[k]") + src
    end = "\n}\n\n}  // namespace\n\n// Dynamic shared memory"
    if src.count(end) != 1:
        raise RuntimeError("the kernel's end not found")
    src = src.replace(end, "\n  __syncthreads();\n  "
                      + _ACC.format(f"prof_acc[{SLOTS - 1}]")
                      + "  if (threadIdx.x == 0 && threadIdx.y == 0) for "
                      f"(int k = 0; k < {SLOTS}; ++k) prof_ts[blockIdx.x * "
                      f"{SLOTS} + k] = prof_acc[k];\n"
                      + end[1:])
    src = src.replace("namespace {\n", "__device__ long long prof_ts[8192 * "
                      f"{SLOTS}];\nnamespace {{\n", 1)
    return src + '''
extern "C" int tapnet_prof_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, prof_ts,
                                   sizeof(long long) * %d * n);
}
''' % SLOTS


def build(csrc=None):
    """The instrumented K2 library (ctypes) of `csrc`/actor_step.cu
    (default the package's), built with the kernels' flags."""
    from pathlib import Path

    from tapnet_torch.ops import _build
    src = Path(csrc or _build.CSRC)
    return _build_copy("actor_step" + ("_tree" if csrc else ""),
                       instrumented_source((src / "actor_step.cu")
                                           .read_text()), src)


# fused_rollout_batch: (text in csrc/env.cu before which thread 0 adds the
# cycles since its last read to a slot, the slot), in the order a step
# runs them; slot 6 is read at the top of the step loop
ROLLOUT_MARKS = [
    ("  // ---- warp 0 owns the instance's selection state", 0),
    ("  for (int t = 0; t < N; ++t) {\n", 1),
    ("    // ---- the placing warps (wy % 4 != 0): a share of the candidate", 2),
    ("    u64 w0 = a0;\n", 9),
    ("    const u64 wr = ar & w0;\n", 10),
    ("    int w = dimS[lo * TB], d = dimS[(N + lo) * TB];\n", 11),
    ("    nx[BLK * TB] = lo;\n", 12),
    ("    // ---- the join and the placement: warp 0 records it (under mcs it", 3),
    ("    if (capped) {\n      // every warp: the changed container's", 4),
    ("    __syncthreads();\n  }\n\n  // ---- the final state", 5),
    ("  // ---- the final state, every warp a share of the rows", 7),
]
ROLLOUT_PHASES = [
    "staging, transposes", "first selection (its end) and barrier",
    "a step's decision read "
    "(+ staging the column)", "placement (12 warps) beside warp 0's "
    "selection, to the barrier", "the join; warp 0's record, the footprint",
    "capped: min-landing table, words, selection", "end-of-step barrier",
    "after the loop", "final writes", "selection: accessibility",
    "selection: window", "selection: count and rank",
    "selection: the block's dims"]
RSLOTS = 14


def rollout_source(src: str) -> str:
    """`src` (csrc/env.cu) with thread 0's cycle accumulators per phase,
    stored to prof_ts[block * RSLOTS + k] at the end of the kernel."""
    mark = ("if (threadIdx.x == 0 && threadIdx.y == 0) {{ long long nw = "
            "clock64(); prof_acc[{}] += nw - prof_last; prof_last = nw; }}\n")
    for text, k in ROLLOUT_MARKS:
        if src.count(text) != 1:
            raise RuntimeError(f"phase mark not found once: {text!r}")
        src = src.replace(text, mark.format(k) + text)
    loop = "  for (int t = 0; t < N; ++t) {\n"
    src = src.replace(loop, loop + mark.format(6))
    start = "  const Plan P = plan(N, R, C, WD, capped, MCS, onchip);\n"
    end = ("                      [&](int q, int v) { io.hm_o[q * B + b] = v;"
           " });\n}\n")
    for text in (start, end):
        if src.count(text) != 1:
            raise RuntimeError(f"kernel bound not found once: {text!r}")
    src = src.replace(start, start + f"  long long prof_acc[{RSLOTS}] = "
                      "{0}; long long prof_last = clock64();\n")
    src = src.replace(end, end[:-2] + mark.format(8) + "  if (threadIdx.x "
                      f"== 0 && threadIdx.y == 0) for (int k = 0; k < "
                      f"{RSLOTS}; ++k) prof_ts[blockIdx.x * {RSLOTS} + k] = "
                      "prof_acc[k];\n}\n")
    src = src.replace("namespace {\n", "__device__ long long prof_ts[8192 * "
                      f"{RSLOTS}];\nnamespace {{\n", 1)
    return src + '''
extern "C" int tapnet_prof_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, prof_ts,
                                   sizeof(long long) * %d * n);
}
''' % RSLOTS


# replay_logp (K5): (text in csrc/replay.cu, the slot it ends, whether the
# read goes after the text); texts that the float32 and bfloat16 bodies
# share, each with the form of earlier versions of the file as an
# alternative, so another checkout's source (--csrc) takes the same marks.
# At hidden widths above 128 the head runs in two passes of 16 instances:
# the accumulators sum both.
_SCORES = (
    "        scores(k, c, p0, TP == TB ? 0 : off[p0], "
    "TP == TB ? n : off[p0 + TP]);\n",
    "      scores(k, c, n);\n")
_TOKEN_BWD = (
    "        token_bwd(k, c, p0, TP == TB ? 0 : off[p0],\n"
    "                  TP == TB ? n : off[p0 + TP]);\n",
    "      token_bwd(k, c, n);\n")
REPLAY_MARKS = [
    ("  for (int k = k0; k < k1; ++k) {\n", 7, False),
    ("  for (int k = k0; k < k1; ++k) {\n", 6, True),
    ("    if (!*flag) continue;", 0, False),
    (_SCORES, 1, False),
    (_SCORES, 2, True),
    ("    if (!BWD) continue;\n", 3, False),
    (_TOKEN_BWD, 1, False),
    (_TOKEN_BWD, 4, True),
    (("        rowsum_acc<TP>(prow + go.b1, e1, LP, h, tid);\n"
      "        __syncthreads();\n",
      "      rowsum_acc(prow + go.b1, e1, LD, h, tid);\n      __syncthreads();"
      "\n"), 5, True),
    ("  if (!BWD) {\n    if (wy == 0 && active) logp_o[b] = lp_sum;", 6,
     False),
]


def _once(src: str, texts) -> str:
    """The first of `texts` (one text or a tuple of alternatives) that
    `src` holds exactly once."""
    for text in (texts,) if isinstance(texts, str) else texts:
        if src.count(text) == 1:
            return text
    raise RuntimeError(f"phase mark not found once: {texts!r}")
REPLAY_PHASES = [
    "0: flags, bit words, live columns", "A, B: encoder and query (their "
    "re-run in D too where C > 1 at h <= 128; above 128 D reads q and e1 "
    "back instead)", "B: scores (token forward)",
    "C: log pi and g (warp 0)", "D: token backward",
    "E: query and encoder backward", "F: embedding gradient, step end",
    "set-up: staging, zeroing the partials", "epilogue: gradient stores"]
KSLOTS = 9


def replay_source(src: str) -> str:
    """`src` (csrc/replay.cu) with thread 0's cycle accumulators per phase
    (`REPLAY_PHASES`, summed over the block's steps), stored to
    prof_ts[block * KSLOTS + k] at each exit of the kernel."""
    mark = ("if (threadIdx.x == 0 && threadIdx.y == 0) {{ long long nw = "
            "clock64(); prof_acc[{}] += nw - prof_last; prof_last = nw; }}\n")
    for texts, k, after in REPLAY_MARKS:
        text = _once(src, texts)
        src = src.replace(text, text + mark.format(k) if after
                          else mark.format(k) + text)
    start = _once(src, ("  const Lay L = layout<WC>(d, BWD",
                        "  const Lay L = layout<WH>(d, BWD",
                        "  const Lay L = layout(d, BWD"))
    src = src.replace(start, f"  long long prof_acc[{KSLOTS}] = {{0}}; "
                      "long long prof_last = clock64();\n" + start)
    store = ("  __syncthreads();\n  " + mark.format(8)
             + "  if (threadIdx.x == 0 && threadIdx.y == 0) for (int k = 0; "
             f"k < {KSLOTS}; ++k) prof_ts[(blockIdx.y * gridDim.x + "
             f"blockIdx.x) * {KSLOTS} + k] = prof_acc[k];\n")
    for end in ("    if (wy == 0 && active) logp_o[b] = lp_sum;\n",
                "    prow[go.v + j] = s;\n  }\n"):
        if src.count(end) != 1:
            raise RuntimeError(f"kernel exit not found once: {end!r}")
        src = src.replace(end, end + store)
    src = src.replace("namespace {\n", "__device__ long long prof_ts[8192 * "
                      f"{KSLOTS}];\nnamespace {{\n", 1)
    return src + '''
extern "C" int tapnet_prof_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, prof_ts,
                                   sizeof(long long) * %d * n);
}
''' % KSLOTS


def replay_phases(kernel: str, names, batch: int, hidden: int, dtype, dev,
                  csrc=None) -> dict:
    """K5b's (`kernel` replay_logp_bwd) or K5b-steps' cycles per phase on a
    sampled record of each config in `names` in the compute dtype `dtype`
    (`chip_smoke.replay_operands`, temperature 1, dlp a ramp): the
    instrumented copy of `csrc`/replay.cu (default the package's) launched
    through ops.replay's wrapper. Mean cycles per phase over the blocks,
    their share, and the copy's time per launch (CUDA events, median of
    10)."""
    from pathlib import Path

    import chip_smoke as CS
    from tapnet_torch import CONFIGS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import replay as RP

    src = Path(csrc or _build.CSRC) / "replay.cu"
    tag = "_" + re.sub(r"\W", "_", str(csrc)) if csrc else ""
    lib = _build_copy("replay" + tag, replay_source(src.read_text()),
                      src.parent)
    fn = lib.tapnet_replay_logp
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    steps = kernel == "replay_logp_bwd_steps"
    res = {"device": torch.cuda.get_device_name(0), "kernel": kernel,
           "source": str(src), "batch": batch, "hidden": hidden,
           "dtype": str(dtype).replace("torch.", ""), "configs": []}
    lib_of = RP._lib
    RP._lib = lambda: fn
    try:
        for name in names:
            cfg = CONFIGS[name]
            actor = init_params(0, cfg, hidden, dev)
            ops, _ = CS.replay_operands(actor, cfg, batch, dev, 10, 1.0,
                                        dtype=dtype)
            _, _, bwd, _ = CS.replay_fns(ops, cfg, 1.0, steps)
            dlp = torch.linspace(-1.0, 1.0, batch, device=dev)
            times = []
            with torch.no_grad():
                for _ in range(13):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(2_000_000)  # queued behind it
                    start.record()
                    bwd(dlp)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
            kernels = launch_kernels(lambda: bwd(dlp))
            nb = -(-batch // 32) * (RP.step_chunks(cfg, batch) if steps
                                    else 1)
            buf = (ctypes.c_longlong * (KSLOTS * nb))()
            if lib.tapnet_prof_read(buf, nb):
                raise RuntimeError("reading the clocks failed")
            per = [statistics.mean(buf[b * KSLOTS + k] for b in range(nb))
                   for k in range(KSLOTS)]
            total = sum(per)
            entry = {"config": name, "ms": statistics.median(times[3:]),
                     "blocks": nb, "block_cycles": total,
                     "phases": dict(zip(REPLAY_PHASES, per)),
                     "kernels_ms": kernels}
            res["configs"].append(entry)
            print(f"{kernel} {res['dtype']} {name} B={batch} hidden "
                  f"{hidden} ({src}): {entry['ms']:.4f} ms/launch (the "
                  f"wrapper's launches, the copy's body), {total:.0f} "
                  f"cycles per block (mean of {nb})", flush=True)
            for p, c in entry["phases"].items():
                print(f"    {c:11.0f} cycles  {c / total:6.3f}  {p}")
            for k, ms in kernels.items():
                print(f"    {ms:11.4f} ms      {k} (device, a launch)")
    finally:
        RP._lib = lib_of
    return res


def launch_kernels(fn, calls: int = 3) -> dict:
    """Device ms per call of each kernel that `fn()` launches, by its
    name's leading word (`replay_kernel`, whose phases the clocks split;
    `grad_outer` and `grad_outer_tf32`, the deferred weight-gradient
    contractions; `reduce_tiles`, `sum_transpose`; the rest as "other"):
    `calls` calls under torch.profiler (`utils.profiling.kernel_rows`)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from tapnet_torch.utils.profiling import kernel_rows

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, ms, _ in kernel_rows(prof):
        m = re.search(r"(replay_kernel|grad_outer|reduce_tiles|"
                      r"sum_transpose)", name)
        key = m.group(1) if m else "other"
        out[key] = out.get(key, 0.0) + ms / calls
    return out


def _build_copy(name: str, source: str, csrc=None):
    """Build `source` with the headers of `csrc` (default the package's
    csrc/) into _build/phases/<name>_phases.so and load it; a library
    built from the same source and headers is loaded as it is."""
    from pathlib import Path

    from tapnet_torch.ops import _build
    out = _build.BUILD / "phases" / name
    out.mkdir(parents=True, exist_ok=True)
    same = True
    for hdr in Path(csrc or _build.CSRC).glob("*.cuh"):
        old = out / hdr.name
        same &= old.exists() and old.read_bytes() == hdr.read_bytes()
        shutil.copy(hdr, out)
    cu, lib = out / f"{name}.cu", out / f"{name}_phases.so"
    same &= cu.exists() and cu.read_text() == source and lib.exists()
    if not same:
        cu.write_text(source)
        subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib),
                        str(cu)], check=True)
    return ctypes.CDLL(str(lib))


def rollout_phases(names, batch: int, dev) -> dict:
    """K4's cycles per phase on `random` draws of each config in `names`
    (the instrumented copy launched through ops.env.rollout_kernel)."""
    from tapnet_torch import CONFIGS
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import env as OE

    lib = _build_copy("env", rollout_source(
        (_build.CSRC / "env.cu").read_text()))
    fn = lib.tapnet_fused_rollout
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    nb = (batch + 31) // 32
    res = {"device": torch.cuda.get_device_name(0), "batch": batch,
           "configs": []}
    lib_of = OE._lib
    OE._lib = lambda: fn
    try:
        for name in names:
            cfg = CONFIGS[name]
            inst = sample_batch(R.key(1, dev), batch, cfg)
            rbits = E.policy_bits(R.split(R.key(2, dev), batch), cfg,
                                  "random")
            ops = OE.rollout_operands(inst, rbits, cfg)
            times = []
            for _ in range(18):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(2_000_000)  # the launch queued behind it
                start.record()
                OE.rollout_kernel(ops, cfg)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            buf = (ctypes.c_longlong * (RSLOTS * nb))()
            if lib.tapnet_prof_read(buf, nb):
                raise RuntimeError("reading the clocks failed")
            per = [statistics.mean(buf[b * RSLOTS + k] for b in range(nb))
                   for k in range(RSLOTS - 1)]
            total = sum(per)
            entry = {"config": name, "ms": statistics.median(times[3:]),
                     "block_cycles": total,
                     "phases": {p: c for p, c in zip(ROLLOUT_PHASES, per)
                                if p}}
            res["configs"].append(entry)
            print(f"fused_rollout_batch {name} B={batch} random: "
                  f"{entry['ms']:.4f} ms/launch, {total:.0f} cycles per "
                  "block (mean)")
            for p, c in entry["phases"].items():
                print(f"    {c:9.0f} cycles  {c / total:6.3f}  {p}")
    finally:
        OE._lib = lib_of
    return res


def mid_step_operands(cfg, batch: int, hidden: int, dev, seed: int = 0,
                      dtype=torch.float32):
    """The operands of the middle decode step of a sampled rollout on the
    card (`rollout_batch_record`'s actor-fused path in the compute dtype
    `dtype`), its transposed weights (None in bfloat16) and the rollout's
    wide operands (None at hidden <= 128)."""
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.train import rollout as RO

    actor = init_params(seed, cfg, hidden, dev)
    inst = sample_batch(R.key(seed + 1, dev), batch, cfg)
    keys = R.split(R.key(seed + 2, dev), batch)
    launch, calls, mid = AS._launch, [], cfg.num_blocks // 2

    def spy(ops, *args):
        calls.append((ops, args[3], args[5]) if len(calls) == mid
                     else None)
        return launch(ops, *args)

    AS._launch = spy
    try:
        RO.rollout_batch_record(actor, inst, keys, cfg, actor_kernel=True,
                                dtype=dtype)
    finally:
        AS._launch = launch
    return calls[mid]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="actor_select_step",
                    choices=("actor_select_step", "fused_rollout_batch",
                             "replay_logp_bwd", "replay_logp_bwd_steps"))
    ap.add_argument("--config", default="",
                    help="a config name (fused_rollout_batch and the "
                         "replay: a comma list); default 2d-rolling, "
                         "2d-basic for replay_logp_bwd")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the compute dtype (K2 and the replay)")
    ap.add_argument("--csrc", default="",
                    help="K2 and the replay: instrument DIR's source "
                         "(another checkout's) instead of the package's")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_phases: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS
    from tapnet_torch.ops import actor_step as AS

    dev = torch.device("cuda:0")
    args.config = args.config or ("2d-basic" if args.kernel
                                  == "replay_logp_bwd" else "2d-rolling")
    if args.kernel.startswith("replay"):
        res = replay_phases(args.kernel, args.config.split(","), args.batch,
                            args.hidden, getattr(torch, args.dtype), dev,
                            args.csrc or None)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
    if args.kernel == "fused_rollout_batch":
        res = rollout_phases(args.config.split(","), args.batch, dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
    cfg = CONFIGS[args.config]
    ops, params_t, wide = mid_step_operands(cfg, args.batch, args.hidden,
                                            dev, dtype=getattr(torch,
                                                               args.dtype))
    # another checkout's bfloat16 body may read the transposed weights
    params_t = params_t or AS.transposed(ops[16])
    lib = build(args.csrc or None)
    fn = lib.tapnet_actor_select_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nb = (args.batch + 31) // 32
    res = {"device": torch.cuda.get_device_name(0), "config": args.config,
           "batch": args.batch, "hidden": args.hidden, "dtype": args.dtype,
           "source": args.csrc or "csrc", "modes": []}
    lib_of = AS._lib
    AS._lib = lambda: fn
    try:
        for logits in (False, True):
            stream = torch.cuda.current_stream(dev).cuda_stream
            launch = lambda: AS._launch(ops, cfg, 1.0, logits, params_t,
                                        stream, wide)
            times = []
            for _ in range(13):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(2_000_000)  # the launch queued behind it
                start.record()
                _, err = launch()
                end.record()
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                times.append(start.elapsed_time(end))
            buf = (ctypes.c_longlong * (SLOTS * nb))()
            if lib.tapnet_prof_read(buf, nb):
                raise RuntimeError("reading the clocks failed")
            accs = [buf[b * SLOTS:(b + 1) * SLOTS] for b in range(nb)]
            total = statistics.mean(sum(a) for a in accs)
            mode = {"logits": logits, "ms": statistics.median(times[3:]),
                    "block_cycles": total,
                    "phases": {n: statistics.mean(a[k] for a in accs)
                               for k, n in enumerate(K2_PHASES)}}
            res["modes"].append(mode)
            print(f"{args.config} B={args.batch} hidden {args.hidden} "
                  f"{args.dtype} ({res['source']}) "
                  f"logits={logits}: {mode['ms']:.4f} ms/launch, "
                  f"{total:.0f} cycles per block (mean)")
            for name, c in mode["phases"].items():
                print(f"    {c:9.0f} cycles  {c / total:6.3f}  {name}")
    finally:
        AS._lib = lib_of
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
