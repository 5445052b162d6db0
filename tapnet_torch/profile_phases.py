"""Where one actor_select_step or fused_rollout_batch launch spends its
cycles, phase by phase.

    python -m tapnet_torch.profile_phases [--config 2d-rolling]
        [--batch 4096] [--hidden 128] [--out phases.json]
    python -m tapnet_torch.profile_phases --kernel fused_rollout_batch
        [--config 2d-basic,2d-rolling] [--batch 4096]

actor_select_step (K2): builds a copy of `csrc/actor_step.cu` in which
thread 0 of every block reads `clock64()` at the phase boundaries (each
right after the barrier that ends a phase), rolls a sampled batch out to
its middle decode step with the real kernel, then launches the copy on
that step's operands in both modes and prints, per phase, the mean cycles
over the blocks and the share of a block's total, with the launch's time
(CUDA events, median of 10).

fused_rollout_batch (K4): a copy of `csrc/env.cu` in which thread 0 of
every block adds the cycles since its last read to the phase it just
ended, over all N steps (the phases repeat every step; inside warp 0's
selection too), launched on `random` draws of each named config; it
prints the mean cycles per phase over the blocks, their share, and the
copy's time per launch (CUDA events, median of 15).

The reads add a few cycles per phase. Needs a CUDA device and nvcc; the
copies are built into `tapnet_torch/_build/phases/`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys

import torch

# (text in csrc/actor_step.cu, whether the clock read goes after it) and
# the phase that ends at each read
MARKS = [
    ("  const float tf = ai.tf[0];\n", True),
    ("    // every warp: the packed word, then the accessibility", False),
    ("    if (wy == 0) {\n      const Word pk = wb[lane]", False),
    ("  // flags and mask, every warp a share of the rows\n", False),
    ("    // ---- phase 2: the token work", False),
    ("  // ---- phase 3: masked logits", False),
    ("  // per instance on warp 0: the max, the argmax", False),
    ("  // the placement: every warp a share of the candidate offsets\n",
     False),
    ("  if (wy == 0 && active) {\n    PlacePart pb", False),
    ("  // the state writes of select_place, every warp a share of the "
     "rows\n", False),
]
PHASES = ["0: staging", "0: bit words (all warps)",
          "0: tokens, summary, columns (warp 0)", "flags, mask, 1: encoder "
          "and query", "2: token groups", "3: scores, argmax partials",
          "3: argmax, log pi (warp 0)", "3: placement (all warps)",
          "3: placement join (warp 0)", "3: state writes"]
SLOTS = 16


def instrumented_source(src: str) -> str:
    """`src` with a clock64() read of thread 0 at each mark and at the end
    of the kernel, stored to prof_ts[block * SLOTS + k]."""
    read = ("if (threadIdx.x == 0 && threadIdx.y == 0) "
            "prof_ts[blockIdx.x * {} + {}] = clock64();\n")
    for k, (text, after) in enumerate(MARKS):
        if src.count(text) != 1:
            raise RuntimeError(f"phase mark not found once: {text!r}")
        r = read.format(SLOTS, k)
        src = src.replace(text, text + r if after else r + text)
    end = "\n}\n\n}  // namespace"
    if src.count(end) != 1:
        raise RuntimeError("the kernel's end not found")
    src = src.replace(end, "\n  __syncthreads();\n  "
                      + read.format(SLOTS, len(MARKS))
                      + "}\n\n}  // namespace")
    src = src.replace("namespace {\n", "__device__ long long prof_ts[8192 * "
                      f"{SLOTS}];\nnamespace {{\n", 1)
    return src + '''
extern "C" int tapnet_prof_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, prof_ts,
                                   sizeof(long long) * %d * n);
}
''' % SLOTS


def build():
    """The instrumented K2 library (ctypes), built with the kernels'
    flags."""
    from tapnet_torch.ops import _build
    return _build_copy("actor_step", instrumented_source(
        (_build.CSRC / "actor_step.cu").read_text()))


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


def _build_copy(name: str, source: str):
    from tapnet_torch.ops import _build
    out = _build.BUILD / "phases"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "select_place.cuh", out)
    (out / f"{name}.cu").write_text(source)
    lib = out / f"{name}_phases.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib),
                    str(out / f"{name}.cu")], check=True)
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


def mid_step_operands(cfg, batch: int, hidden: int, dev, seed: int = 0):
    """The operands of the middle decode step of a sampled rollout on the
    card (`rollout_batch_record`'s actor-fused path) and its transposed
    weights."""
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
        calls.append((ops, args[3]) if len(calls) == mid else None)
        return launch(ops, *args)

    AS._launch = spy
    try:
        RO.rollout_batch_record(actor, inst, keys, cfg, actor_kernel=True)
    finally:
        AS._launch = launch
    return calls[mid]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="actor_select_step",
                    choices=("actor_select_step", "fused_rollout_batch"))
    ap.add_argument("--config", default="2d-rolling",
                    help="a config name (fused_rollout_batch: a comma "
                         "list)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_phases: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS
    from tapnet_torch.ops import actor_step as AS

    dev = torch.device("cuda:0")
    if args.kernel == "fused_rollout_batch":
        res = rollout_phases(args.config.split(","), args.batch, dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return 0
    cfg = CONFIGS[args.config]
    ops, params_t = mid_step_operands(cfg, args.batch, args.hidden, dev)
    lib = build()
    fn = lib.tapnet_actor_select_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nb = (args.batch + 31) // 32
    res = {"device": torch.cuda.get_device_name(0), "config": args.config,
           "batch": args.batch, "hidden": args.hidden, "modes": []}
    lib_of = AS._lib
    AS._lib = lambda: fn
    try:
        for logits in (False, True):
            stream = torch.cuda.current_stream(dev).cuda_stream
            launch = lambda: AS._launch(ops, cfg, 1.0, logits, params_t,
                                        stream)
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
            ts = [buf[b * SLOTS:b * SLOTS + len(MARKS) + 1]
                  for b in range(nb)]
            total = statistics.mean(t[-1] - t[0] for t in ts)
            phases = [statistics.mean(t[k + 1] - t[k] for t in ts)
                      for k in range(len(MARKS))]
            mode = {"logits": logits, "ms": statistics.median(times[3:]),
                    "block_cycles": total,
                    "phases": dict(zip(PHASES, phases))}
            res["modes"].append(mode)
            print(f"{args.config} B={args.batch} hidden {args.hidden} "
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
