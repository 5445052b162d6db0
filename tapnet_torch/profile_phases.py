"""Where one actor_select_step launch spends its cycles, phase by phase.

    python -m tapnet_torch.profile_phases [--config 2d-rolling]
        [--batch 4096] [--hidden 128] [--out phases.json]

Builds a copy of `csrc/actor_step.cu` in which thread 0 of every block
reads `clock64()` at the phase boundaries (each right after the barrier
that ends a phase), rolls a sampled batch out to its middle decode step
with the real kernel, then launches the copy on that step's operands in
both modes and prints, per phase, the mean cycles over the blocks and the
share of a block's total, with the launch's time (CUDA events, median of
10). The reads add a few cycles per phase. Needs a CUDA device and nvcc;
the copy is built into `tapnet_torch/_build/phases/`.
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
    """The instrumented library (ctypes) built with the kernels' flags."""
    from tapnet_torch.ops import _build
    out = _build.BUILD / "phases"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "select_place.cuh", out)
    (out / "actor_step.cu").write_text(
        instrumented_source((_build.CSRC / "actor_step.cu").read_text()))
    lib = out / "actor_step_phases.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib),
                    str(out / "actor_step.cu")], check=True)
    return ctypes.CDLL(str(lib))


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
    ap.add_argument("--config", default="2d-rolling")
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
