"""Where pack() and the train step spend their time on the card: a
torch.profiler breakdown.

    python -m tapnet_torch.profile_pack [--config 2d-basic] [--batch 4096]
        [--hidden 128] [--calls 5] [--policies greedy,sample,best]
        [--train] [--steps-per-call 1] [--mixed-p2d P] [--dtype bfloat16]
        [--routes kernels,fallback] [--tree DIR] [--out profile_pack.json]

For each policy (greedy, sample, best-of-16 on batch/16 instances; `first`
and `random`, the heuristic rollouts, when named in `--policies`), or with
`--train` for one call of the REINFORCE train step (`make_train_step`,
batch `--batch`, `--steps-per-call` steps a call, on mixed 2D/3D batches
with `--mixed-p2d` > 0, in the compute dtype `--dtype`; `--routes`: the
routers' own choice, `kernels`, and `fallback`, the route a config past
K2's and K5's coverage takes: K1 decode and the general autograd replay;
two routes run in turns a, b, b, a, each from its own seeded state), it
warms up, times
`--calls` calls on the host clock, then profiles as many more and prints
the device time and launches of every kernel name per call, the kernel
launches per call, the wall time per call (unprofiled), the device busy
time per call (the sum of kernel times; one stream, so kernels do not
overlap) and the device's idle share of the wall time. `--tree DIR` runs
the same measurement on the checkout at DIR (its `tapnet_torch`), so two
trees compare in one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from tapnet_torch.utils.profiling import kernel_rows


def profile_calls(label, run, calls):
    """Wall ms per call (unprofiled), then the device time per kernel name
    over `calls` profiled calls of `run`."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / calls   # unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    rows = [(name, ms / calls, n // calls)
            for name, ms, n in kernel_rows(prof)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"run": label, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "launches": sum(r[2] for r in rows),
            "kernels": [{"name": k[:80], "ms": ms, "launches": n}
                        for k, ms, n in rows[:25]]}


def routed(step, ts, route):
    """A call of `step(ts)` with the routers answering as `route` says:
    `kernels` as they do, `fallback` as for a config past K2's and K5's
    coverage (K1 decode and the general autograd replay; a graphed step is
    captured on its first call, so under the route it is called with)."""
    from tapnet_torch.train import rollout as RO

    real = RO.routes
    if route == "kernels":
        return lambda: step(ts)
    if route != "fallback":
        raise ValueError(f"unknown route {route!r}: kernels or fallback")

    def fallback(cfg, on_card, *a, **k):
        return real(cfg, on_card, *a, **k)._replace(decode="step",
                                                    replay=False)

    def run():
        RO.routes = fallback
        try:
            return step(ts)
        finally:
            RO.routes = real
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="2d-basic")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--policies", default="greedy,sample,best",
                    help="comma-separated pack() policies: greedy, sample, "
                    "best, first, random")
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of pack()")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="train steps per call (--train)")
    ap.add_argument("--mixed-p2d", type=float, default=0.0,
                    help="share of flat instances in the train step's "
                    "batches (--train; 3D configs)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the train step's compute dtype (--train)")
    ap.add_argument("--routes", default="kernels",
                    help="--train: comma list of kernels (the routers' "
                    "choice) and fallback (K1 decode, the general replay)")
    ap.add_argument("--tree", default="",
                    help="profile the checkout at this path")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if args.tree:
        rest = list(argv if argv is not None else sys.argv[1:])
        i = rest.index("--tree")
        rest = rest[:i] + rest[i + 2:]
        if args.out:
            j = rest.index("--out")
            rest[j + 1] = os.path.abspath(args.out)
        code = ("import runpy, sys; sys.argv = ['profile_pack'] + "
                f"{rest!r}; runpy.run_path({os.path.abspath(__file__)!r}, "
                "run_name='__main__')")
        return subprocess.run([sys.executable, "-c", code],
                              cwd=args.tree).returncode
    if not torch.cuda.is_available():
        print("profile_pack: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS, init_train_state, make_train_step, pack
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.models.tapnet import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda:0")
    cfg = CONFIGS[args.config]
    out = {"device": torch.cuda.get_device_name(0), "config": args.config,
           "batch": args.batch, "hidden": args.hidden, "runs": []}
    if args.train:
        out.update(dtype=args.dtype, routes=args.routes)
        runs = []
        for route in args.routes.split(","):
            ts = init_train_state(0, cfg, args.hidden, device=dev)
            step = make_train_step(cfg, args.batch, args.hidden, device=dev,
                                   steps_per_call=args.steps_per_call,
                                   mixed_p2d=args.mixed_p2d,
                                   compute_dtype=getattr(torch, args.dtype))
            runs.append((f"train_step x{args.steps_per_call} {route}",
                         routed(step, ts, route)))
        if len(runs) == 2:
            runs = [runs[0], runs[1], runs[1], runs[0]]
    else:
        actor = init_params(0, cfg, args.hidden, dev)
        inst = sample_batch(R.key(4, dev), args.batch, cfg)
        runs = [(f"pack({policy})",
                 lambda policy=policy: pack(
                     inst if policy != "best"
                     else inst.index(slice(0, args.batch // 16)),
                     cfg, actor, policy=policy, key=1, n_samples=16))
                for policy in args.policies.split(",")]
    for label, run in runs:
        res = profile_calls(label, run, args.calls)
        out["runs"].append(res)
        print(f"{label}: wall {res['wall_ms']:.3f} ms/call, device busy "
              f"{res['device_busy_ms']:.3f} ms, idle share "
              f"{res['idle_share']:.3f}, {res['launches']} launches/call")
        for k in res["kernels"][:12]:
            print(f"    {k['ms']:8.4f} ms  x{k['launches']:<4d} {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
