"""Where pack() and the train step spend their time on the card: a
torch.profiler breakdown.

    python -m tapnet_torch.profile_pack [--config 2d-basic] [--batch 4096]
        [--hidden 128] [--calls 5] [--policies greedy,sample,best]
        [--train] [--out profile_pack.json]

For each policy (greedy, sample, best-of-16 on batch/16 instances; `first`
and `random`, the heuristic rollouts, when named in `--policies`), or with
`--train` for one REINFORCE train step (`make_train_step`, batch `--batch`),
it warms up, times `--calls` calls on the host clock, then profiles as many
more and prints the device time of every kernel name per call, the wall
time per call (unprofiled), the device busy time per call (the sum of
kernel times; one stream, so kernels do not overlap) and the device's idle
share of the wall time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _device_us(evt) -> float:
    """Device time of a kernel row (0 for host-side operator rows and for
    user-annotated ranges such as Optimizer.step, whose device time is
    their kernels', counted under the kernels' names)."""
    if (evt.device_type != DeviceType.CUDA
            or getattr(evt, "is_user_annotation", False)):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


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
    rows = [(e.key, _device_us(e) / 1e3 / calls, e.count // calls)
            for e in prof.key_averages() if _device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"run": label, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "kernels": [{"name": k[:80], "ms": ms, "launches": n}
                        for k, ms, n in rows[:25]]}


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
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_pack: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS, init_train_state, make_train_step, pack
    from tapnet_torch import random as R
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.models.tapnet import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = CONFIGS[args.config]
    out = {"device": torch.cuda.get_device_name(0), "config": args.config,
           "batch": args.batch, "hidden": args.hidden, "runs": []}
    if args.train:
        ts = init_train_state(0, cfg, args.hidden, device=dev)
        step = make_train_step(cfg, args.batch, args.hidden, device=dev)
        runs = [("train_step", lambda: step(ts))]
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
              f"{res['idle_share']:.3f}")
        for k in res["kernels"][:12]:
            print(f"    {k['ms']:8.4f} ms  x{k['launches']:<4d} {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
