"""How steady the train row's device anchor is, and what moves it: the
headline's train call measured in rounds on the card, with the card's
clocks sampled beside every window.

    python -m tapnet_torch.profile_anchor [--rounds 4] [--batch 4096]
        [--steps-per-call 8] [--out profile_anchor.json]

Each round runs, on 2d-basic at hidden 128 (the headline's train row):
the heuristic row's load first (`benchmarks.measure_env_stats`, as the
headline runs it before the train row), then
- `wall`: 3 windows of 20 unprofiled calls on the host clock (the
  headline's train windows), ms per step;
- `events`: 3 unprofiled calls between two CUDA events, ms per step;
- `sessions`: 6 profiler sessions of one call each, each read as
  `utils.profiling.device_time_ms` reads one (the summed device rows), ms
  per step, with the rows it recorded and its four largest rows, so that
  a session that reads off can be compared row by row with the others;
- `benchmark`: the train row's anchor as `benchmarks.measure_train_stats`
  takes it (one reading per timed window, after them; their median) against
  its own windows.

`nvidia-smi` samples the SM clock, power draw, temperature and the active
clock-throttle reasons every 100 ms throughout; every window carries the
samples taken inside it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

SMI_FIELDS = ("timestamp,clocks.sm,clocks.mem,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")


def _smi_samples(path, t0, t1):
    """The nvidia-smi samples taken between host times t0 and t1 (epoch
    seconds): [(sm MHz, mem MHz, W, C, throttle reasons)]."""
    out = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 6:
                continue
            try:
                t = datetime.datetime.strptime(
                    parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                vals = [float(p) for p in parts[1:5]]
            except ValueError:
                continue
            if t0 <= t <= t1:
                out.append(vals + [parts[5]])
    return out


def _session(call, k):
    """One call under its own profiler session: its summed device rows in
    the profiler's timestamps (`kernel_rows`), ms per step; the rows it
    recorded; the four largest rows (name, ms, count)."""
    from tapnet_torch.utils.profiling import kernel_rows

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = sorted(kernel_rows(prof), key=lambda r: -r[1])
    return {"ms_per_step": sum(ms for _, ms, _ in rows) / k,
            "launches": sum(n for _, _, n in rows),
            "top": [(name[:60], ms, n) for name, ms, n in rows[:4]]}


def _summary(samples):
    if not samples:
        return {"n": 0}
    col = lambda i: [s[i] for s in samples]
    return {"n": len(samples),
            "sm_mhz": [min(col(0)), statistics.median(col(0)), max(col(0))],
            "power_w": [min(col(2)), statistics.median(col(2)),
                        max(col(2))],
            "temp_c": [min(col(3)), max(col(3))],
            "throttle": sorted(set(col(4)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps-per-call", type=int, default=8)
    ap.add_argument("--out", default="profile_anchor.json",
                    help="the rounds as JSON; the nvidia-smi samples go "
                    "beside it (_smi.csv)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_anchor: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS
    from tapnet_torch import benchmarks as BM
    from tapnet_torch.train.reinforce import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda:0")
    cfg, k, B = CONFIGS["2d-basic"], args.steps_per_call, args.batch
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    smi_path = os.path.splitext(args.out)[0] + "_smi.csv"
    smi_log = open(smi_path, "w")
    smi = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=smi_log, stderr=subprocess.DEVNULL)
    try:
        ts = init_train_state(0, cfg, hidden=128, device=dev)
        step = make_train_step(cfg, batch=B, hidden=128, steps_per_call=k,
                               device=dev)
        box = [ts]

        def call():
            box[0], m = step(box[0])
            return m

        for _ in range(2):
            BM._finish(call())
        rounds = []
        for r in range(args.rounds):
            rec = {"round": r}
            t = time.time()
            env = BM.measure_env_stats(cfg, batch=B, iters=512, runs=3,
                                       device=dev)
            rec["env_load"] = {"wall": env["value"],
                               "device": env.get("device_env_steps_per_s"),
                               "smi": _summary(_smi_samples(
                                   smi_path, t, time.time()))}
            t = time.time()
            walls, _ = BM._timed_windows(lambda i: call(), 20, 3, 1.0)
            rec["wall"] = {"ms_per_step": [1e3 / v / k for v in walls],
                           "t": [t, time.time()]}
            t = time.time()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            for _ in range(3):
                call()
            e1.record()
            torch.cuda.synchronize()
            rec["events"] = {"ms_per_step": e0.elapsed_time(e1) / 3 / k,
                             "t": [t, time.time()]}
            sessions = []
            for _ in range(6):
                t = time.time()
                sessions.append(dict(_session(call, k),
                                     t=[t, time.time()]))
            rec["sessions"] = sessions
            t = time.time()
            bench = BM.measure_train_stats(cfg, batch=B, iters=20, runs=3,
                                           device=dev)
            rec["benchmark"] = {"wall": bench["value"],
                                "device": bench["device_env_steps_per_s"],
                                "device_ms": bench["device_ms_per_step"],
                                "t": [t, time.time()]}
            for part in ("wall", "events", "benchmark"):
                rec[part]["smi"] = _summary(_smi_samples(
                    smi_path, *rec[part]["t"]))
            for s in sessions:
                s["smi"] = _summary(_smi_samples(smi_path, *s["t"]))
            rounds.append(rec)
            wall = statistics.median(rec["wall"]["ms_per_step"])
            print(f"round {r}: wall {wall:.4f} events "
                  f"{rec['events']['ms_per_step']:.4f} ms/step; sessions "
                  f"{[round(x['ms_per_step'], 4) for x in sessions]} "
                  f"launches {[x['launches'] for x in sessions]}; "
                  f"benchmark device ms/step {bench['device_ms_per_step']} "
                  f"device/wall "
                  f"{bench['value'] / bench['device_env_steps_per_s']:.4f}; "
                  f"sm MHz {rec['wall']['smi'].get('sm_mhz')} throttle "
                  f"{rec['wall']['smi'].get('throttle')}", flush=True)
    finally:
        smi.terminate()
        smi.wait(timeout=10)
        smi_log.close()
    reads = [x["ms_per_step"] / statistics.median(
        y["ms_per_step"] for y in r["sessions"]) for r in rounds
        for x in r["sessions"]]
    print(f"sessions against their round's median: {len(reads)} read, "
          f"min {min(reads):.4f}, max {max(reads):.4f}, "
          f"{sum(abs(x - 1) > 0.02 for x in reads)} off by more than 2%",
          flush=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "batch": B,
                   "steps_per_call": k, "rounds": rounds}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
