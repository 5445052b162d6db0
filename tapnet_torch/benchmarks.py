"""Throughput measurement of the port, the port of `tapnet_tpu/benchmarks.py`.

    python -m tapnet_torch.benchmarks [--detail] [--configs a,b]
        [--out chiprun_out/bench_detail.json]

The same functions under the same names, with the same row keys. Every
`measure_*_stats` function runs `runs` independent timed windows and
reports {value=median, min, max, runs, iters, batch}, so run-to-run
variance is explicit in each number. A window ends with
`torch.cuda.synchronize()` and a host read of one result, so it never
closes before the work it timed. The baselines are the reference's own
mechanism on the host: the per-instance Python step loop
(`oracle/`, every threefry draw computed before the timed loop) and the
C++ env tier single-threaded (`native/`); `vs_baseline` divides by the
first.

The functions run on `cuda` unless the caller passes `device="cpu"`. On
the card each row also carries the JAX rows' device anchor from
`utils.profiling.device_time_ms` (device-busy ms per call: a profiled
call's summed kernel times; the median of as many readings as timed
windows, taken after them; the profiler stretches kernels, so where the
device is saturated the anchor can read ~1% above the unprofiled wall
time); on the CPU there is none. The
JAX functions' flag that asks for the anchor is called `device` there and
`anchor` here, since `device` is where the port runs. Where the JAX
package groups rollouts per dispatch as a `lax.scan`, the port's heuristic
rollout row replays one CUDA graph of `group` K4 rollouts (`_env_call`);
the general path and the policy rollout run their groups eagerly.

`main()` prints the one-line headline record of the repo-root `bench.py`
for the port and, with `--detail`, writes the per-config rows to `--out`
(never to the JAX package's BENCH_DETAIL.json).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig

DETAIL_OUT = os.path.join("chiprun_out", "bench_detail.json")


def _stats(vals, batch, iters):
    return {"value": round(statistics.median(vals), 1),
            "min": round(min(vals), 1), "max": round(max(vals), 1),
            "runs": len(vals), "iters": iters, "batch": batch}


def _device(device) -> torch.device:
    from tapnet_torch.train.reinforce import resolve_device
    return resolve_device(device)


def _anchor(fn, dev: torch.device, per: int = 1):
    """On the card a reader of the device-busy ms per unit of a call of
    fn, `per` units a call (`utils.profiling.device_time_ms` of one call,
    no warm-up: it follows the timed windows; a profiler failure raises),
    for `_timed_windows`; None on the CPU."""
    if dev.type != "cuda":
        return None
    from tapnet_torch.utils.profiling import device_time_ms
    return lambda: device_time_ms(fn, iters=1, warmup=0) / per


def _first_leaf(out):
    """The first tensor or array of a result (tuples, lists, dicts)."""
    if isinstance(out, (torch.Tensor, np.ndarray)):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    for x in out if isinstance(out, (tuple, list)) else ():
        leaf = _first_leaf(x)
        if leaf is not None:
            return leaf
    return None


def _finish(out):
    """Wait for the device, then read one value of `out` on the host."""
    leaf = _first_leaf(out)
    if isinstance(leaf, torch.Tensor):
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        leaf.reshape(-1)[0].item()
    elif leaf is not None:
        np.asarray(leaf).reshape(-1)[:1].tolist()


def _key_groups(n: int, group: int, batch: int, dev) -> torch.Tensor:
    """int64[n, group, batch, 2]: entry [i, g] is split(key(1 + i * group +
    g), batch), the JAX benchmarks' key batches, all made at once."""
    seeds = 1 + torch.arange(n * group, dtype=torch.int64, device=dev)
    base = torch.stack([torch.zeros_like(seeds), seeds], -1)
    return R.split(base, batch).reshape(n, group, batch, 2)


def measure_oracle_steps_per_s(cfg: TAPConfig, n_instances: int = 8) -> float:
    """Reference mechanism: per-instance Python loop (steps/s, one process).

    All threefry draws are computed before the timed region
    (`rollout_rbits`, the exact inline stream, so the trajectories are
    bit-equal to drawing inline): the timed loop is pure numpy env
    stepping, the honest "reference mechanism" cost."""
    from tapnet_torch.oracle import generate_instance, oracle_rollout
    from tapnet_torch.oracle.rollout import rollout_rbits

    keys = R.split(R.key(0), n_instances)
    instances = [generate_instance(k, cfg) for k in keys]
    all_rbits = [rollout_rbits(k, cfg) for k in keys]
    t0 = time.perf_counter()
    steps = 0
    for inst, rb in zip(instances, all_rbits):
        _, actions, _ = oracle_rollout(inst, cfg, policy="random", rbits=rb)
        steps += int((np.asarray(actions) >= 0).sum())
    return steps / (time.perf_counter() - t0)


def measure_native_steps_per_s(cfg: TAPConfig, n_instances: int = 4096,
                               n_threads: int = 1) -> float:
    """Reference mechanism on the optimized host path: the C++ env tier
    (`native/tapenv.cc`, bit-equal to the oracle), single-threaded by
    default: vs_baseline's anchor against the best CPU implementation of
    the per-instance loop, not a Python interpreter. NaN without g++."""
    from tapnet_torch import native
    from tapnet_torch.env import core as E
    from tapnet_torch.env.sampler import sample_batch

    if not native.is_available():
        return float("nan")
    key = R.key(0)
    instances = sample_batch(key, n_instances, cfg)
    rbits = E.policy_bits(R.split(key, n_instances), cfg, "random").numpy()
    # warm (thread pool spin-up, page faults)
    native.rollout_batch(instances, cfg, policy="random", rbits=rbits,
                         n_threads=n_threads)
    t0 = time.perf_counter()
    _, actions, _ = native.rollout_batch(instances, cfg, policy="random",
                                         rbits=rbits, n_threads=n_threads)
    dt = time.perf_counter() - t0
    return int((actions >= 0).sum()) / dt


def measure_pack_stats(cfg: TAPConfig, batch: int = 4096, hidden: int = 128,
                       iters: int = 10, runs: int = 3, policy: str = "greedy",
                       device="cuda") -> dict:
    """Serving surface END TO END: instances -> executable PackingPlan via
    `pack()`, including the plan's host copies (every timed call pays the
    device -> host sync a serving caller sees). Reported as env-steps/s and
    plans (instances)/s; on the card with the device anchor of a call."""
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.infer import pack
    from tapnet_torch.models.tapnet import init_params

    dev = _device(device)
    actor = (init_params(0, cfg, hidden, dev)
             if policy in ("greedy", "sample", "best") else None)
    instances = sample_batch(R.key(0, dev), batch, cfg)

    def run_iter(i):
        plan = pack(instances, cfg, actor, policy=policy, key=i, device=dev)
        return plan.rewards          # numpy: already on the host

    run_iter(0)
    vals, anchor = _timed_windows(run_iter, iters, runs,
                                  batch * cfg.num_blocks,
                                  _anchor(lambda: run_iter(0), dev))
    out = _stats(vals, batch, iters)
    out["policy"] = policy
    out["plans_per_s"] = round(out["value"] / cfg.num_blocks, 1)
    if anchor:
        out["device_ms_per_batch"] = round(anchor, 3)
        out["device_env_steps_per_s"] = round(
            batch * cfg.num_blocks / (anchor / 1e3), 1)
    return out


def measure_native_thread_scaling(cfg: TAPConfig, n_instances: int = 4096,
                                  threads=(1, 2, 4, 8, 16)) -> dict:
    """env-steps/s of the C++ tier by thread count (serving hosts without
    an accelerator runtime). {} without g++."""
    out = {}
    for t in threads:
        v = measure_native_steps_per_s(cfg, n_instances, n_threads=t)
        if v != v:
            return {}
        out[str(t)] = round(v, 1)
    return out


def _timed_windows(run_iter, iters: int, runs: int, steps_per_iter: float,
                   anchor=None):
    """run_iter(i) launches one iteration; returns (env-steps/s per window,
    the device anchor or None).

    A window ends with `torch.cuda.synchronize()` and a host read of one
    leaf of the last result (`_finish`): the JAX package found windows that
    ended before the work had (a train-step window 5x above its device
    bound) until it read bytes back; a read cannot return early. With an
    `anchor` reader (`_anchor`, on the card), `runs` profiled readings
    follow the windows and the anchor is their median, which no one
    profiler session can swing (one can misread: PERF.md §6). The
    readings come after the last window, so no profiler session runs
    between the timed windows."""
    vals = []
    for r in range(runs):
        t0 = time.perf_counter()
        out = None
        for i in range(iters):
            out = run_iter(r * iters + i)
        _finish(out)
        vals.append(steps_per_iter * iters / (time.perf_counter() - t0))
    if anchor is None:
        return vals, None
    return vals, statistics.median([anchor() for _ in range(runs)])


def _train_run(cfg, batch, hidden, iters, runs, steps_per_call=8,
               anchor=False, device="cuda"):
    """steps_per_call=8: the production dispatch grouping (on the card one
    captured step replayed 8 times a call, `reinforce.GraphedSteps`; on the
    CPU 8 eager steps). anchor=True also returns the device anchor
    (`_anchor`: device ms per OPTIMIZER STEP, a call's device time /
    steps_per_call, and the idle share), None on the CPU."""
    from tapnet_torch.train.reinforce import init_train_state, make_train_step

    dev = _device(device)
    ts = init_train_state(0, cfg, hidden=hidden, device=dev)
    step = make_train_step(cfg, batch=batch, hidden=hidden,
                           steps_per_call=steps_per_call, device=dev)
    for _ in range(2):   # a capture on the card, then a steady call
        ts, m = step(ts)
        _finish(m)
    box = [ts]

    def run_iter(_):
        box[0], m = step(box[0])
        return m

    vals, device_ms = _timed_windows(
        run_iter, iters, runs, batch * cfg.num_blocks * steps_per_call,
        _anchor(lambda: run_iter(0), dev, steps_per_call) if anchor
        else None)
    return (vals, device_ms) if anchor else vals


def measure_train_steps_per_s(cfg: TAPConfig, batch: int = 4096,
                              hidden: int = 128, iters: int = 10,
                              device="cuda") -> float:
    """Learned-policy REINFORCE train step: env-steps/s/chip, one full
    sample -> rollout -> replay -> grad -> Adam step counted as batch x
    num_blocks env steps."""
    return _train_run(cfg, batch, hidden, iters, runs=1, device=device)[0]


def measure_train_stats(cfg: TAPConfig, batch: int = 4096, hidden: int = 128,
                        iters: int = 10, runs: int = 3, anchor: bool = True,
                        device="cuda") -> dict:
    """Wall-clock stats and, on the card, the device anchor:
    device_ms_per_step and the device-time env-steps/s it implies."""
    if not anchor:
        return _stats(_train_run(cfg, batch, hidden, iters, runs,
                                 device=device), batch, iters)
    vals, anchor = _train_run(cfg, batch, hidden, iters, runs, anchor=True,
                              device=device)
    out = _stats(vals, batch, iters)
    if anchor:
        out["device_ms_per_step"] = round(anchor, 3)
        out["device_env_steps_per_s"] = round(
            batch * cfg.num_blocks / (anchor / 1e3), 1)
    return out


class _GraphedRollouts:
    """`group` rollouts and their checksums as one CUDA graph: a call copies
    its keys [group, B, 2] into the graph's static input and replays it.
    Captured at the first call, after one eager warm-up call on a side
    stream (kernels built, allocator warm); nothing inside reads the host."""

    def __init__(self, eager, keys_shape, dev):
        self.eager, self.dev = eager, dev
        self.keys = torch.zeros(keys_shape, dtype=torch.int64, device=dev)
        self.graph = self.out = None

    def __call__(self, keys_g):
        self.keys.copy_(keys_g)
        if self.graph is None:
            side = torch.cuda.Stream(self.dev)
            side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(side):
                self.eager(self.keys)
            torch.cuda.current_stream(self.dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.eager(self.keys)
        self.graph.replay()
        return self.out


def _env_call(cfg: TAPConfig, instances, group: int, fused: bool, dev,
              graph: bool = True):
    """call(keys_g [group, B, 2]) -> (reward checksum float32, action
    checksum int64) of `group` `random` rollouts of `instances`, one per key
    batch: K4 (`ops.env.fused_rollout_batch`) when `fused`, else the general
    path (`env.core.rollout_batch`). The checksums accumulate on the device,
    so no rollout is dead work. On the card a fused call is one CUDA graph
    of the group (`graph=False`: the same rollouts eagerly)."""
    from tapnet_torch.env import core as E
    from tapnet_torch.ops.env import fused_rollout_batch

    run = fused_rollout_batch if fused else E.rollout_batch

    def eager(keys_g):
        acc_r = torch.zeros((), dtype=torch.float32, device=dev)
        acc_a = torch.zeros((), dtype=torch.int64, device=dev)
        for g in range(group):
            _, a, r = run(instances, keys_g[g], cfg, "random")
            acc_r += r.sum()
            acc_a += a.sum()
        return acc_r, acc_a

    if fused and graph and dev.type == "cuda":
        B = instances.dims.shape[0]
        return _GraphedRollouts(eager, (group, B, 2), dev)
    return eager


def _env_run(cfg, batch, iters, runs, fused, group=None, anchor=False,
             device="cuda"):
    """Rollout throughput with `group` rollouts per call (`_env_call`).

    `fused=None` takes K4 where `train.rollout.routes` does (on the card,
    where the kernel covers the config). iters is the TOTAL rollout count
    per window: iters // group calls. group defaults to 128 for K4 (one
    graph of 128 rollouts; a launch-bound rollout would otherwise time the
    host) and 4 for the general path."""
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.train.rollout import routes

    dev = _device(device)
    if fused is None:
        fused = routes(cfg, dev.type == "cuda").rollout
    if group is None:
        group = 128 if fused else 4
    group = max(1, min(group, iters))

    instances = sample_batch(R.key(0, dev), batch, cfg)
    n_calls = max(1, iters // group)
    key_groups = _key_groups(n_calls * runs, group, batch, dev)
    call = _env_call(cfg, instances, group, fused, dev)
    _finish(call(key_groups[0]))   # capture on the card, kernels built

    steps_per_rollout = int(instances.n_total.sum())
    vals, device_ms = _timed_windows(
        lambda i: call(key_groups[i]), n_calls, runs,
        steps_per_rollout * group,
        _anchor(lambda: call(key_groups[0]), dev, group) if anchor else None)
    return (vals, device_ms, steps_per_rollout) if anchor else vals


def measure_env_steps_per_s(cfg: TAPConfig, batch: int, iters: int = 10,
                            fused: bool = None, device="cuda") -> float:
    """Batched heuristic rollouts (`random`), env-steps/s: K4 where it
    covers the config on the card (bit-equal to the general path), else
    the general path; fused=False measures the general path."""
    return _env_run(cfg, batch, iters, 1, fused, device=device)[0]


def measure_env_stats(cfg: TAPConfig, batch: int, iters: int = 50,
                      runs: int = 3, fused: bool = None, anchor: bool = True,
                      device="cuda") -> dict:
    """Wall-clock stats and, on the card, the device anchor:
    device_ms_per_rollout and the device-time env-steps/s it implies."""
    if not anchor:
        return _stats(_env_run(cfg, batch, iters, runs, fused,
                               device=device), batch, iters)
    vals, anchor, steps = _env_run(cfg, batch, iters, runs, fused,
                                   anchor=True, device=device)
    out = _stats(vals, batch, iters)
    if anchor:
        out["device_ms_per_rollout"] = round(anchor, 4)
        out["device_env_steps_per_s"] = round(steps / (anchor / 1e3), 1)
    return out


def measure_policy_rollout_stats(cfg: TAPConfig, batch: int = 4096,
                                 hidden: int = 128, iters: int = 20,
                                 runs: int = 3, step_kernel: bool = None,
                                 group: int = 4, device="cuda") -> dict:
    """Learned-policy (actor-in-the-loop) sampled rollout throughput, no
    gradients: the train step's inference phase alone
    (`rollout_batch_record`, whose decode steps take K2, else K1, by
    `train.rollout.routes`). Counted as batch x num_blocks env steps per
    rollout; `group` rollouts per timed call, eagerly, their actions and
    logp checksummed on the device."""
    from tapnet_torch.env.sampler import sample_batch
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.train.rollout import rollout_batch_record

    dev = _device(device)
    actor = init_params(0, cfg, hidden, dev)
    instances = sample_batch(R.key(0, dev), batch, cfg)
    group = max(1, min(group, iters))

    def call(keys_g):
        acc_a = torch.zeros((), dtype=torch.int64, device=dev)
        acc_l = torch.zeros((), dtype=torch.float32, device=dev)
        for g in range(group):
            _, rec, logp = rollout_batch_record(actor, instances, keys_g[g],
                                                cfg, step_kernel=step_kernel)
            acc_a += rec.action.sum()
            acc_l += logp.sum()
        return acc_a, acc_l

    n_calls = max(1, iters // group)
    key_groups = _key_groups(n_calls * runs, group, batch, dev)
    _finish(call(key_groups[0]))
    vals, anchor = _timed_windows(lambda i: call(key_groups[i]), n_calls,
                                  runs, batch * cfg.num_blocks * group,
                                  _anchor(lambda: call(key_groups[0]), dev,
                                          group))
    out = _stats(vals, batch, iters)
    if anchor:
        out["device_ms_per_rollout"] = round(anchor, 3)
        out["device_env_steps_per_s"] = round(
            batch * cfg.num_blocks / (anchor / 1e3), 1)
    return out


# the non-lb placement-rule variants of the repo-root bench.py: exact mcs
# scoring and a finite target-height cap
VARIANTS = {
    "2d-mcs-soft": TAPConfig(reward_type="C+P+S-mcs-soft"),
    "2d-mcs-hard": TAPConfig(reward_type="C+P+S-mcs-hard"),
    "2d-capped-hard": TAPConfig(target_height=12, reward_type="C+P+S-lb-hard"),
    "3d-mcs-hard": TAPConfig(dim=3, container_width=8, container_depth=8,
                             container_height=8, target_width=8,
                             target_depth=8, allow_rot=True,
                             reward_type="C+P+S-mcs-hard"),
}


def headline(batch: int = 4096, env_iters: int = 512, train_iters: int = 20,
             runs: int = 3, device="cuda", baseline: float = None,
             native_1t: float = None) -> dict:
    """The one-line record of bench.py for the port: 2d-basic heuristic
    rollouts (K4 graphs on the card) and the train step at
    steps_per_call=8, against the oracle and native baselines. `value` is
    the device-anchored env-steps/s where there is an anchor (the card),
    else the wall rate."""
    from tapnet_torch.config import CONFIGS

    dev = _device(device)
    cfg = CONFIGS["2d-basic"]
    if baseline is None:
        baseline = measure_oracle_steps_per_s(cfg)
    if native_1t is None:
        native_1t = measure_native_steps_per_s(cfg, n_threads=1)
    if native_1t != native_1t:   # NaN without g++: keep the JSON valid
        native_1t = None
    env = measure_env_stats(cfg, batch=batch, iters=env_iters, runs=runs,
                            device=dev)
    train = measure_train_stats(cfg, batch=batch, iters=train_iters,
                                runs=runs, device=dev)
    dev_rate = env.get("device_env_steps_per_s")
    value = dev_rate if dev_rate else env["value"]
    rec = {
        "metric": f"env-steps/s/chip, device-anchored (2D TAP, batch "
                  f"{batch}, full mask+policy+step rollout)",
        "value": value,
        "unit": "env-steps/s",
        "vs_baseline": round(value / baseline, 2),
        "vs_native_1thread": (round(value / native_1t, 2)
                              if native_1t else None),
        "host_oracle_steps_per_s": round(baseline, 1),
        "host_native_1t_steps_per_s": (round(native_1t, 1)
                                       if native_1t else None),
        "wall_env_steps_per_s": env["value"],
        "train_env_steps_per_s": train["value"],
        "env_min": env["min"], "env_max": env["max"],
        "train_min": train["min"], "train_max": train["max"],
        "runs": env["runs"],
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if "device_ms_per_rollout" in env:
        rec["device_ms"] = env["device_ms_per_rollout"]
        rec["device_env_steps_per_s"] = env["device_env_steps_per_s"]
    if "device_ms_per_step" in train:
        rec["train_device_ms_per_step"] = train["device_ms_per_step"]
        rec["train_device_env_steps_per_s"] = train["device_env_steps_per_s"]
    return rec


def main(argv=None) -> int:
    from tapnet_torch.config import CONFIGS
    from tapnet_torch.train.rollout import routes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--detail", action="store_true",
                    help="also write the per-config rows to --out")
    ap.add_argument("--configs", default=None,
                    help="comma-separated config subset for --detail (other "
                         "configs' rows are kept from an existing --out)")
    ap.add_argument("--out", default=DETAIL_OUT)
    args = ap.parse_args(argv)

    all_named = dict(CONFIGS, **VARIANTS)
    if args.configs:
        unknown = set(args.configs.split(",")) - set(all_named)
        if unknown:
            ap.error(f"unknown config(s): {sorted(unknown)}; choose from "
                     f"{sorted(all_named)}")
    dev = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = CONFIGS["2d-basic"]
    baseline = measure_oracle_steps_per_s(cfg)
    native_1t = measure_native_steps_per_s(cfg, n_threads=1)
    if native_1t != native_1t:
        native_1t = None
    print(json.dumps(headline(device=dev, baseline=baseline,
                              native_1t=native_1t)), flush=True)
    if not args.detail:
        return 0

    B, out = 4096, args.out
    detail = {"host_oracle_steps_per_s": round(baseline, 1),
              "host_native_1t_steps_per_s": (round(native_1t, 1)
                                             if native_1t else None),
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "configs": {}, "variants": {}}
    if args.configs and os.path.exists(out):
        with open(out) as f:
            kept = json.load(f)
        detail["configs"] = kept.get("configs", {})
        detail["variants"] = kept.get("variants", {})
    subset = set(args.configs.split(",")) if args.configs else set(all_named)
    on_card = dev.type == "cuda"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    def flush():
        with open(out, "w") as f:
            json.dump(detail, f, indent=2)
            f.write("\n")

    for name, c in all_named.items():
        if name not in subset:
            continue
        section = detail["configs" if name in CONFIGS else "variants"]
        row = section[name] = {}   # rebuilt wholesale: no stale fields
        r = routes(c, on_card)
        if r.rollout:
            row["heuristic_fused"] = measure_env_stats(
                c, batch=B, iters=512, runs=3, fused=True, device=dev)
            flush()
        row["general_path"] = measure_env_stats(
            c, batch=B, iters=50, runs=3, fused=False, device=dev)
        flush()
        if r.decode != "general":
            row["policy_rollout"] = measure_policy_rollout_stats(
                c, batch=B, iters=20, runs=3, device=dev)
            flush()
        row["train_step"] = measure_train_stats(c, batch=B, iters=10, runs=3,
                                                device=dev)
        flush()
        print(f"{name}: {row}", file=sys.stderr)

    # the serving surface: pack() end to end (learned greedy, best-of-16,
    # the heuristic on K4), and the C++ tier's thread scaling
    if not args.configs or "2d-basic" in subset:
        serving = detail["serving"] = {}
        if on_card:
            for policy in ("greedy", "best", "first"):
                serving[f"2d-basic/{policy}"] = measure_pack_stats(
                    cfg, batch=B, iters=10, runs=3, policy=policy,
                    device=dev)
                flush()
        detail["native_thread_scaling"] = measure_native_thread_scaling(cfg)
        flush()
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
