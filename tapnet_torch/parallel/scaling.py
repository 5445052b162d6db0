"""Ranks on demand and the scaling-efficiency harness, the port of
`tapnet_tpu/parallel/scaling.py`.

`run_ranks(fn, world, ...)` runs `fn(mesh, *args)` in `world` spawned
processes joined in one process group (gloo on the CPU, NCCL on the card,
rank r on cuda:r) and returns their results in rank order.
`scaling_report` measures the train step's throughput at growing world
sizes, each count its own group of spawned ranks, and reports efficiency
against linear scaling from the smallest count, as the JAX harness does.
"""

from __future__ import annotations

import datetime
import io
import os
import queue
import socket
import time
import traceback
from typing import List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tapnet_torch.config import TAPConfig
from tapnet_torch.parallel.mesh import DataMesh, data_mesh


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, timeout_s, args, results):
    """One spawned rank: join the group, build its mesh, run fn, send back
    (rank, ok, result or traceback)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            backend = "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        # as bytes: a tensor put on the queue is shared memory that goes
        # with this process
        buf = io.BytesIO()
        torch.save(fn(data_mesh(dev), *args), buf)
        results.put((rank, True, buf.getvalue()))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), device="cuda",
              timeout_s: float = 600.0) -> list:
    """Run `fn(mesh, *args)` in `world` spawned ranks; returns the results
    in rank order. `fn` must be importable (spawn pickles it by name) and
    its result picklable (CPU tensors, numpy, numbers). A rank that fails
    raises RuntimeError with its traceback; a run past `timeout_s` kills
    every rank and raises TimeoutError."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} CUDA devices; "
                           f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, str(device), timeout_s,
                               tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {world} ranks did not finish "
                                   f"in {timeout_s} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: a rank exited with "
                                       f"{dead[0]} before reporting")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{res}")
            out[rank] = torch.load(io.BytesIO(res), weights_only=False)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


def measure_train_steps_per_s(cfg: TAPConfig, mesh: DataMesh, batch: int,
                              hidden: int = 64, iters: int = 5) -> float:
    """Train steps/s of the sharded step at global `batch` on `mesh` (one
    step first, untimed; every rank runs it)."""
    from tapnet_torch.parallel.distributed import broadcast_from_main
    from tapnet_torch.train.reinforce import init_train_state, make_train_step

    ts = broadcast_from_main(init_train_state(0, cfg, hidden,
                                              device=mesh.device))
    step = make_train_step(cfg, batch=batch, hidden=hidden, mesh=mesh)
    ts, m = step(ts)
    float(m["loss_actor"])
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, m = step(ts)
    float(m["loss_actor"])   # a host read ends the window on every device
    return iters / (time.perf_counter() - t0)


def _measure_rank(mesh: DataMesh, cfg, batch, hidden, iters) -> float:
    return measure_train_steps_per_s(cfg, mesh, batch, hidden, iters)


def scaling_report(cfg: TAPConfig, device_counts: Sequence[int],
                   per_device_batch: int = 32, hidden: int = 64,
                   iters: int = 5, device="cuda") -> List[dict]:
    """Weak-scaling sweep: the batch grows with the world size; each count
    runs as its own group of spawned ranks, and efficiency is measured
    against linear scaling of per-device throughput from the smallest
    count."""
    rows, base_per_dev = [], None
    for n in sorted(device_counts):
        batch = per_device_batch * n
        sps = run_ranks(_measure_rank, n,
                        (cfg, batch, hidden, iters), device)[0]
        inst_per_s = sps * batch
        per_dev = inst_per_s / n
        if base_per_dev is None:
            base_per_dev = per_dev
        rows.append({
            "devices": n,
            "batch": batch,
            "train_steps_per_s": round(sps, 3),
            "instances_per_s": round(inst_per_s, 1),
            "efficiency": round(per_dev / base_per_dev, 3),
        })
    return rows
