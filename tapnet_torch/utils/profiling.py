"""Tracing and throughput, the port of `tapnet_tpu/utils/profiling.py`.

`trace(log_dir)` records a torch.profiler trace (host and, where there is a
card, CUDA activity) and writes it to `log_dir` as a Chrome / Perfetto trace
JSON; `annotate(name)` is a named range on its timeline
(`torch.profiler.record_function`). `StepsPerSecond` is the trainer's
env-steps/s counter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the scope; on exit write `log_dir/trace_<pid>_<ms>.json`."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """A named range that shows on the trace timeline."""
    return record_function(name)


class StepsPerSecond:
    """Running env-steps/s (and per device) counter for training loops.
    `n_devices` defaults to `torch.cuda.device_count()` where there is a
    card, else 1. The trainer passes 1: the port's step runs on one device
    until `parallel/` is ported."""

    def __init__(self, steps_per_batch: int, n_devices: Optional[int] = None):
        self.steps_per_batch = steps_per_batch
        if n_devices is None:
            n_devices = (torch.cuda.device_count()
                         if torch.cuda.is_available() else 1)
        self.n_devices = n_devices
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._batches = 0

    def update(self, n_batches: int = 1):
        self._batches += n_batches

    @property
    def steps_per_s(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._batches * self.steps_per_batch / max(dt, 1e-9)

    @property
    def steps_per_s_per_chip(self) -> float:
        return self.steps_per_s / self.n_devices

    def metrics(self) -> dict:
        sps = self.steps_per_s  # one snapshot: both values share one dt
        return {"env_steps_per_s": round(sps, 1),
                "env_steps_per_s_per_chip": round(sps / self.n_devices, 1)}
