"""Tracing and throughput, the port of `tapnet_tpu/utils/profiling.py`.

`trace(log_dir)` records a torch.profiler trace (host and, where there is a
card, CUDA activity) and writes it to `log_dir` as a Chrome / Perfetto trace
JSON (read back by `utils/trace_events.py`); `annotate(name)` is a named
range on its timeline (`torch.profiler.record_function`).
`device_time_ms(fn)` is the device time of a call: the JAX package
attributes its `jit_<name>` module events, the port (which has no jit
modules) sums the device time of every kernel, copy and fill the calls
launched (`kernel_rows`, also read by `profile_pack.py`) over the calls.
`StepsPerSecond` is the trainer's env-steps/s counter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.autograd import DeviceType
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


def _device_us(evt) -> float:
    """Device time of a key_averages() row (0 for host-side operator rows
    and for user-annotated ranges such as Optimizer.step, whose device time
    is their kernels', counted under the kernels' names)."""
    if (evt.device_type != DeviceType.CUDA
            or getattr(evt, "is_user_annotation", False)):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def kernel_rows(prof: profile) -> list:
    """[(name, device ms, launches)] of every device row of a finished
    profile (kernels, copies, fills), summed over the profiled window."""
    return [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages() if _device_us(e) > 0]


def device_time_ms(fn, iters: int = 5, warmup: int = 2) -> Optional[float]:
    """Device-busy ms per call of `fn()` (no args), the port's device
    anchor: `warmup` calls, then `iters` calls under torch.profiler ending
    in a synchronize; the sum of their device rows' times (`kernel_rows`;
    one stream, so they do not overlap) over `iters`. It excludes host
    dispatch, as the JAX package's does. One profiler session can misread
    (every kernel long or short by the same factor, or records dropped:
    PERF.md §6), so a caller that holds the reading to a limit takes
    the median of several (`benchmarks._timed_windows`). None where there
    is no CUDA device; on the card a profile that shows no device time
    raises RuntimeError (a device anchor never vanishes quietly)."""
    if not torch.cuda.is_available():
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(ms for _, ms, _ in kernel_rows(prof))
    if busy <= 0.0:
        raise RuntimeError("device_time_ms: the profiler recorded no device "
                           "time for the calls")
    return busy / iters


class StepsPerSecond:
    """Running env-steps/s (and per device) counter for training loops.
    `n_devices` defaults to `torch.cuda.device_count()` where there is a
    card, else 1. The trainer passes its mesh's world size (1 without a
    mesh)."""

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
