"""Reader of the port's profiler traces: device time by kernel name.

The counterpart of `tapnet_tpu/utils/xplane.py`. The JAX package's profiler
writes XSpace protobufs (`*.xplane.pb`), which that module parses; PyTorch
has no xplane: `torch.profiler` exports a Chrome / Perfetto trace JSON
(`utils.profiling.trace` writes `trace_<pid>_<ms>.json`), whose complete
events ("ph": "X") carry a category, a name and a duration in µs. So the
module takes another name. Device events are the categories in
`DEVICE_CATS` (kernels, copies, fills on the card); a trace taken on the
CPU has none.

- `latest_trace(trace_dir)`: the newest trace JSON under a directory;
- `op_times(path)`: {category: {name: total ms}} of one trace file;
- `device_op_times(trace_dir)`: {kernel name: total device ms}.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def latest_trace(trace_dir: str) -> str:
    """Newest *.json under `trace_dir` (recursively), by (mtime, path) so
    the choice is deterministic when files share an mtime."""
    cands = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True),
                   key=lambda p: (os.path.getmtime(p), p))
    if not cands:
        raise FileNotFoundError(f"no trace JSON under {trace_dir}")
    return cands[-1]


def op_times(path: str) -> dict:
    """{category: {name: total_ms}} over the complete events of a trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            out[e.get("cat", "")][e.get("name", "")] += float(e["dur"]) / 1e3
    return {cat: dict(tot) for cat, tot in out.items()}


def device_op_times(trace_dir: str) -> dict:
    """{name: total device ms} of the device events of a trace file, or of
    the newest trace under a directory. Raises ValueError when the trace
    holds no device event (a trace taken on the CPU)."""
    path = latest_trace(trace_dir) if os.path.isdir(trace_dir) else trace_dir
    tot = defaultdict(float)
    for cat, ops in op_times(path).items():
        if cat in DEVICE_CATS:
            for name, ms in ops.items():
                tot[name] += ms
    if not tot:
        raise ValueError(f"no device events in {path}")
    return dict(tot)

