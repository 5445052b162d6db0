"""Structured metrics: JSONL scalars, the port of
`tapnet_tpu/train/metrics.py`. One JSON object per logical step; tensors
are read on the host only at log time. TensorBoard summaries are not
ported (`tb_dir` raises)."""

from __future__ import annotations

import json
import os
import time
from typing import IO, Mapping, Optional

import torch


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tb_dir: Optional[str] = None):
        if tb_dir:
            raise NotImplementedError("TensorBoard summaries are not ported "
                                      "(ROADMAP.md, port Queue 1)")
        self.echo = echo
        self._f: Optional[IO[str]] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Mapping[str, object], **extra):
        rec = {"step": step, "wall": round(time.time() - self._t0, 3)}
        for k, v in {**metrics, **extra}.items():
            rec[k] = float(v) if isinstance(v, torch.Tensor) else v
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
        return rec

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
