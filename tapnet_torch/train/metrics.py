"""Structured metrics: JSONL scalars and TensorBoard event files, the port
of `tapnet_tpu/train/metrics.py`. One JSON object per logical step;
tensors are read on the host only at log time.

With `tb_dir` the logger also writes the file the JAX logger writes
through `flax.metrics.tensorboard`, with no package: an
`events.out.tfevents.<time>.<host>.<pid>.<n>.v2` file of TFRecords (a u64
length, its masked CRC-32C, the bytes, their masked CRC-32C) holding
`Event` protobufs encoded by hand: first the file version, then one event
per numeric value of each record but `step` (wall included), a scalar
summary of a float32 tensor under the "scalars" plugin. `read_scalars`
reads such a file back, checking both CRCs of every record.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import time
from typing import IO, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven: crc32c(b"123456789") is
    0xE3069283."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: the CRC rotated right by 15, plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# protobuf wire format: a key is varint(field << 3 | wire type)

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while n > 0x7F:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _int(field: int, n: int) -> bytes:
    return _varint(field << 3) + _varint(n)


def _double(field: int, x: float) -> bytes:
    return _varint(field << 3 | 1) + struct.pack("<d", x)


def _bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    v = 0
    for shift in itertools.count(0, 7):
        v |= (buf[i] & 0x7F) << shift
        i += 1
        if not buf[i - 1] & 0x80:
            return v, i


def _fields(buf: bytes) -> Iterator[Tuple[int, object]]:
    """(field, value) of a message: an int for a varint, bytes otherwise."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire in (1, 2, 5):
            n = {1: 8, 5: 4}.get(wire)
            if n is None:
                n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire} not supported")
        yield field, v


# Event: wall_time 1 (double), step 2, file_version 3, summary 5,
# source_metadata 10 (writer 1); Summary.value 1; Value: tag 1, tensor 8,
# metadata 9; TensorProto: dtype 1 (DT_FLOAT = 1), tensor_shape 2,
# tensor_content 4; SummaryMetadata.plugin_data 1 -> plugin_name 1

def scalar_event(tag: str, value: float, step: int, wall: float) -> bytes:
    tensor = (_int(1, 1) + _bytes(2, b"")
              + _bytes(4, np.float32(value).tobytes()))
    val = (_bytes(1, tag.encode()) + _bytes(8, tensor)
           + _bytes(9, _bytes(1, _bytes(1, b"scalars"))))
    return (_double(1, wall) + (_int(2, step) if step else b"")
            + _bytes(5, _bytes(1, val)))


def _record(data: bytes) -> bytes:
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


_writers = itertools.count()


class EventsWriter:
    """An events file in `log_dir` (created if missing), opened with the
    file-version event; `scalar` appends one scalar event, `close`
    flushes and closes."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.{next(_writers)}.v2")
        self._f = open(self.path, "wb")
        self._f.write(_record(
            _double(1, time.time()) + _bytes(3, b"brain.Event:2")
            + _bytes(10, _bytes(1, b"tapnet_torch.train.metrics"))))

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(_record(scalar_event(tag, value, step, time.time())))

    def close(self):
        self._f.close()


def read_events(path: str) -> List[bytes]:
    """The records of a TFRecord file, both CRCs of each checked."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (c_head,) = struct.unpack("<I", data[i + 8:i + 12])
        rec = data[i + 12:i + 12 + n]
        (c_rec,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if c_head != masked_crc32c(head) or c_rec != masked_crc32c(rec):
            raise ValueError(f"{path}: bad CRC in the record at byte {i}")
        out.append(rec)
        i += 16 + n
    return out


def read_scalars(path: str) -> List[Tuple[str, int, float]]:
    """[(tag, step, value)] of every scalar summary value in an events
    file, in file order (a float32 tensor's content or a simple_value)."""
    out = []
    for rec in read_events(path):
        ev = dict(_fields(rec))
        for field, val in _fields(ev.get(5, b"")):
            if field != 1:
                continue
            v = dict(_fields(val))
            if 8 in v:
                x = np.frombuffer(dict(_fields(v[8]))[4], "<f4")[0]
            else:
                x = np.frombuffer(v[2], "<f4")[0]
            out.append((v[1].decode(), ev.get(2, 0), float(x)))
    return out


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tb_dir: Optional[str] = None):
        self.echo = echo
        self._f: Optional[IO[str]] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._tb = EventsWriter(tb_dir) if tb_dir else None
        self._t0 = time.time()

    def log(self, step: int, metrics: Mapping[str, object], **extra):
        rec = {"step": step, "wall": round(time.time() - self._t0, 3)}
        for k, v in {**metrics, **extra}.items():
            rec[k] = float(v) if isinstance(v, torch.Tensor) else v
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.scalar(k, v, step)
        if self.echo:
            print(line, flush=True)
        return rec

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
