"""Native (C++) TAP environment: ctypes bindings and build-on-demand, the
port's copy of `tapnet_tpu/native/`.

`tapenv.cc` is a byte-for-byte copy of `tapnet_tpu/native/tapenv.cc` (see it
for the role of this tier); this binding builds it with g++ at first use
into `tapnet_torch/_build/libtapenv-<hash>.so` (the hash covers the source
and the flags, so an edited source is rebuilt) and never touches the JAX
package's library. It takes the port's `Instance` of CPU tensors or numpy
arrays and returns numpy, so serving hosts can validate or generate
trajectories without an accelerator runtime. `rollout_batch` mirrors
`env.core.rollout_batch` / `oracle_rollout` bit for bit
(tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.types import EnvState, Instance

_SRC = Path(__file__).resolve().parent / "tapenv.cc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_LIB = None
_lock = threading.Lock()


def _target() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"libtapenv-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile tapenv.cc (skipped when the library of this source exists);
    returns the library's path. Raises FileNotFoundError without g++ and
    CalledProcessError when the compile fails."""
    out = _target()
    if out.exists():
        return str(out)
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found: the native env needs a C++ "
                                "compiler on PATH")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return str(out)


def is_available() -> bool:
    """False when there is no g++; else builds and loads the library (a
    failed compile raises)."""
    if shutil.which("g++") is None and not _target().exists():
        return False
    _load()
    return True


def _load():
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        c_int = ctypes.c_int
        lib.tap_rollout_batch.restype = c_int
        lib.tap_rollout_batch.argtypes = [
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
            c_int, c_int, c_int,
            i32p, i32p, u8p, u8p, c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            i32p, i32p, u8p, i32p, i32p, c_int,
        ]
        _LIB = lib
        return lib


_POLICIES = {"replay": 0, "first": 1, "random": 2}


def _host(x, dtype) -> np.ndarray:
    """A C-contiguous numpy copy (or view) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype)


def rollout_batch(instances: Instance, cfg: TAPConfig, policy: str = "first",
                  rbits=None, actions=None, n_threads: int = 0
                  ) -> Tuple[EnvState, np.ndarray, np.ndarray]:
    """Roll a batch natively. Returns (EnvState of numpy arrays, actions
    int32[B, N], terms int32[B, 5]).

    policy "random" needs rbits [B, N] (the threefry draws
    bits(fold_in(key_b, t)) as uint32 or int64 in [0, 2^32), e.g.
    `env.core.policy_bits`; the same stream as the batched env, SPEC.md
    §10); policy "replay" needs actions [B, N] (infeasible entries become
    no-ops and read back as -1: plan validation). n_threads <= 0: one per
    core, at most 32.
    """
    lib = _load()
    dims = _host(instances.dims, np.int32)
    n_total = _host(instances.n_total, np.int32).reshape(-1)
    up = _host(instances.up, np.uint8)
    rot = _host(instances.rot, np.uint8)
    B, N = dims.shape[0], cfg.num_blocks
    Wt, Dt, C = cfg.target_width, cfg.target_depth, cfg.num_containers

    pol = _POLICIES[policy]
    a_in = r_in = None
    if policy == "replay":
        if actions is None:
            raise ValueError("replay needs actions")
        a_in = _host(actions, np.int32)
        if a_in.shape != (B, N):
            raise ValueError(f"actions {a_in.shape} != {(B, N)}")
    if policy == "random":
        if rbits is None:
            raise ValueError("random needs rbits")
        r_in = _host(rbits, np.int64).astype(np.uint32)
        if r_in.shape != (B, N):
            raise ValueError(f"rbits {r_in.shape} != {(B, N)}")

    actions_out = np.empty((B, N), np.int32)
    hm = np.empty((B, C, Wt, Dt), np.int32)
    packed = np.empty((B, N), np.uint8)
    placements = np.empty((B, N, 6), np.int32)
    terms = np.empty((B, 5), np.int32)
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    terms_mask = sum({"C": 1, "P": 2, "S": 4}[t] for t in set(cfg.reward_terms))
    rc = lib.tap_rollout_batch(
        B, cfg.dim, N, Wt, Dt, cfg.target_height, C, cfg.num_rot, cfg.window,
        1 if cfg.placement_variant == "hard" else 0,
        1 if cfg.placement_rule == "mcs" else 0, terms_mask,
        dims, n_total, up, rot, pol,
        a_in.ctypes.data if a_in is not None else None,
        r_in.ctypes.data if r_in is not None else None,
        actions_out, hm, packed, placements, terms, n_threads)
    if rc != 0:
        raise RuntimeError(f"tap_rollout_batch failed rc={rc}")
    t_final = (actions_out >= 0).sum(axis=1).astype(np.int32)
    state = EnvState(heightmap=hm, packed=packed.astype(bool),
                     placements=placements, t=t_final)
    return state, actions_out, terms
