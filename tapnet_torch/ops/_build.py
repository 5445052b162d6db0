"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each `tapnet_torch/csrc/<name>.cu` becomes its own shared library with a
plain C interface, compiled for Hopper at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o tapnet_torch/_build/<name>-<hash>.so <name>.cu

The hash covers the source, every header in `csrc/` and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
wrappers pass device pointers and the current stream as `c_void_p`.
Nothing here runs when a module is imported: `load(name)` builds on the
first call, and `build_all()` starts one nvcc per source at once.

    python -m tapnet_torch.ops._build [--csrc DIR]

prints what ptxas reports for every kernel of every source in DIR (default:
the package's `csrc/`): registers, spills, stack and shared memory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}
_lock = threading.Lock()


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library exists; returns the process
    (or None), the target and the temporary output."""
    out = _target(name)
    if out.exists():
        return None, out, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name, proc, out, tmp):
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def build_all() -> dict:
    """Compile every csrc/*.cu in parallel (one nvcc each) and load them."""
    with _lock:
        todo = [n for n in sources() if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        for n, proc, out, tmp in started:
            _libs[n] = _finish(n, proc, out, tmp)
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                _libs[name] = _finish(name, *_start(name))
            lib = _libs[name]
    return lib


def ptr_array(tensors) -> ctypes.Array:
    """Device pointers of `tensors` as a C `void*[]`."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptxas_report(csrc: Path = CSRC) -> str:
    """`nvcc -Xptxas -v` for every csrc/*.cu (compiled to nowhere): one line
    per kernel with its registers, stack frame, spills and shared memory."""
    import re
    flags = [f for f in FLAGS if f != "-shared"]
    procs = [(p.name, subprocess.Popen(
        [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull, str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in sorted(Path(csrc).glob("*.cu"))]
    lines = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # "Compiling entry function 'X'", then its properties on two lines
        for m in re.finditer(r"entry function '([^']+)'[^\n]*\n(?:[^\n]*\n)?"
                             r"[^\n]*?(\d+ bytes stack frame[^\n]*)\n"
                             r"[^\n]*?(Used \d+ registers[^\n]*)", log):
            lines.append(f"{name} {m.group(1)}: {m.group(3)}; {m.group(2)}")
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="ptxas report of the kernels")
    ap.add_argument("--csrc", default=str(CSRC))
    print(ptxas_report(Path(ap.parse_args().csrc)))
