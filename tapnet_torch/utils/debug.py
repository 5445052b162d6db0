"""Debug modes, the port of `tapnet_tpu/utils/debug.py`: finite checks for
`train(nan_checks=True)` / `cli train --nan-checks`, and a determinism
assert (`assert_deterministic`: run a computation twice, require
bit-identical results).

The JAX package's `nan_checks()` turns on jax debug-nans, which checks
every primitive's output inside the compiled step. The port's step runs
eagerly or, with `steps_per_call` > 1 on the card, as a captured CUDA graph,
and nothing that checks inside a step can be captured: autograd's anomaly
mode and any read of a device value on the host are refused by capture. So
the port checks between calls: with `nan_checks` the trainer runs
`assert_finite` on the parameters, both Adam moments and the metrics before
the first call and after every call, on the card as on the CPU. A NaN is
named after the call that made it, not at the operation that made it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Mapping, Sequence, Union

import numpy as np
import torch

Tensors = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


def assert_finite(tensors: Tensors, where: str = "") -> None:
    """Raise FloatingPointError naming the first floating tensor (a dict's
    key, else its index) that holds a NaN or an infinity. One host read for
    all of them."""
    items = (list(tensors.items()) if isinstance(tensors, Mapping)
             else [(str(i), t) for i, t in enumerate(tensors)])
    items = [(k, t) for k, t in items if t.is_floating_point()]
    if not items:
        return
    ok = torch.stack([torch.isfinite(t.detach()).all() for _, t in items])
    if bool(ok.all()):
        return
    name = items[int(torch.argmin(ok.int()))][0]
    raise FloatingPointError(f"non-finite values at {name} {where}".strip())


@contextlib.contextmanager
def nan_checks() -> Iterator:
    """The JAX package's name for a scope with finite checks, kept for
    callers of that API; it yields `assert_finite` and changes nothing
    global (see the module docstring). The trainer calls `assert_finite`
    itself."""
    yield assert_finite


def _leaves(tree) -> list:
    """The leaves of nested tuples, NamedTuples, lists and dicts (dicts in
    key order, None skipped), tensors on the host."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if tree is None:
        return []
    return [tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree]


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def assert_deterministic(fn: Callable, *args, runs: int = 2) -> None:
    """Run fn(*args) `runs` times; every leaf of the results must be
    bit-identical to the first run's (the `--deterministic` check of the
    JAX package's `utils.debug`, with its AssertionError text). The
    trainer's check of a train step from copies of one state is
    `train.trainer.assert_deterministic`."""
    ref = _leaves(fn(*args))
    for i in range(2, runs + 1):
        for a, b in zip(ref, _leaves(fn(*args))):
            if not _same(a, b):
                raise AssertionError(
                    f"non-deterministic result: run 1 vs run {i} differ")
