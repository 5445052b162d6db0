"""Debug modes, the port of `tapnet_tpu/utils/debug.py`: finite checks for
`train(nan_checks=True)` / `cli train --nan-checks`.

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
from typing import Iterator, Mapping, Sequence, Union

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
