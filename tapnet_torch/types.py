"""Core NamedTuples of tensors shared by the env, the rollout and `pack()`.

Mirrors `tapnet_tpu/types.py`: an instance is an explicit tuple of tensors in
the unified 3D frame of SPEC.md §1. In the port every field carries a
leading batch axis: the batch dimension is written out instead of `vmap`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Instance(NamedTuple):
    """A batch of TAP instances.

    dims:    int32[B, N, 3]  block sizes (w, d, h); padding blocks are (1, 1, 1)
    pos0:    int32[B, N, 3]  min-corner position in the initial container
    n_total: int32[B]        number of real (non-padding) blocks
    up:      bool[B, N, N]   up[a, b]: a obstructs straight-up removal of b
    rot:     bool[B, N, N]   rot[a, b]: a obstructs removal-with-rotation of b
    """

    dims: torch.Tensor
    pos0: torch.Tensor
    n_total: torch.Tensor
    up: torch.Tensor
    rot: torch.Tensor

    def to(self, device) -> "Instance":
        return Instance(*(torch.as_tensor(x).to(device) for x in self))

    def index(self, rows) -> "Instance":
        return Instance(*(x[rows] for x in self))


class EnvState(NamedTuple):
    """Rollout state of a batch.

    heightmap:  int32[B, C, Wt, Dt] per-target-container heightmaps
    packed:     bool[B, N]
    placements: int32[B, N, 6]  (container, rot, x, y, landing, stable)
    t:          int32[B]        steps taken
    """

    heightmap: torch.Tensor
    packed: torch.Tensor
    placements: torch.Tensor
    t: torch.Tensor


# placements columns
PLACE_CONTAINER = 0
PLACE_ROT = 1
PLACE_X = 2
PLACE_Y = 3
PLACE_Z = 4
PLACE_STABLE = 5
