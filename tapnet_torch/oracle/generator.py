"""Oracle instance generator: recursive guillotine splits, per SPEC.md §2,
the port's copy of `tapnet_tpu/oracle/generator.py`.

Covers the reference's offline dataset generator (SURVEY.md §1 L1 / §3.3,
`generate.py` recursive guillotine cutting, unverified) as a seeded, replayable
sampler. Randomness comes from threefry bits (`tapnet_torch.random`, bit-equal
to `jax.random`), so the batched sampler in `tapnet_torch/env/sampler.py` and
the JAX package's reproduce the identical instance stream. A key is an int64
tensor [2] (`tapnet_torch.random.key(seed)`).
"""

from __future__ import annotations

import numpy as np
import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.types import Instance

# fold_in index reserved for the n_total draw (SPEC.md §2).
N_TOTAL_FOLD = 10**6
# fold_in index reserved for the mixed-batch flat/3D draw (SPEC.md §9).
MIX_FOLD = 10**6 + 1


def _bits(key) -> int:
    return int(R.bits(key))


def _split_bits(key, n: int) -> np.ndarray:
    """uint32 draws [n, 3]: row i holds bits(k) for k in split(fold_in(key,
    i), 3), the three draws of split step i, computed in one batch."""
    if n == 0:
        return np.zeros((0, 3), dtype=np.int64)
    ki = R.fold_in(key[None, :], torch.arange(n))
    return R.bits(R.split(ki, 3)).cpu().numpy()


def generate_instance(key, cfg: TAPConfig, flat: bool = False) -> Instance:
    """Generate one instance with numpy loops (the executable spec).

    flat=True (SPEC.md §9 mixed sampling, 3D env only): the guillotine runs
    on the depth-1 initial container (W, 1, H) with split axes (x, z), so
    every block is 2D (d = 1) inside the 3D frame.
    """
    N = cfg.num_blocks
    if flat:
        assert cfg.dim == 3, "flat instances live inside a 3D env"
        depth0, split_axes = 1, (0, 2)
    else:
        depth0, split_axes = cfg.container_depth, cfg.split_axes
    pos = np.zeros((N, 3), dtype=np.int32)
    size = np.ones((N, 3), dtype=np.int32)
    size[0] = (cfg.container_width, depth0, cfg.container_height)

    span = cfg.num_blocks - cfg.min_blocks + 1
    n_total = cfg.min_blocks + _bits(R.fold_in(key, N_TOTAL_FOLD)) % span

    n = 1
    draws = _split_bits(key, N - 1)
    for i in range(N - 1):
        r_rect, r_axis, r_pos = (int(v) for v in draws[i])
        if i >= n_total - 1:
            continue  # inactive step: keys derived, nothing else consumed
        splittable = [
            r for r in range(n)
            if any(size[r, ax] >= 2 for ax in split_axes)
        ]
        j = splittable[r_rect % len(splittable)]
        axes = [ax for ax in split_axes if size[j, ax] >= 2]
        axis = axes[r_axis % len(axes)]
        s = int(size[j, axis])
        cut = 1 + r_pos % (s - 1)
        pos[n] = pos[j]
        size[n] = size[j]
        pos[n, axis] += cut
        size[n, axis] = s - cut
        size[j, axis] = cut
        n += 1

    # Padding blocks (idx >= n_total) stay (1,1,1) at the origin; they are
    # marked permanently packed by the env and excluded from the graphs below.
    up = build_up_edges(size, pos, n_total)
    rot = build_rot_edges(size, pos, n_total, cfg)
    return Instance(
        dims=size,
        pos0=pos,
        n_total=np.int32(n_total),
        up=up,
        rot=rot,
    )


def mix_flat(key, p2d: float) -> bool:
    """SPEC.md §9 mixed-batch draw: flat iff threefry bits under threshold."""
    thresh = min(max(int(p2d * 2**32), 0), 2**32)
    return _bits(R.fold_in(key, MIX_FOLD)) < thresh


def _overlap(a0: int, alen: int, b0: int, blen: int) -> bool:
    """Half-open interval overlap, SPEC.md §3."""
    return a0 < b0 + blen and b0 < a0 + alen


def build_up_edges(dims: np.ndarray, pos: np.ndarray, n_total: int) -> np.ndarray:
    """up[a, b]: a obstructs straight-up removal of b (SPEC.md §3)."""
    N = dims.shape[0]
    up = np.zeros((N, N), dtype=bool)
    for a in range(int(n_total)):
        for b in range(int(n_total)):
            if a == b:
                continue
            up[a, b] = (
                _overlap(pos[a, 0], dims[a, 0], pos[b, 0], dims[b, 0])
                and _overlap(pos[a, 1], dims[a, 1], pos[b, 1], dims[b, 1])
                and pos[a, 2] >= pos[b, 2] + dims[b, 2]
            )
    return up


def build_rot_edges(dims: np.ndarray, pos: np.ndarray, n_total: int,
                    cfg: TAPConfig) -> np.ndarray:
    """rot[a, b]: a obstructs removal-with-rotation of b (SPEC.md §3).

    The swept region is a centered interval of doubled-coordinate width 2*s
    around b's footprint center, s = max of the two rotated axes' sizes.
    """
    N = dims.shape[0]
    ax0, ax1 = cfg.rot_axes
    rot = np.zeros((N, N), dtype=bool)
    for b in range(int(n_total)):
        s = int(max(dims[b, ax0], dims[b, ax1]))
        # doubled-coordinate swept intervals per horizontal axis
        def swept(axis: int):
            lo = 2 * int(pos[b, axis]) + int(dims[b, axis]) - s
            hi = 2 * int(pos[b, axis]) + int(dims[b, axis]) + s
            return lo, hi
        sx_lo, sx_hi = swept(0)
        if cfg.dim == 3:
            sy_lo, sy_hi = swept(1)
        else:  # 2D: rotation is in-plane; depth interval is b's own
            sy_lo, sy_hi = 2 * int(pos[b, 1]), 2 * (int(pos[b, 1]) + int(dims[b, 1]))
        for a in range(int(n_total)):
            if a == b:
                continue
            ax_lo, ax_hi = 2 * int(pos[a, 0]), 2 * (int(pos[a, 0]) + int(dims[a, 0]))
            ay_lo, ay_hi = 2 * int(pos[a, 1]), 2 * (int(pos[a, 1]) + int(dims[a, 1]))
            rot[a, b] = (
                sx_lo < ax_hi and ax_lo < sx_hi
                and sy_lo < ay_hi and ay_lo < sy_hi
                and pos[a, 2] >= pos[b, 2]
            )
    return rot
