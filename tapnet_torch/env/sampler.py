"""Seeded instance sampler (SPEC.md §2), the port of `tapnet_tpu/env/sampler.py`.

Recursive guillotine splits of the initial container, drawn from the same
threefry schedule as the JAX sampler (fold_in(key, i) -> split(3) -> bits),
so the same key gives the bit-identical instance. The batch axis is written
out: `sample_instance` takes keys [B, 2] and loops over the N - 1 split steps
in Python, each step a handful of [B, N] tensor ops.
"""

from __future__ import annotations

import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.types import Instance

# fold_in index reserved for the n_total draw (SPEC.md §2); the same constant
# as tapnet_tpu/oracle/generator.py.
N_TOTAL_FOLD = 10**6


def sample_instance(keys: torch.Tensor, cfg: TAPConfig) -> Instance:
    """One instance per key: keys int64[B, 2] -> Instance with batch B."""
    dev = keys.device
    B = keys.shape[0]
    N = cfg.num_blocks
    en = [ax in cfg.split_axes for ax in range(3)]
    i64 = torch.int64

    iota = torch.arange(N, device=dev)
    row0 = (iota == 0).expand(B, N)
    size = [torch.where(row0, v, 1).to(i64) for v in
            (cfg.container_width, cfg.container_depth, cfg.container_height)]
    pos = [torch.zeros(B, N, dtype=i64, device=dev) for _ in range(3)]

    span = cfg.num_blocks - cfg.min_blocks + 1
    n_total = cfg.min_blocks + R.bits(R.fold_in(keys, N_TOTAL_FOLD)) % span

    # all split draws up front: [B, N-1, 3] (rect, axis, position)
    steps = torch.arange(N - 1, dtype=i64, device=dev)
    ki = R.fold_in(keys[:, None, :], steps[None, :])            # [B, N-1, 2]
    draws = R.bits(R.split(ki, 3))                               # [B, N-1, 3]

    n = torch.ones(B, dtype=i64, device=dev)
    bi = torch.arange(B, device=dev)
    for i in range(N - 1):
        r_rect, r_axis, r_pos = draws[:, i, 0], draws[:, i, 1], draws[:, i, 2]
        active = i < n_total - 1
        valid = iota[None] < n[:, None]
        can = [(size[ax] >= 2) if en[ax] else torch.zeros_like(valid)
               for ax in range(3)]
        splittable = valid & (can[0] | can[1] | can[2])
        m = splittable.sum(1)
        sel = r_rect % m.clamp(min=1)
        rank = splittable.cumsum(1) - splittable.long()
        j = torch.argmax((splittable & (rank == sel[:, None])).long(), dim=1)

        sj = [s[bi, j] for s in size]
        pj = [p[bi, j] for p in pos]
        a = [(sj[ax] >= 2) if en[ax] else torch.zeros_like(active)
             for ax in range(3)]
        na = a[0].long() + a[1].long() + a[2].long()
        sela = r_axis % na.clamp(min=1)
        r1 = a[0].long()
        r2 = r1 + a[1].long()
        is_ax = [a[0] & (sela == 0), a[1] & (r1 == sela), a[2] & (r2 == sela)]
        s = sum(torch.where(is_ax[ax], sj[ax], 0) for ax in range(3))
        cut = 1 + r_pos % (s - 1).clamp(min=1)

        j_act = (iota[None] == j[:, None]) & active[:, None]
        n_oh = (iota[None] == n[:, None]) & active[:, None]
        for ax in range(3):
            isa = is_ax[ax][:, None]
            newp = pj[ax] + torch.where(is_ax[ax], cut, 0)
            news = torch.where(is_ax[ax], s - cut, sj[ax])
            size[ax] = torch.where(j_act & isa, cut[:, None], size[ax])
            pos[ax] = torch.where(n_oh, newp[:, None], pos[ax])
            size[ax] = torch.where(n_oh, news[:, None], size[ax])
        n = n + active.long()

    dims = torch.stack(size, -1).to(torch.int32)
    pos0 = torch.stack(pos, -1).to(torch.int32)
    n_total = n_total.to(torch.int32)
    return Instance(dims=dims, pos0=pos0, n_total=n_total,
                    up=build_up_edges(dims, pos0, n_total),
                    rot=build_rot_edges(dims, pos0, n_total, cfg))


def _overlap1d(a0, alen, b0, blen):
    """Half-open overlap on [B, a, b] grids (SPEC.md §3)."""
    return (a0[:, :, None] < b0[:, None, :] + blen[:, None, :]) & (
        b0[:, None, :] < a0[:, :, None] + alen[:, :, None])


def _real_pairs(dims, n_total):
    N = dims.shape[1]
    iota = torch.arange(N, device=dims.device)
    real = iota[None] < n_total[:, None]
    neq = ~torch.eye(N, dtype=torch.bool, device=dims.device)
    return neq[None] & real[:, :, None] & real[:, None, :]


def build_up_edges(dims, pos, n_total) -> torch.Tensor:
    """up[b, a, c]: block a obstructs straight-up removal of c."""
    xov = _overlap1d(pos[..., 0], dims[..., 0], pos[..., 0], dims[..., 0])
    yov = _overlap1d(pos[..., 1], dims[..., 1], pos[..., 1], dims[..., 1])
    above = pos[:, :, None, 2] >= pos[:, None, :, 2] + dims[:, None, :, 2]
    return xov & yov & above & _real_pairs(dims, n_total)


def build_rot_edges(dims, pos, n_total, cfg: TAPConfig) -> torch.Tensor:
    """rot[b, a, c]: block a obstructs removal-with-rotation of c."""
    ax0, ax1 = cfg.rot_axes
    s = torch.maximum(dims[..., ax0], dims[..., ax1])

    def swept(axis):
        c2 = 2 * pos[..., axis] + dims[..., axis]
        return c2 - s, c2 + s

    sx_lo, sx_hi = swept(0)
    if cfg.dim == 3:
        sy_lo, sy_hi = swept(1)
    else:
        sy_lo, sy_hi = 2 * pos[..., 1], 2 * (pos[..., 1] + dims[..., 1])
    ax_lo, ax_hi = 2 * pos[..., 0], 2 * (pos[..., 0] + dims[..., 0])
    ay_lo, ay_hi = 2 * pos[..., 1], 2 * (pos[..., 1] + dims[..., 1])
    xov = (sx_lo[:, None, :] < ax_hi[:, :, None]) & (
        ax_lo[:, :, None] < sx_hi[:, None, :])
    yov = (sy_lo[:, None, :] < ay_hi[:, :, None]) & (
        ay_lo[:, :, None] < sy_hi[:, None, :])
    zok = pos[:, :, None, 2] >= pos[:, None, :, 2]
    return xov & yov & zok & _real_pairs(dims, n_total)


def sample_batch(key: torch.Tensor, batch: int, cfg: TAPConfig) -> Instance:
    """`batch` instances from one key: split(key, batch) -> sample_instance."""
    return sample_instance(R.split(key, batch), cfg)
