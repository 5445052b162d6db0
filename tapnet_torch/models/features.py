"""Feature extraction: env tensors -> model inputs, the port of
`tapnet_tpu/models/features.py` with the batch axis written out."""

from __future__ import annotations

import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.env.core import _accessibility, rotated_dims_all
from tapnet_torch.types import Instance


def _scale(cfg: TAPConfig) -> float:
    return float(max(cfg.container_width, cfg.container_depth,
                     cfg.container_height, cfg.target_width, cfg.target_depth))


def f32_on(x, device) -> torch.Tensor:
    """`x`, a Python number or a tensor, as float32 on `device`. A number
    becomes a fill on the device, never a host-to-device copy, so the
    caller can be captured in a CUDA graph."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def static_tokens(instances: Instance, cfg: TAPConfig) -> torch.Tensor:
    """Per (block, rot) static features [B, N*R, 4]: rotated dims + volume."""
    s = _scale(cfg)
    toks = []
    for r in range(cfg.num_rot):
        dims = rotated_dims_all(instances.dims, r, cfg)
        vol = dims.prod(-1, keepdim=True)
        toks.append(torch.cat([dims.float() / s,
                               vol.float() / s**cfg.dim], dim=-1))
    B = instances.dims.shape[0]
    return torch.stack(toks, dim=2).reshape(
        B, cfg.num_blocks * cfg.num_rot, 4)


def dynamic_flags(instances: Instance, packed: torch.Tensor,
                  cfg: TAPConfig) -> torch.Tensor:
    """Per-block dynamic bit flags uint8[B, N]: bit0 packed, bit1 accessible,
    bit2 accessible with rotation, bit3 inside the rolling window."""
    acc0, accr = _accessibility(instances, packed)
    if cfg.window > 0:
        a0 = acc0.int()
        win = acc0 & ((a0.cumsum(-1) - a0) < cfg.window)
    else:
        win = acc0
    u8 = torch.uint8
    return (packed.to(u8) | (acc0.to(u8) << 1) | (accr.to(u8) << 2)
            | (win.to(u8) << 3))


def tokens_from_flags(flags: torch.Tensor, t_frac,
                      cfg: TAPConfig) -> torch.Tensor:
    """Expand dynamic flags to model tokens: [..., n] -> [..., n*R, 4];
    t_frac broadcasts against flags[..., n]."""
    f = flags.int()
    packed = (f & 1).float()
    acc0 = ((f >> 1) & 1).float()
    accr = ((f >> 2) & 1).float()
    win = ((f >> 3) & 1).float()
    tf = f32_on(t_frac, f.device)
    tf = torch.broadcast_to(tf[..., None], packed.shape)
    per_rot = [torch.stack([packed, acc0 if r == 0 else accr, win, tf], -1)
               for r in range(cfg.num_rot)]
    toks = torch.stack(per_rot, dim=-2)                       # [..., n, R, 4]
    return toks.reshape(flags.shape[:-1] + (flags.shape[-1] * cfg.num_rot, 4))


def heightmap_grid(heightmap: torch.Tensor, cfg: TAPConfig) -> torch.Tensor:
    """Normalized per-container heightmap grid [..., C, Wt, Dt, 1]."""
    return (heightmap.float() / _scale(cfg))[..., None]


def mask_from_flags(flags: torch.Tensor, instances: Instance,
                    cfg: TAPConfig) -> torch.Tensor:
    """Action mask rebuilt from flags: uint8[B, N] -> bool[B, A]. Valid for
    unbounded-height configs only (SPEC.md §5)."""
    assert cfg.target_height == 0
    f = flags.int()
    win = ((f >> 3) & 1).bool()
    accr = ((f >> 2) & 1).bool()
    per_rot = []
    for r in range(cfg.num_rot):
        dims = rotated_dims_all(instances.dims, r, cfg)
        fits = ((dims[..., 0] <= cfg.target_width)
                & (dims[..., 1] <= cfg.target_depth))
        ok = win if r == 0 else (win & accr)
        per_rot.append(ok & fits)
    mask_br = torch.stack(per_rot, dim=-1)                    # [B, N, R]
    mask = mask_br[..., None].expand(mask_br.shape + (cfg.num_containers,))
    return mask.reshape(flags.shape[:-1] + (cfg.num_actions,))


def merge_tokens(static: torch.Tensor, dynamic: torch.Tensor) -> torch.Tensor:
    """Append the static dims features to the dynamic tokens: [..., T, 8]."""
    target = dynamic.shape[:-1] + static.shape[-1:]
    return torch.cat([dynamic, torch.broadcast_to(static, target)], dim=-1)


def dynamic_tokens(instances: Instance, state, cfg: TAPConfig) -> torch.Tensor:
    """Per (block, rot) dynamic features [B, N*R, 4]: packed / accessible /
    window / t, from the state's packed bits and step count."""
    return tokens_from_flags(dynamic_flags(instances, state.packed, cfg),
                             state.t.float() / cfg.num_blocks, cfg)


def heightmap_features(state, cfg: TAPConfig) -> torch.Tensor:
    """Normalized per-container heightmap grid [B, C, Wt, Dt, 1]."""
    return heightmap_grid(state.heightmap, cfg)


def build_tokens(instances: Instance, state, cfg: TAPConfig):
    """(static [B, T, 4], dynamic [B, T, 4], heightmap [B, C, Wt, Dt, 1]):
    the critic's inputs (the dynamic tokens are not merged)."""
    return (static_tokens(instances, cfg),
            dynamic_tokens(instances, state, cfg),
            heightmap_features(state, cfg))
