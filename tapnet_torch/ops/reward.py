"""Reward reductions over batched heightmaps, the port of
`tapnet_tpu/ops/pallas_reward.py`.

- `heightmap_reductions_ref`: the plain PyTorch version (int32 max and sum
  over each container's W x D cells), used on CPU tensors and as the
  reference the kernel is held to;
- `heightmap_reductions`: on a CUDA tensor it launches `csrc/reward.cu` on
  the current stream and counts it in `heightmap_reductions.launches`.

`batched_reward_terms` / `batched_reward` compose the rest of the C/P/S
terms with tensor ops, as the JAX package does outside its kernel; the
results are bit-equal to `env.core.reward_terms` / `reward` (SPEC.md §7).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.env.core import reward_from_terms
from tapnet_torch.ops import _build


def heightmap_reductions_ref(heightmaps: torch.Tensor):
    """(maxh, under): int32[B, C] max and sum of int32[B, C, W, D]."""
    return (heightmaps.amax(dim=(2, 3)).int(),
            heightmaps.sum(dim=(2, 3)).int())


@functools.cache
def _lib():
    fn = _build.load("reward").tapnet_heightmap_reductions
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def heightmap_reductions(heightmaps: torch.Tensor):
    """(maxh, under), each int32[B, C], of int32[B, C, W, D] heightmaps."""
    if heightmaps.dtype != torch.int32 or heightmaps.dim() != 4:
        raise TypeError("heightmap_reductions takes int32[B, C, W, D], got "
                        f"{heightmaps.dtype}{list(heightmaps.shape)}")
    if not heightmaps.is_cuda:
        return heightmap_reductions_ref(heightmaps)
    B, C, W, D = heightmaps.shape
    hm = heightmaps.contiguous()
    mx = torch.empty((B, C), dtype=torch.int32, device=hm.device)
    sm = torch.empty_like(mx)
    fn = _lib()
    with torch.cuda.device(hm.device):
        stream = torch.cuda.current_stream(hm.device).cuda_stream
        err = fn(ctypes.c_void_p(hm.data_ptr()), B * C, W * D,
                 ctypes.c_void_p(mx.data_ptr()),
                 ctypes.c_void_p(sm.data_ptr()), ctypes.c_void_p(stream))
    heightmap_reductions.launches += 1
    _build.check(err, "heightmap_reductions")
    return mx, sm


heightmap_reductions.launches = 0


def batched_reward_terms(heightmaps, placements, dims):
    """(vol, denom_c, denom_p, s_num, s_den), each int32[B], from
    heightmaps int32[B, C, W, D], placements int32[B, N, 6] and dims
    int32[B, N, 3]."""
    B, C, W, D = heightmaps.shape
    maxh, under = heightmap_reductions(heightmaps)
    used = maxh > 0
    denom_c = torch.where(used, W * D * maxh, 0).sum(1)
    denom_p = torch.where(used, under, 0).sum(1)
    placed = placements[:, :, 0] >= 0
    vol = torch.where(placed, dims.prod(-1), 0).sum(1)
    s_num = torch.where(placed, placements[:, :, 5], 0).sum(1)
    s_den = placed.int().sum(1)
    return tuple(v.int() for v in (vol, denom_c, denom_p, s_num, s_den))


def batched_reward(heightmaps, placements, dims, reward_terms_cfg):
    """float32[B] rewards; reward_terms_cfg e.g. ('C', 'P', 'S')."""
    return reward_from_terms(
        batched_reward_terms(heightmaps, placements, dims), reward_terms_cfg)
