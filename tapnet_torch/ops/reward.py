"""The C/P/S reward of a batch, the port of `tapnet_tpu/ops/pallas_reward.py`.

- `heightmap_reductions_ref`: the plain PyTorch version of the TPU kernel's
  function (int32 max and sum over each container's W x D cells);
- `fused_reward_ref`: the plain version of the whole reward: the
  reductions, the five integer terms and the float32 reward, composed with
  tensor ops as the JAX package does around its kernel;
- `heightmap_reductions` and `fused_reward`: on a CUDA tensor they launch
  `csrc/reward.cu` (`reward_kernel`) on the current stream, the first for
  the reductions alone, the second for everything in one launch; both
  count the launch in `heightmap_reductions.launches`. On CPU tensors they
  run the plain versions.

`batched_reward_terms` / `batched_reward` are the JAX package's entry
points, through `fused_reward`. Every result is bit-equal to
`env.core.reward_terms` / `reward` (SPEC.md §7).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.env.core import reward_from_terms
from tapnet_torch.ops import _build

TERM_CODES = {"C": 0, "P": 1, "S": 2}  # csrc/reward.cu


def heightmap_reductions_ref(heightmaps: torch.Tensor):
    """(maxh, under): int32[B, C] max and sum of int32[B, C, W, D]."""
    return (heightmaps.amax(dim=(2, 3)).int(),
            heightmaps.sum(dim=(2, 3)).int())


def terms_from_reductions(maxh, under, placements, dims, area: int):
    """(vol, denom_c, denom_p, s_num, s_den), each int32[B], from the
    reductions int32[B, C], placements int32[B, N, 6], dims int32[B, N, 3]
    and the W*D cells of a container."""
    used = maxh > 0
    denom_c = torch.where(used, area * maxh, 0).sum(1)
    denom_p = torch.where(used, under, 0).sum(1)
    placed = placements[:, :, 0] >= 0
    vol = torch.where(placed, dims.prod(-1), 0).sum(1)
    s_num = torch.where(placed, placements[:, :, 5], 0).sum(1)
    s_den = placed.int().sum(1)
    return tuple(v.int() for v in (vol, denom_c, denom_p, s_num, s_den))


def fused_reward_ref(heightmaps, placements, dims, reward_terms_cfg=()):
    """Plain version of the fused launch: (maxh, under, terms, reward);
    reward None when no terms are configured."""
    maxh, under = heightmap_reductions_ref(heightmaps)
    W, D = heightmaps.shape[2:]
    terms = terms_from_reductions(maxh, under, placements, dims, W * D)
    return maxh, under, terms, reward_from_terms(terms, reward_terms_cfg)


@functools.cache
def _lib():
    fn = _build.load("reward").tapnet_reward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, ndim: int, last: int = None):
    if (t.dtype != torch.int32 or t.dim() != ndim
            or (last is not None and t.shape[-1] != last)):
        raise TypeError(f"{name}: expected int32 with {ndim} axes"
                        + (f" and {last} in the last" if last else "")
                        + f", got {t.dtype}{list(t.shape)}")


def _launch(hm, placements, dims, reward_terms_cfg):
    """One launch of the kernel on CUDA tensors. placements None: the
    reductions alone. Returns (maxh, under, terms or None, reward or
    None)."""
    B, C, W, D = hm.shape
    dev = hm.device
    hm = hm.contiguous()
    maxh = torch.empty((B, C), dtype=torch.int32, device=dev)
    under = torch.empty_like(maxh)
    terms = reward = None
    N = 0
    if placements is not None:
        N = placements.shape[1]
        if placements.shape[:2] != (B, N) or dims.shape[:2] != (B, N):
            raise ValueError(f"heightmaps {list(hm.shape)}, placements "
                             f"{list(placements.shape)} and dims "
                             f"{list(dims.shape)} disagree on B or N")
        for t in (placements, dims):
            if t.device != dev:
                raise ValueError(f"reward operands on {t.device} and {dev}")
        placements, dims = placements.contiguous(), dims.contiguous()
        terms = torch.empty((5, B), dtype=torch.int32, device=dev)
        if reward_terms_cfg:
            reward = torch.empty(B, dtype=torch.float32, device=dev)
    codes = [TERM_CODES[t] for t in reward_terms_cfg]
    ptrs = (ctypes.c_void_p * 7)(*(
        None if t is None else t.data_ptr()
        for t in (hm, placements, dims, maxh, under, terms, reward)))
    ints = _build.int_array([B, C, W * D, N, len(codes)]
                            + (codes + [0, 0, 0])[:3])
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(ints, ctypes.c_void_p), ctypes.c_void_p(stream))
    heightmap_reductions.launches += 1
    _build.check(err, "reward_kernel")
    return (maxh, under, None if terms is None else tuple(terms.unbind(0)),
            reward)


def heightmap_reductions(heightmaps: torch.Tensor):
    """(maxh, under), each int32[B, C], of int32[B, C, W, D] heightmaps:
    the TPU kernel's own function."""
    _check(heightmaps, "heightmap_reductions heightmaps", 4)
    if not heightmaps.is_cuda:
        return heightmap_reductions_ref(heightmaps)
    return _launch(heightmaps, None, None, ())[:2]


heightmap_reductions.launches = 0


def fused_reward(heightmaps, placements, dims, reward_terms_cfg=()):
    """(maxh [B, C], under [B, C], (vol, denom_c, denom_p, s_num, s_den)
    each int32[B], reward float32[B]) of heightmaps int32[B, C, W, D],
    placements int32[B, N, 6] and dims int32[B, N, 3] in one launch on the
    card; reward_terms_cfg e.g. ('C', 'P', 'S') (reward None when empty)."""
    _check(heightmaps, "heightmaps", 4)
    _check(placements, "placements", 3, 6)
    _check(dims, "dims", 3, 3)
    if len(reward_terms_cfg) > 3 or not set(reward_terms_cfg) <= set(
            TERM_CODES):
        raise ValueError(f"reward terms {reward_terms_cfg}: at most three "
                         f"of {sorted(TERM_CODES)}")
    if not heightmaps.is_cuda:
        return fused_reward_ref(heightmaps, placements, dims,
                                reward_terms_cfg)
    return _launch(heightmaps, placements, dims, tuple(reward_terms_cfg))


def batched_reward_terms(heightmaps, placements, dims):
    """(vol, denom_c, denom_p, s_num, s_den), each int32[B], from
    heightmaps int32[B, C, W, D], placements int32[B, N, 6] and dims
    int32[B, N, 3]."""
    return fused_reward(heightmaps, placements, dims)[2]


def batched_reward(heightmaps, placements, dims, reward_terms_cfg):
    """float32[B] rewards; reward_terms_cfg e.g. ('C', 'P', 'S')."""
    return fused_reward(heightmaps, placements, dims, reward_terms_cfg)[3]
