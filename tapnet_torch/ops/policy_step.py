"""select_step: one decode step's select + place, batch-last.

Port of `tapnet_tpu/ops/pallas_policy_step.py`. Given the f32 score the
general path feeds argmax (masked logits, + gumbel when sampling), it takes
the lowest index attaining the max, places the chosen block by the config's
rule (`lb` or `mcs`) and updates the env state, bit-equal to
`env.core.step(state, argmax(score))`.

- `select_place_ref`: the plain PyTorch version (argmax + the env's own
  candidate scan and placement), used on CPU tensors and as the reference
  the kernel is held to;
- `select_step`: on a CUDA tensor it launches the hand-written kernel
  `csrc/policy_step.cu` on the current stream (tiles of 32 instances, one
  per lane, over 16 warps; the placement body `csrc/select_place.cuh` is
  the one K2 and K4 run) and counts the launch in `select_step.launches`;
  on a CPU tensor it runs `select_place_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.ops import _build

MAX_WD = 256  # csrc/select_place.cuh: heightmap cells of one container


def eligible(cfg: TAPConfig) -> bool:
    """Configs the kernel covers: every rule, variant, cap, window and
    container count, with at most MAX_WD heightmap cells per container
    (the JAX kernel covers every config)."""
    return cfg.target_width * cfg.target_depth <= MAX_WD


def env_ints(cfg: TAPConfig):
    """The kernels' EnvCfg fields (csrc/select_place.cuh): N, W, D, R, C,
    hard, cap, two_d, mcs, terms (a bit per reward term: C 1, P 2, S 4)."""
    terms = sum({"C": 1, "P": 2, "S": 4}[t] for t in cfg.reward_terms)
    return [cfg.num_blocks, cfg.target_width, cfg.target_depth, cfg.num_rot,
            cfg.num_containers, int(cfg.placement_variant == "hard"),
            cfg.height_cap, int(cfg.dim == 2),
            int(cfg.placement_rule == "mcs"), terms]


def select_place_ref(cfg: TAPConfig, score, mask, packed, hm, plc,
                     dims_w, dims_d, dims_h):
    """Plain version. score f32[A, B], mask i32[A, B], packed i32[N, B],
    hm i32[C*W, D, B], plc i32[N*6, B], dims_* i32[N, B] (unrotated).
    Returns (packed', hm', plc', act i32[B])."""
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    B = score.shape[1]
    dev = score.device
    bi = torch.arange(B, device=dev)
    a_sel = torch.argmax(score, dim=0).int()                 # first max
    valid = mask.amax(0) > 0
    b, r, c = cfg.decompose_action(a_sel)
    dims_all = torch.stack([dims_w, dims_d, dims_h], -1).transpose(0, 1)
    dims = torch.where((r == 1)[:, None],
                       E.rotated_dims_all(dims_all[bi, b.long()], 1, cfg),
                       dims_all[bi, b.long()])
    w, d, h = dims[:, 0], dims[:, 1], dims[:, 2]
    hm_b = hm.reshape(C, W, D, B).permute(3, 0, 1, 2)        # [B, C, W, D]
    ctx = None
    if cfg.placement_rule == "mcs":
        ctx = E.terms_of(hm_b, plc.reshape(N, 6, B).permute(2, 0, 1),
                         dims_all)
    x, y, l, stable, any_valid = E.choose_placement(
        hm_b[bi, c.long()], w, d, h, cfg, ctx)
    do = valid & any_valid

    xs = torch.arange(W, device=dev)[None, :, None]
    ys = torch.arange(D, device=dev)[None, None, :]
    fp = ((xs >= x[:, None, None]) & (xs < (x + w)[:, None, None])
          & (ys >= y[:, None, None]) & (ys < (y + d)[:, None, None]))
    sel_c = (torch.arange(C, device=dev)[None] == c[:, None]) & do[:, None]
    upd = sel_c[:, :, None, None] & fp[:, None]
    hm_new = torch.where(upd, (l + h)[:, None, None, None], hm_b)
    sel_b = (torch.arange(N, device=dev)[:, None] == b[None]) & do[None]
    packed_new = packed + sel_b.int()
    row = torch.stack([c, r, x, y, l, stable.int()], 0).int()  # [6, B]
    write = sel_b.repeat_interleave(6, dim=0)                # [N*6, B]
    plc_new = torch.where(write, row.repeat(N, 1), plc)
    act = torch.where(valid, a_sel, -1).int()
    return (packed_new.int(), hm_new.permute(1, 2, 3, 0).reshape(C * W, D, B),
            plc_new, act)


def _check(t, name, shape, dtype, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def _lib():
    lib = _build.load("policy_step")
    fn = lib.tapnet_select_step
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def select_step(score, mask, packed, hm, plc, dims_w, dims_d, dims_h,
                cfg: TAPConfig):
    """One fused select + place step; see `select_place_ref` for operands.
    Returns (packed', hm', plc', act i32[B])."""
    if not score.is_cuda:
        return select_place_ref(cfg, score, mask, packed, hm, plc,
                                dims_w, dims_d, dims_h)
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    if not eligible(cfg):
        raise NotImplementedError(f"select_step kernel holds at most "
                                  f"{MAX_WD} heightmap cells per container")
    A, B = cfg.num_actions, score.shape[1]
    dev, i32 = score.device, torch.int32
    _check(score, "score", (A, B), torch.float32, dev)
    _check(mask, "mask", (A, B), i32, dev)
    _check(packed, "packed", (N, B), i32, dev)
    _check(hm, "hm", (C * W, D, B), i32, dev)
    _check(plc, "plc", (N * 6, B), i32, dev)
    for nm, t in (("dims_w", dims_w), ("dims_d", dims_d), ("dims_h", dims_h)):
        _check(t, nm, (N, B), i32, dev)
    outs = (torch.empty_like(packed), torch.empty_like(hm),
            torch.empty_like(plc), torch.empty(B, dtype=i32, device=dev))
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = _build.ptr_array((score, mask, packed, hm, plc, dims_w,
                                 dims_d, dims_h) + outs)
        err = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(_build.int_array([B] + env_ints(cfg)),
                             ctypes.c_void_p),
                 ctypes.c_void_p(stream))
    select_step.launches += 1
    _build.check(err, "select_step")
    return outs


select_step.launches = 0
