"""fused_rollout_batch: the whole heuristic rollout in one kernel launch.

Port of `tapnet_tpu/ops/pallas_env.py`: a drop-in for
`env.core.rollout_batch` (policies `first` and `random`), bit-equal to it on
every field. The policy's threefry draws are computed once outside
(`env.core.policy_bits`), so the kernel and the general path consume the
same numbers; the rewards come from `ops.reward.batched_reward` (one
`reward_kernel` launch on the card), as in the JAX package.

- `fused_rollout_batch_ref`: the plain PyTorch version (the general env's
  action_mask / select_action / step loop on the same draws), used on CPU
  tensors and as the reference the kernel is held to;
- `fused_rollout_batch`: on CUDA tensors it launches the hand-written kernel
  `csrc/env.cu` (tiles of 32 instances over 16 warps, the instance's state
  in shared memory, the placement body `csrc/select_place.cuh` shared with
  K1 and K2) on the current stream (`rollout_kernel`) and counts the launch
  in `fused_rollout_batch.launches`.

Coverage: both placement rules, soft/hard, 2D/3D, rotation, rolling window,
finite caps, any container count with rot x containers <= 16, up to 62
blocks (two precedence limbs) and 256 heightmap cells per container. Where
the heightmaps of all containers do not fit in shared memory beside the
rest (`onchip` false), the kernel keeps them in its output and stages the
chosen container per step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.ops import _build
from tapnet_torch.ops.actor_step import precedence_bitmasks
from tapnet_torch.ops.policy_step import MAX_WD, _check, env_ints
from tapnet_torch.ops.reward import batched_reward
from tapnet_torch.types import EnvState, Instance

MAX_N = 62   # csrc/env.cu: two 31-bit precedence limbs
MAX_RC = 16  # csrc/env.cu: feasibility bits per block


def eligible(cfg: TAPConfig) -> bool:
    """Configs the rollout kernel covers: every rule, variant, window, cap
    and dimension, within the kernel's sizes (its bit words and its
    shared-memory plans)."""
    return (cfg.num_blocks <= MAX_N
            and cfg.num_rot * cfg.num_containers <= MAX_RC
            and cfg.target_width * cfg.target_depth <= MAX_WD)


def fused_rollout_batch_ref(instances: Instance, keys: torch.Tensor,
                            cfg: TAPConfig, policy: str = "first"):
    """Plain version: (EnvState, actions int32[B, N], rewards float32[B])."""
    rbits = E.policy_bits(keys, cfg, policy)
    state, actions = E.rollout_bits(instances, rbits, cfg)
    return state, actions, batched_reward(state.heightmap, state.placements,
                                          instances.dims, cfg.reward_terms)


@functools.cache
def _lib():
    fn = _build.load("env").tapnet_fused_rollout
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ints(cfg: TAPConfig, B: int):
    return _build.int_array([B] + env_ints(cfg)
                            + [cfg.window, int(cfg.target_height > 0)])


def onchip(cfg: TAPConfig) -> bool:
    """Whether the kernel keeps every heightmap of a rollout in shared
    memory (else in its output, the chosen container staged per step).
    Asks the built kernel library, so it needs nvcc."""
    fn = _build.load("env").tapnet_rollout_onchip
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return bool(fn(ctypes.cast(_ints(cfg, 1), ctypes.c_void_p)))


def rollout_operands(instances: Instance, rbits: torch.Tensor,
                     cfg: TAPConfig):
    """The kernel's inputs, batch-last int32: dims_w, dims_d, dims_h [N, B],
    upm, rotm [L*N, B], n_total [B], draws [N, B] (uint32 bit patterns)."""
    dims = [instances.dims[:, :, k].T.int().contiguous() for k in range(3)]
    upm, rotm = precedence_bitmasks(instances, cfg)
    # uint32 values as the int32 of the same bits
    bits32 = (rbits - ((rbits >> 31) << 32)).T.int().contiguous()
    return (*dims, upm, rotm, instances.n_total.int().contiguous(), bits32)


def rollout_kernel(ops, cfg: TAPConfig):
    """Launch the kernel on `rollout_operands` (CUDA tensors). Returns the
    final state batch-last, int32: hm [C*W*D, B], packed [N, B], actions
    [N, B] (-1 = no-op), placements [N*6, B]."""
    if not eligible(cfg):
        raise NotImplementedError(
            f"fused_rollout_batch holds at most {MAX_N} blocks, {MAX_RC} "
            f"rot x container pairs and {MAX_WD} heightmap cells per "
            f"container; got {cfg}")
    N, WD, C = (cfg.num_blocks, cfg.target_width * cfg.target_depth,
                cfg.num_containers)
    L = (N + 30) // 31
    B = ops[0].shape[1]
    dev, i32 = ops[0].device, torch.int32
    if dev.type != "cuda":
        raise ValueError("rollout_kernel takes CUDA tensors; on the CPU use "
                         "fused_rollout_batch_ref")
    names = ("dims_w", "dims_d", "dims_h", "upm", "rotm", "n_total", "rbits")
    shapes = ((N, B),) * 3 + ((L * N, B),) * 2 + ((B,), (N, B))
    for t, name, shape in zip(ops, names, shapes):
        _check(t, name, shape, i32, dev)
    outs = tuple(torch.empty((rows, B), dtype=i32, device=dev)
                 for rows in (C * WD, N, N, N * 6))
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = _build.ptr_array(tuple(ops) + outs)
        err = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(_ints(cfg, B), ctypes.c_void_p),
                 ctypes.c_void_p(stream))
    fused_rollout_batch.launches += 1
    _build.check(err, "fused_rollout_batch")
    return outs


def fused_rollout_batch(instances: Instance, keys: torch.Tensor,
                        cfg: TAPConfig, policy: str = "first"):
    """Roll a batch to termination with a fixed policy in one launch.
    instances: [B, ...] tensors; keys int64[B, 2] (one threefry key per
    instance). Returns (EnvState, actions int32[B, N], rewards float32[B])."""
    if not instances.dims.is_cuda:
        return fused_rollout_batch_ref(instances, keys, cfg, policy)
    N, W, D, C = (cfg.num_blocks, cfg.target_width, cfg.target_depth,
                  cfg.num_containers)
    B = instances.dims.shape[0]
    hm, packed, actions, plc = rollout_kernel(
        rollout_operands(instances, E.policy_bits(keys, cfg, policy), cfg),
        cfg)
    actions_b = actions.T.contiguous()
    state = EnvState(
        heightmap=hm.reshape(C, W, D, B).permute(3, 0, 1, 2).contiguous(),
        packed=packed.T.bool().contiguous(),
        placements=plc.reshape(N, 6, B).permute(2, 0, 1).contiguous(),
        t=(actions_b >= 0).int().sum(1).int())
    rewards = batched_reward(state.heightmap, state.placements,
                             instances.dims, cfg.reward_terms)
    return state, actions_b, rewards


fused_rollout_batch.launches = 0
