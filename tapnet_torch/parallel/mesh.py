"""Data meshes and sharding helpers over torch.distributed, the port of
`tapnet_tpu/parallel/mesh.py`.

Design (as in the JAX package): one data axis over all ranks; the env is
embarrassingly parallel over instances, so the learner's only collectives
are one all-reduce of the flat gradient buffer and one of the metrics a
step (`train/reinforce.py`), the reduction XLA inserts as a psum there.

In PyTorch's idiom a mesh is a small `DataMesh`: the process group, its
world size, this process's rank and its device. A rank holds the rows
[r*B/n, (r+1)*B/n) of a global batch of B (`shard_leading_axis`); replicated
values are the same on every rank (`replicate` broadcasts them from rank
0). The backend is NCCL on the card and gloo on the CPU. Where no process
group exists yet, `data_mesh` starts one of world size 1 in this process,
so one code path serves one process and many.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class DataMesh:
    """The data axis ("data"): a process group, its world size, this rank
    and the device this rank computes on."""

    group: Optional[dist.ProcessGroup]
    world_size: int
    rank: int
    device: torch.device

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch`."""
        if batch % self.world_size:
            raise ValueError(f"batch {batch} is not a multiple of the "
                             f"mesh's {self.world_size} ranks")
        n = batch // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce_mean_(self, tensors) -> None:
        """Replace `tensors` by their means over the ranks: one all-reduce
        (sum) of one flat buffer, then a division by the world size."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        flat.div_(self.world_size)
        torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)])

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite `t` with rank `src`'s value, in place."""
        dist.broadcast(t, src=src, group=self.group)
        return t


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device) -> torch.device:
    """This rank's device: "cuda" names cuda:LOCAL_RANK (else cuda:rank
    modulo the cards visible), the card `initialize_distributed` selects.
    In a group of more than one rank a card other than that one raises
    ValueError: two ranks on one card fail in NCCL."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               % max(torch.cuda.device_count(), 1)))
    if device.index is None:
        return torch.device("cuda", local)
    if dist.get_world_size() > 1 and device.index != local:
        raise ValueError(f"rank {dist.get_rank()} computes on cuda:{local} "
                         f"(its local rank), not on {device}")
    return device


def data_mesh(device="cuda") -> DataMesh:
    """The 1D mesh over every rank of the default process group, on
    `device` (`cuda` unless the caller passes "cpu"; on the card rank r
    uses cuda:LOCAL_RANK). Without a process group it starts one of world
    size 1 in this process (NCCL on the card, gloo on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("data_mesh(device='cuda') needs a CUDA device; "
                           "pass device='cpu' for a gloo mesh")
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    backend = str(dist.get_backend())
    if _backend(device) not in backend:
        raise ValueError(f"a {device.type} mesh needs the "
                         f"{_backend(device)} backend; the process group "
                         f"uses {backend}")
    return DataMesh(None, dist.get_world_size(), dist.get_rank(),
                    _rank_device(device))


def cpu_mesh(n_devices: int) -> DataMesh:
    """A gloo mesh of `n_devices` CPU ranks. XLA can make n virtual CPU
    devices in one process; PyTorch cannot: n CPU ranks are n gloo
    processes (`parallel.scaling.run_ranks` starts them), and this checks
    that the default group has n of them (n = 1 starts a group of one)."""
    mesh = data_mesh("cpu")
    if mesh.world_size != n_devices:
        raise RuntimeError(
            f"need {n_devices} CPU ranks but the process group has "
            f"{mesh.world_size}: start {n_devices} gloo processes "
            "(parallel.scaling.run_ranks or torchrun --nproc_per_node)")
    return mesh


def tree_map(fn, tree):
    """`fn` over the tensor leaves of tuples, NamedTuples, lists and dicts
    (numpy arrays become tensors); other leaves are kept as they are."""
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_leading_axis(tree, mesh: DataMesh):
    """This rank's rows [r*B/n, (r+1)*B/n) of every leaf's leading axis
    (views); ValueError when B is not a multiple of the world size."""
    return tree_map(lambda x: x[mesh.rows(x.shape[0])], tree)


def replicate(tree, mesh: DataMesh):
    """Every tensor leaf overwritten in place with rank 0's value."""
    return tree_map(mesh.broadcast_, tree)


def put_sharded(tree, mesh: DataMesh):
    """A host batch moved to this rank's device, its rows only."""
    return shard_leading_axis(tree_map(lambda x: x.to(mesh.device), tree),
                              mesh)


def put_replicated(tree, mesh: DataMesh):
    """A tree moved to this rank's device, then rank 0's values on every
    rank."""
    return replicate(tree_map(lambda x: x.to(mesh.device).contiguous(), tree),
                     mesh)
