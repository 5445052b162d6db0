"""Multi-process runtime bring-up over torch.distributed, the port of
`tapnet_tpu/parallel/distributed.py`.

One process per device (rank); `initialize_distributed` joins them into
the default process group, after which `parallel.mesh.data_mesh` spans
every rank and the same train step runs sharded over them. torchrun sets
the configuration (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK);
explicit arguments override it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from tapnet_torch.parallel.mesh import DataMesh, put_sharded, tree_map


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the default process group if a multi-process run is configured.

    Returns True if the group was initialized (or already was). The
    coordinator is "host:port" (default MASTER_ADDR:MASTER_PORT), the world
    size and rank default to WORLD_SIZE and RANK; on the card the process
    takes cuda:LOCAL_RANK (else cuda:rank) on its host. The backend
    defaults to NCCL where there is a card, else gloo. With neither
    arguments nor the environment it is a no-op that returns False, so the
    same entry point works in one process."""
    env = os.environ
    if (coordinator_address is None and "MASTER_ADDR" in env
            and "MASTER_PORT" in env):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs the world size and "
                         "the rank (arguments or WORLD_SIZE and RANK)")
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_global(tree, mesh: DataMesh, spec: Optional[str] = None):
    """Global values from per-rank data: every rank passes the FULL logical
    value of every leaf. spec None: replicated, the leaves moved to this
    rank's device as they are; spec "data" (the mesh's one axis): this
    rank's rows of the leading axis. Works in one process too, so callers
    need no branch."""
    if spec not in (None, "data"):
        raise ValueError(f"spec {spec!r} names no axis of the mesh ('data')")
    if spec is None:
        return tree_map(lambda x: x.to(mesh.device), tree)
    return put_sharded(tree, mesh)


def local_value(x):
    """This rank's view of a replicated value. In PyTorch every rank holds
    its own full copy, so this is the value itself."""
    return x


def _state_tensors(ts):
    """The tensors of a TrainState that a broadcast must carry: parameters
    and buffers, the flat Adam moments and count, and the key."""
    out = [t.data for m in (ts.actor, ts.critic)
           for t in list(m.parameters()) + list(m.buffers())]
    out += [ts.opt._mu, ts.opt._nu, ts.opt._count, ts.key]
    return out


def broadcast_from_main(tree, group: Optional[dist.ProcessGroup] = None):
    """Replace every rank's values by rank 0's, in place, and return the
    tree: a TrainState (parameters, the flat Adam moments, the count, the
    step and the key) or a tree of tensors. Rank 0 reads a checkpoint and
    the others receive it, so only rank 0 touches the filesystem. Without
    a process group, or in a world of one, it returns the tree as it is."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    with torch.no_grad():
        if hasattr(tree, "opt") and hasattr(tree, "actor"):
            for t in _state_tensors(tree):
                dist.broadcast(t, src=0, group=group)
            step = torch.full((), tree.step, dtype=torch.int64,
                              device=tree.key.device)
            dist.broadcast(step, src=0, group=group)
            tree.step = int(step)
            return tree
        return tree_map(lambda t: dist.broadcast(t, src=0, group=group)
                        or t, tree)
