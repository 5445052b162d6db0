"""Tensor-parallel expressibility: a ("data", "model") device mesh and the
parameter placement rule, the port of `tapnet_tpu/parallel/tp.py` over
`torch.distributed.device_mesh` and DTensor.

As in the JAX package, DP stays the performance path (the pointer net is
~128 wide; sharding its GEMMs over cards is latency-bound): this is the
rule, expressible and checked. Megatron-style column sharding:
- an `nn.Linear` weight [out, in] whose `out` divides the "model" axis is
  `Shard(0)` (flax's kernel [in, out] under `P(None, "model")`);
- a 1-D parameter named `bias` whose length divides the axis is
  `Shard(0)` (`P("model")`): the Linear biases with their weights, and,
  as the JAX rule reads every leaf named `bias`, the LayerNorm biases too
  (their `scale` stays replicated);
- everything else is `Replicate()` (`P()`): the LayerNorm scales, the
  attention vector `v`, the `prev_embed` table (flax's `embedding`), a
  Linear whose `out` does not divide the axis (the critic's `Dense_3`).

`shard_params_tp` applies the rule to an actor or a critic: each sharded
Linear becomes `ColwiseParallel(output_layouts=Replicate())`
(`parallelize_module`), so its output is gathered and activations are
replicated at every module boundary, as the JAX docstring states; a
sharded LayerNorm bias is a DTensor that the LayerNorm gathers where it
reads it (`models.tapnet._full`); replicated parameters stay plain tensors,
the same on every rank. The sharded forward is then the module's own
forward (`TAPNetActor.forward`), equal to the replicated one up to float
reassociation in the gathered products. TP is a float32 path: the bf16
`_dense` and the kernels K2 and K5 read raw weights and are not reached
by it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               parallelize_module)
from torch.distributed.tensor.placement_types import Placement

from tapnet_torch.parallel.mesh import data_mesh


def data_model_mesh(n_data: int, n_model: int, device="cuda",
                    axes: Tuple[str, str] = ("data", "model")) -> DeviceMesh:
    """The n_data x n_model mesh over the ranks of the default process
    group (rank r at (r // n_model, r % n_model)), on `device`'s type:
    "cuda" (NCCL; the default) or "cpu" (gloo). Without a process group it
    starts one of world size 1 in this process (`parallel.data_mesh`).
    RuntimeError when the group has fewer ranks than n_data * n_model, as
    the JAX function raises for devices; ValueError when it has more (a
    mesh spans the whole group)."""
    world = data_mesh(device).world_size
    n = n_data * n_model
    if world < n:
        raise RuntimeError(f"need {n} devices, found {world}")
    if world > n:
        raise ValueError(f"a {n_data} x {n_model} mesh spans the whole "
                         f"process group, which has {world} ranks")
    return init_device_mesh(torch.device(device).type, (n_data, n_model),
                            mesh_dim_names=tuple(axes))


def tp_spec(name: str, tensor: torch.Tensor, n_model: int,
            owner: nn.Module) -> Placement:
    """The placement on the "model" axis of one parameter, by its
    state-dict name, its shape and the module that holds it (`owner`; a
    2-D `weight` is column-sharded only when its owner is an nn.Linear:
    an nn.Embedding's table is flax's `embedding`, replicated)."""
    leaf = name.rsplit(".", 1)[-1]
    if (leaf == "weight" and isinstance(owner, nn.Linear)
            and tensor.dim() == 2 and tensor.shape[0] % n_model == 0):
        return Shard(0)
    if leaf == "bias" and tensor.dim() == 1 and tensor.shape[0] % n_model == 0:
        return Shard(0)
    return Replicate()


def _specs(module: nn.Module, n_model: int) -> Dict[str, Placement]:
    owners = dict(module.named_modules())
    return {name: tp_spec(name, p, n_model,
                          owners[name.rpartition(".")[0]])
            for name, p in module.named_parameters()}


def tp_sharding_tree(module: nn.Module, mesh: DeviceMesh,
                     axis: str = "model") -> Dict[str, tuple]:
    """{parameter name: its placements over the mesh's dims}: `tp_spec` on
    `axis`, Replicate() on every other dim (what `shard_params_tp`
    applies)."""
    dims = mesh.mesh_dim_names
    n_model = mesh.size(dims.index(axis))
    return {name: tuple(spec if d == axis else Replicate() for d in dims)
            for name, spec in _specs(module, n_model).items()}


def shard_params_tp(module: nn.Module, mesh: DeviceMesh,
                    axis: str = "model") -> nn.Module:
    """Shard `module` (an actor or a critic, on this rank's device) in place
    by `tp_spec` over the mesh's `axis` and return it; see the module
    docstring. Every rank must hold the same parameters (as after
    `parallel.broadcast_from_main`)."""
    sub = mesh[axis]
    n_model = sub.size()
    specs = _specs(module, n_model)
    plan = {}
    for name, m in module.named_modules():
        if isinstance(m, nn.Linear):
            if isinstance(specs[f"{name}.weight"], Shard):
                plan[name] = ColwiseParallel(output_layouts=Replicate())
        elif (isinstance(getattr(m, "bias", None), nn.Parameter)
              and isinstance(specs[f"{name}.bias"], Shard)):
            # a LayerNorm's bias: a DTensor its forward gathers
            m.bias = nn.Parameter(distribute_tensor(m.bias.detach(), sub,
                                                    [Shard(0)]))
    parallelize_module(module, sub, plan)
    return module
