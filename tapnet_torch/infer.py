"""Serving surface: instances in, packing plans out. Port of
`tapnet_tpu/infer.py`.

`pack()` turns a batch of instances into executable transport-and-pack
plans, with the pointer actor (greedy decode, sampled decode, or best-of-K
sampled decode) or with a fixed heuristic (`first`: the lowest feasible
action, `random`: a uniform feasible action). It runs on `cuda` unless the
caller passes `device="cpu"`; on the card the decode steps go through the
port's CUDA kernels (`select_step` for greedy, `actor_select_step` for
sample and best) and a heuristic rollout is one launch of
`fused_rollout_batch`, each where it covers the config
(`train.rollout.routes`), else the general path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.models.tapnet import TAPNetActor
from tapnet_torch.types import EnvState, Instance


@dataclasses.dataclass(frozen=True)
class PackingStep:
    """One robot operation: which block, how, where it lands."""

    order: int        # 0-based transport order
    block: int        # block id in the instance
    rotation: int     # rotation state (0 = as-is)
    container: int    # target container index
    x: int
    y: int            # depth offset (0 in 2D)
    z: int            # landing height
    stable: bool


class PackingPlan:
    """Batched packing result (host numpy copies) with per-instance steps."""

    def __init__(self, states: EnvState, actions, rewards, cfg: TAPConfig):
        self.states = EnvState(*(np.asarray(x.cpu()) for x in states))
        self.actions = np.asarray(actions.cpu())
        self.rewards = np.asarray(rewards.cpu())
        self.cfg = cfg

    def __len__(self) -> int:
        return self.actions.shape[0]

    def steps(self, i: int) -> List[PackingStep]:
        """The executable transport sequence for instance i."""
        out: List[PackingStep] = []
        placements = self.states.placements[i]
        for a in self.actions[i]:
            if a < 0:
                continue
            b, _, _ = self.cfg.decompose_action(int(a))
            cc, rr, x, y, z, stable = (int(v) for v in placements[b])
            out.append(PackingStep(order=len(out), block=b, rotation=rr,
                                   container=cc, x=x, y=y, z=z,
                                   stable=bool(stable)))
        return out

    def complete(self, i: int) -> bool:
        """Did every real block of instance i get packed?"""
        return bool(self.states.packed[i].all())

    def heightmap(self, i: int) -> np.ndarray:
        return self.states.heightmap[i]


def _as_key(key, device) -> torch.Tensor:
    if key is None:
        return R.key(0, device)
    if isinstance(key, int):
        return R.key(key, device)
    return torch.as_tensor(key, dtype=torch.int64).to(device)


def pack(instances: Instance, cfg: TAPConfig,
         actor: Optional[TAPNetActor] = None, policy: str = "greedy",
         key: Union[int, torch.Tensor, None] = None,
         temperature: float = 1.0, n_samples: int = 16,
         device: Union[str, torch.device] = "cuda") -> PackingPlan:
    """Pack a batch of instances; returns a PackingPlan.

    instances: an Instance of [B, ...] tensors or numpy arrays (moved to
    `device`); actor: a TAPNetActor (`models.tapnet.init_params`, or
    `convert.actor_from_flax` for flax weights), moved to `device`;
    policy: "greedy" | "sample" | "best" (best-of-`n_samples` sampled
    decodes per instance) need the actor; "first" | "random" are the fixed
    heuristics and need none; key: an int seed or a threefry key [2]
    (default seed 0; per-instance keys are split(key, B), as in the JAX
    package); device: "cuda" by default, "cpu" for the reference path.
    """
    heuristic = policy in ("first", "random")
    if not heuristic and policy not in ("greedy", "sample", "best"):
        raise ValueError(policy)
    if actor is None and not heuristic:
        raise ValueError(f"policy={policy!r} needs an actor")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pack(device='cuda') needs a CUDA device; pass "
                           "device='cpu' for the reference path")
    from tapnet_torch.train.rollout import (policy_rollout_batch,
                                            policy_rollout_best_of, routes)

    instances = instances.to(device)
    key = _as_key(key, device)
    B = instances.dims.shape[0]
    if heuristic:
        from tapnet_torch.env.core import rollout_batch
        from tapnet_torch.ops.env import fused_rollout_batch
        on_card = device.type == "cuda"
        run = (fused_rollout_batch if routes(cfg, on_card).rollout
               else rollout_batch)
        return PackingPlan(*run(instances, R.split(key, B), cfg, policy),
                           cfg)
    actor = actor.to(device)
    if policy == "best":
        states, actions, rewards = policy_rollout_best_of(
            actor, instances, key, cfg, n_samples=n_samples,
            temperature=temperature)
    else:
        states, actions, rewards, _ = policy_rollout_batch(
            actor, instances, R.split(key, B), cfg,
            greedy=(policy == "greedy"), temperature=temperature)
    return PackingPlan(states, actions, rewards, cfg)
