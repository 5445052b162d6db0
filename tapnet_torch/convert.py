"""Flax parameters -> the port's `TAPNetActor` / `TAPNetCritic` state dicts.

Input: an actor's or critic's flax tree as nested dicts of numpy arrays, e.g.
`jax.tree.map(np.asarray, init_params(key, cfg, h)["actor"])`, with or
without the outer {"params": ...} level. Dense kernels are [in, out] in flax
and [out, in] in `nn.Linear`, so each is transposed; everything else maps
one to one. Both sides then compute the same function.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tapnet_torch.config import TAPConfig
from tapnet_torch.models.tapnet import TAPNetActor, TAPNetCritic


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, name)
        else:
            yield name, np.asarray(v)


def flax_to_state_dict(flax_params: Mapping) -> dict:
    """Nested flax actor params -> {name: float32 tensor} for load_state_dict."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    out = {}
    for name, arr in _flatten(flax_params):
        mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":
            out[f"{mod}.weight"] = t.T.contiguous()
        elif leaf == "embedding":
            out[f"{mod}.weight"] = t
        else:  # bias, LayerNorm scale/bias, v
            out[name] = t
    return out


def actor_from_flax(flax_params: Mapping, cfg: TAPConfig, hidden: int,
                    device=None) -> TAPNetActor:
    """A TAPNetActor holding the flax actor's weights, in eval mode."""
    actor = TAPNetActor(cfg, hidden)
    actor.load_state_dict(flax_to_state_dict(flax_params), strict=True)
    return actor.to(device).eval()


def critic_from_flax(flax_params: Mapping, cfg: TAPConfig, hidden: int,
                     device=None) -> TAPNetCritic:
    """A TAPNetCritic holding the flax critic's weights (flax names its
    Denses Dense_0..3 and hm_enc.Dense_0/1, as the module does)."""
    critic = TAPNetCritic(cfg, hidden)
    critic.load_state_dict(flax_to_state_dict(flax_params), strict=True)
    return critic.to(device)


def params_from_flax(tree: Mapping, cfg: TAPConfig, hidden: int,
                     device=None):
    """(actor, critic) from the {"actor", "critic"} tree of the JAX
    package's `init_params` (or a TrainState's params), as numpy arrays."""
    return (actor_from_flax(tree["actor"], cfg, hidden, device),
            critic_from_flax(tree["critic"], cfg, hidden, device))
