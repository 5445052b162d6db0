"""Oracle rollout driver: fixed-policy trajectories for parity testing, the
port's copy of `tapnet_tpu/oracle/rollout.py` (threefry draws from
`tapnet_torch.random`; a key is an int64 tensor [2]).

The reference's rollout interleaves a learned policy with the env loop
(SURVEY.md §3.1); for bit-exactness testing we also define two closed-form
policies both worlds can reproduce exactly:

- "first":  lowest feasible action index.
- "random": uniform over feasible actions via threefry bits — at step t the
  chosen action is the (bits(fold_in(key, t)) % n_feasible)-th feasible action
  in index order.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.oracle.env import OracleEnv
from tapnet_torch.types import Instance


def rollout_rbits(key, cfg: TAPConfig) -> np.ndarray:
    """All "random"-policy threefry draws for one rollout: uint32[N] with
    rbits[t] = bits(fold_in(key, t)) — the exact per-step stream
    select_action draws inline (SPEC.md §10), precomputable so timing the
    oracle measures env math rather than tensor-op dispatch latency."""
    ts = torch.arange(cfg.num_blocks)
    return R.bits(R.fold_in(key[None, :], ts)).cpu().numpy().astype(
        np.uint32)


def select_action(mask: np.ndarray, policy: str, key, t: int,
                  rbits: Optional[np.ndarray] = None) -> int:
    feas = np.nonzero(mask)[0]
    assert feas.size > 0
    if policy == "first":
        return int(feas[0])
    if policy == "random":
        if rbits is not None:
            r = int(rbits[t])
        else:
            r = int(R.bits(R.fold_in(key, t)))
        return int(feas[r % feas.size])
    raise ValueError(policy)


def oracle_rollout(instance: Instance, cfg: TAPConfig, policy: str = "first",
                   key=None, rbits: Optional[np.ndarray] = None):
    """Roll one instance to termination; returns (env, actions, masks).

    rbits: optional precomputed uint32[N] threefry stream (rollout_rbits);
    bit-identical to drawing inline from `key`."""
    env = OracleEnv(instance, cfg)
    actions: List[int] = []
    masks: List[np.ndarray] = []
    for t in range(cfg.num_blocks):
        if env.done():
            actions.append(-1)
            masks.append(np.zeros(cfg.num_actions, dtype=bool))
            continue
        mask = env.action_mask()
        masks.append(mask)
        if not mask.any():  # no feasible action: no-op step (SPEC.md §5)
            actions.append(-1)
            continue
        a = select_action(mask, policy, key, t, rbits)
        env.step(a)
        actions.append(a)
    return env, np.asarray(actions, dtype=np.int32), np.asarray(masks)
