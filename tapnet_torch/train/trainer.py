"""Training loop: epochs of train steps, greedy validation, JSONL metrics
and checkpoints, the port of `tapnet_tpu/train/trainer.py`.

An epoch is `steps_per_epoch` train steps (instances sampled on the
device), then a greedy-decode validation on a fixed held-out key, one
metrics line and a checkpoint. Every field of the JAX package's
TrainLoopConfig is kept; the ones this port does not support yet raise
NotImplementedError when set.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch
from tapnet_torch.ops.env import fused_rollout_batch
from tapnet_torch.train import checkpoints as ckpt
from tapnet_torch.train import rollout as RO
from tapnet_torch.train.metrics import MetricsLogger
from tapnet_torch.train.reinforce import (TrainState, resolve_device,
                                          init_train_state, make_train_step)
from tapnet_torch.train.rollout import (policy_rollout_batch,
                                        policy_rollout_best_of)


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    epochs: int = 10
    steps_per_epoch: int = 100
    batch: int = 128
    valid_batch: int = 256
    hidden: int = 128
    lr: float = 5e-4
    clip: float = 2.0
    temperature: float = 1.0
    seed: int = 0
    valid_seed: int = 10_000
    ckpt_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    trace_dir: Optional[str] = None   # not ported: raises
    mixed_p2d: float = 0.0            # not ported: raises
    steps_per_call: int = 1           # not ported beyond 1: raises
    tb_dir: Optional[str] = None      # not ported: raises
    deterministic: bool = False       # assert bit-identical repeat of a step
    nan_checks: bool = False          # not ported: raises
    eval_best_of: int = 1             # >1: also best-of-K sampled decode


def _check_supported(loop: TrainLoopConfig):
    for name, unset in (("trace_dir", None), ("mixed_p2d", 0.0),
                        ("steps_per_call", 1), ("tb_dir", None),
                        ("nan_checks", False)):
        if getattr(loop, name) != unset:
            raise NotImplementedError(
                f"TrainLoopConfig.{name} is not ported yet (ROADMAP.md, port "
                "Queue 1)")


@torch.no_grad()
def evaluate(actor, cfg: TAPConfig, loop: TrainLoopConfig,
             baselines: bool = False, device="cuda"):
    """Greedy-decode validation on a fixed held-out instance stream: mean
    reward, C/P/S, best-of-K when asked, the per-container share of placed
    blocks and, with `baselines`, the mean rewards of the `random` and
    `first` heuristics on the same instances and keys. Runs on `cuda` (the
    actor is moved there) unless `device="cpu"`."""
    if loop.mixed_p2d > 0:
        raise NotImplementedError("sample_batch_mixed is not ported yet "
                                  "(ROADMAP.md, port Queue 1)")
    dev = resolve_device(device)
    actor = actor.to(dev)
    key = R.key(loop.valid_seed, dev)
    instances = sample_batch(key, loop.valid_batch, cfg)
    keys = R.split(key, loop.valid_batch)
    states, _, rewards, _ = policy_rollout_batch(actor, instances, keys, cfg,
                                                 greedy=True)
    vol, dc, dp, sn, sd = E.reward_terms(states, instances, cfg)
    f = lambda n, d: (n.float() / d.clamp(min=1).float()).mean()
    out = {"valid_reward": rewards.mean(), "valid_C": f(vol, dc),
           "valid_P": f(vol, dp), "valid_S": f(sn, sd)}
    if loop.eval_best_of > 1:
        _, _, r_bo = policy_rollout_best_of(actor, instances, key, cfg,
                                            n_samples=loop.eval_best_of)
        out[f"valid_reward_bo{loop.eval_best_of}"] = r_bo.mean()
    if cfg.num_containers > 1:
        cont = states.placements[:, :, 0]
        placed_n = (cont >= 0).sum().clamp(min=1)
        for c in range(cfg.num_containers):
            out[f"valid_container{c}_frac"] = (cont == c).sum() / placed_n
    if baselines:
        on_card = dev.type == "cuda"
        run = (fused_rollout_batch if RO.routes(cfg, on_card).rollout
               else E.rollout_batch)
        for policy in ("random", "first"):
            out[f"{policy}_reward"] = run(instances, keys, cfg,
                                          policy)[2].mean()
    return out


def _state_tensors(ts: TrainState):
    opt = ts.opt.state_dict()["state"]
    return ([p.detach() for p in ts.parameters()]
            + [v for s in opt.values() for v in s.values()
               if isinstance(v, torch.Tensor)] + [ts.key])


def assert_deterministic(step, ts: TrainState):
    """Run `step` twice from deep copies of `ts` (which stays as it is);
    params, optimizer state, key and metrics must be bit-identical."""
    runs = []
    for _ in range(2):
        t, m = step(copy.deepcopy(ts))
        runs.append(_state_tensors(t) + [m[k] for k in sorted(m)])
    for a, b in zip(*runs):
        if not torch.equal(a, b):
            raise AssertionError("non-deterministic train step: run 1 vs "
                                 "run 2 differ")


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: TAPConfig, loop: TrainLoopConfig, resume: bool = True,
          device="cuda") -> TrainState:
    """Train for loop.epochs x loop.steps_per_epoch steps (continuing from
    the newest checkpoint in loop.ckpt_dir when `resume`); returns the
    final TrainState. Runs on `cuda` unless `device="cpu"`."""
    _check_supported(loop)
    ts = init_train_state(loop.seed, cfg, loop.hidden, loop.lr, device)
    dev = ts.key.device
    logger = MetricsLogger(loop.metrics_path)
    try:
        if resume and loop.ckpt_dir:
            path = ckpt.latest_checkpoint(loop.ckpt_dir)
            if path:
                ts = ckpt.restore_checkpoint(path, ts)
                logger.log(ts.step, {}, event="resumed", ckpt=path)
        train_step = make_train_step(cfg, loop.batch, loop.hidden, loop.lr,
                                     loop.clip, loop.temperature,
                                     device=dev)
        if loop.deterministic:
            assert_deterministic(train_step, ts)
            logger.log(ts.step, {}, event="deterministic-check-passed")
        total = loop.epochs * loop.steps_per_epoch
        metrics = {}
        while ts.step < total:
            epoch = ts.step // loop.steps_per_epoch
            n_steps = loop.steps_per_epoch - ts.step % loop.steps_per_epoch
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n_steps):
                ts, metrics = train_step(ts)
            _sync(dev)
            dt = time.perf_counter() - t0
            sps = n_steps * loop.batch * cfg.num_blocks / max(dt, 1e-9)
            valid = evaluate(ts.actor, cfg, loop, device=dev)
            logger.log(ts.step, metrics, epoch=epoch,
                       env_steps_per_s=round(sps, 1), **valid)
            if loop.ckpt_dir:
                ckpt.save_checkpoint(loop.ckpt_dir, ts)
    finally:
        logger.close()
    return ts
