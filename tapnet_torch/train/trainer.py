"""Training loop: epochs of train steps, greedy validation, JSONL metrics
and checkpoints, the port of `tapnet_tpu/train/trainer.py`.

An epoch is `steps_per_epoch` train steps (instances sampled on the
device; with `mixed_p2d` a mixed 2D/3D batch), then a greedy-decode
validation on a fixed held-out key, one metrics line and a checkpoint.
With `steps_per_call` = k each call runs k steps, and the loop counts steps
as the JAX trainer does: one call that is not timed, then (n - 1) // k timed
calls, so step numbers, metrics lines and checkpoint names are the JAX
trainer's for the same settings. `trace_dir` traces 3 calls of epoch 0
(`utils.profiling.trace`), `nan_checks` checks the state and metrics
between calls (`utils.debug`), `tb_dir` writes TensorBoard scalars beside
the JSONL (`train.metrics`). Every field of the JAX package's
TrainLoopConfig is kept.

With a `mesh` (`parallel.mesh.DataMesh`) every rank runs the same sequence
of sharded steps; rank 0 owns every filesystem side effect (checkpoints,
the JSONL metrics, the TensorBoard scalars, the trace) and the held-out
evaluation, and a restore is read on rank 0 and broadcast
(`parallel.distributed.broadcast_from_main`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.env import core as E
from tapnet_torch.env.sampler import sample_batch, sample_batch_mixed
from tapnet_torch.ops.env import fused_rollout_batch
from tapnet_torch.parallel.distributed import broadcast_from_main
from tapnet_torch.train import checkpoints as ckpt
from tapnet_torch.train import rollout as RO
from tapnet_torch.train.metrics import MetricsLogger
from tapnet_torch.train.reinforce import (TrainState, resolve_device,
                                          init_train_state, make_train_step)
from tapnet_torch.train.rollout import (policy_rollout_batch,
                                        policy_rollout_best_of)
from tapnet_torch.utils.debug import assert_finite
from tapnet_torch.utils.profiling import StepsPerSecond, annotate, trace


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
    trace_dir: Optional[str] = None   # profiler trace of 3 calls of epoch 0
    mixed_p2d: float = 0.0            # P(instance is flat/2D); 3D envs only
    steps_per_call: int = 1           # steps per call (a CUDA graph)
    tb_dir: Optional[str] = None      # TensorBoard scalars (rank 0)
    deterministic: bool = False       # assert bit-identical repeat of a step
    nan_checks: bool = False          # finite checks between calls
    eval_best_of: int = 1             # >1: also best-of-K sampled decode


@torch.no_grad()
def evaluate(actor, cfg: TAPConfig, loop: TrainLoopConfig,
             baselines: bool = False, device="cuda"):
    """Greedy-decode validation on a fixed held-out instance stream: mean
    reward, C/P/S, best-of-K when asked, the per-container share of placed
    blocks, with `mixed_p2d` the share of flat instances (`valid_2d_frac`)
    and, with `baselines`, the mean rewards of the `random` and `first`
    heuristics on the same instances and keys. Runs on `cuda` (the actor is
    moved there) unless `device="cpu"`."""
    dev = resolve_device(device)
    actor = actor.to(dev)
    key = R.key(loop.valid_seed, dev)
    if loop.mixed_p2d > 0:
        instances = sample_batch_mixed(key, loop.valid_batch, cfg,
                                       loop.mixed_p2d)
    else:
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
    if loop.mixed_p2d > 0:
        out["valid_2d_frac"] = (instances.dims[:, :, 1].amax(1)
                                == 1).float().mean()
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


def _finite_targets(ts: TrainState, metrics=None) -> dict:
    """{name: tensor} of what `nan_checks` holds finite: the parameters,
    both Adam moments and the metrics."""
    out = {}
    for part, module in (("actor", ts.actor), ("critic", ts.critic)):
        for name, p in module.named_parameters():
            state = ts.opt.state[p]
            out[f"{part}.{name}"] = p
            out[f"adam.mu.{part}.{name}"] = state["exp_avg"]
            out[f"adam.nu.{part}.{name}"] = state["exp_avg_sq"]
    out.update({f"metrics.{k}": v for k, v in (metrics or {}).items()})
    return out


def train(cfg: TAPConfig, loop: TrainLoopConfig, resume: bool = True,
          device="cuda", mesh=None) -> TrainState:
    """Train for loop.epochs x loop.steps_per_epoch steps (continuing from
    the newest checkpoint in loop.ckpt_dir when `resume`, the port's `.pt`
    or the JAX package's `.msgpack`); returns the final TrainState. Runs on
    `cuda` unless `device="cpu"`; with a `mesh`, on its device, sharded over
    its ranks (`loop.batch` is the global batch)."""
    check = assert_finite if loop.nan_checks else None
    is_main = mesh is None or mesh.rank == 0
    logger = MetricsLogger(loop.metrics_path if is_main else None,
                           echo=is_main,
                           tb_dir=loop.tb_dir if is_main else None)
    try:
        if mesh is not None:
            device = mesh.device
        ts = init_train_state(loop.seed, cfg, loop.hidden, loop.lr, device)
        dev = ts.key.device
        if resume and loop.ckpt_dir:
            path = ckpt.latest_checkpoint(loop.ckpt_dir) if is_main else None
            if path:
                ts = ckpt.restore_checkpoint(path, ts)
                logger.log(ts.step, {}, event="resumed", ckpt=path)
            if mesh is not None:
                ts = broadcast_from_main(ts, mesh.group)
        if check:
            check(_finite_targets(ts), "before the first step")
        spc = max(1, loop.steps_per_call)
        step = make_train_step(cfg, loop.batch, loop.hidden, loop.lr,
                               loop.clip, loop.temperature,
                               mesh=mesh, mixed_p2d=loop.mixed_p2d,
                               steps_per_call=spc, device=dev)

        def train_step(ts):
            ts, metrics = step(ts)
            if check:
                check(_finite_targets(ts, metrics), f"at step {ts.step}")
            return ts, metrics

        if loop.deterministic:
            assert_deterministic(step, ts)
            logger.log(ts.step, {}, event="deterministic-check-passed")
        total = loop.epochs * loop.steps_per_epoch
        sps = StepsPerSecond(loop.batch * cfg.num_blocks,
                             n_devices=1 if mesh is None else mesh.world_size)
        traced = False
        while ts.step < total:
            epoch = ts.step // loop.steps_per_epoch
            n_steps = loop.steps_per_epoch - ts.step % loop.steps_per_epoch
            ts, metrics = train_step(ts)  # may capture a graph: not timed
            _sync(dev)
            if loop.trace_dir and not traced:
                # a trace of 3 steady-state calls, as the JAX trainer takes
                # (every rank runs them; rank 0 writes the trace)
                traced = True
                with (trace(loop.trace_dir) if is_main
                      else contextlib.nullcontext()):
                    for _ in range(min(3, max(n_steps - 1, 1))):
                        with annotate("train_step"):
                            ts, metrics = train_step(ts)
                    _sync(dev)
                n_steps = (loop.steps_per_epoch
                           - ts.step % loop.steps_per_epoch)
            sps.reset()
            calls = max(0, (n_steps - 1) // spc)
            for _ in range(calls):
                ts, metrics = train_step(ts)
            _sync(dev)
            sps.update(calls * spc)
            rates = sps.metrics()  # the timed calls, before evaluation
            valid = {}
            if is_main:   # rank 0 alone evaluates its own copy: no collective
                with annotate("evaluate"):
                    valid = evaluate(ts.actor, cfg, loop, device=dev)
            logger.log(ts.step, metrics, epoch=epoch, **rates, **valid)
            if loop.ckpt_dir and is_main:
                ckpt.save_checkpoint(loop.ckpt_dir, ts)
    finally:
        logger.close()
    return ts
