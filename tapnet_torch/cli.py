"""Command-line driver of the PyTorch/CUDA port: train / eval / generate /
render / bench, the port of `tapnet_tpu/cli.py` with its tasks, flags and
JSON outputs.

    python -m tapnet_torch.cli [--device cuda|cpu] <task> ...
    torchrun --nproc_per_node=N -m tapnet_torch.cli [--device cpu] \
        train --mesh ...

`--device` (default `cuda`) takes the place of the JAX CLI's `--platform`:
every task runs on the card unless `--device cpu` is given, and fails when
there is no card. `eval --ckpt-dir` reads the port's `.pt` checkpoints and
the JAX package's `.msgpack` ones. `train --mesh` trains data-parallel over
the ranks torchrun starts (NCCL on the card, gloo with `--device cpu`;
`--batch` is the global batch); `train --tb-dir` writes TensorBoard
scalars (rank 0). `render` rolls one sampled instance with the `random`
heuristic on the device and draws it with matplotlib on the host (PNG, or
with `--sequence` one panel per placement, or a GIF for a `.gif` path).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def build_config(args):
    """The TAPConfig of the flags: a named config (with `--reward_type`
    overriding its rule), else the geometry flags."""
    from tapnet_torch.config import CONFIGS, TAPConfig

    if args.config:
        cfg = CONFIGS[args.config]
        if args.reward_type is not None:
            return dataclasses.replace(cfg, reward_type=args.reward_type)
        return cfg
    dim = args.obj_dim
    depth = args.container_depth if dim == 3 else 1
    return TAPConfig(
        dim=dim,
        num_blocks=args.num_blocks,
        min_blocks=args.min_blocks or args.num_blocks,
        container_width=args.container_width,
        container_depth=depth,
        container_height=args.container_height,
        target_width=args.target_width or args.container_width,
        target_depth=args.target_depth or depth,
        target_height=args.target_height,
        num_containers=args.num_containers,
        allow_rot=args.allow_rot,
        window=args.window,
        reward_type=args.reward_type or "C+P+S-lb-soft",
    )


def add_config_flags(p: argparse.ArgumentParser):
    from tapnet_torch.config import CONFIGS
    p.add_argument("--config", choices=list(CONFIGS),
                   help="named driver config (overrides geometry flags)")
    p.add_argument("--obj_dim", type=int, default=2, choices=(2, 3))
    p.add_argument("--num-blocks", type=int, default=10)
    p.add_argument("--min-blocks", type=int, default=0,
                   help="0 => fixed block count (= --num-blocks)")
    p.add_argument("--container-width", type=int, default=10)
    p.add_argument("--container-depth", type=int, default=8)
    p.add_argument("--container-height", type=int, default=10)
    p.add_argument("--target-width", type=int, default=0)
    p.add_argument("--target-depth", type=int, default=0)
    p.add_argument("--target-height", type=int, default=0,
                   help="0 => unbounded")
    p.add_argument("--num-containers", type=int, default=1)
    p.add_argument("--allow_rot", action="store_true")
    p.add_argument("--window", type=int, default=0)
    p.add_argument("--reward_type", default=None,
                   help="e.g. C+P+S-lb-soft / C+P-lb-hard")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tapnet_torch", description=__doc__)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; fails without a card) or cpu, "
                             "the reference path")
    sub = parser.add_subparsers(dest="task", required=True)

    p = sub.add_parser("train", help="REINFORCE training")
    add_config_flags(p)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--valid-batch", type=int, default=256)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--metrics", default=None, help="metrics JSONL path")
    p.add_argument("--tb-dir", default=None, dest="tb_dir",
                   help="also write TensorBoard scalar summaries here")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="data parallelism over the torch.distributed ranks "
                        "(torchrun), the batch sharded over them")
    p.add_argument("--mixed-p2d", type=float, default=0.0,
                   help="P(instance is flat/2D) for mixed 2D/3D batches "
                        "(driver config 5; 3D envs only)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   dest="steps_per_call",
                   help="train steps per call (on the card one captured "
                        "step replayed as a CUDA graph)")
    p.add_argument("--deterministic", action="store_true",
                   help="assert one train step repeats bit-identically "
                        "before training")
    p.add_argument("--nan-checks", action="store_true", dest="nan_checks",
                   help="check parameters, Adam moments and metrics for "
                        "NaN/inf between calls")
    p.add_argument("--trace-dir", default=None, dest="trace_dir",
                   help="write a torch.profiler trace (Chrome/Perfetto "
                        "JSON) of 3 steady-state calls in epoch 0")

    p = sub.add_parser("eval", help="greedy evaluation of a checkpoint")
    add_config_flags(p)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--seed", type=int, default=10_000)
    p.add_argument("--baselines", action="store_true",
                   help="also score the random/first heuristics on the "
                        "same held-out instances")
    p.add_argument("--mixed-p2d", type=float, default=0.0,
                   help="evaluate on a mixed 2D/3D instance stream")

    p = sub.add_parser("generate", help="write an instance dataset file")
    add_config_flags(p)
    p.add_argument("--num", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)

    p = sub.add_parser("render", help="render a random-policy rollout "
                       "(PNG; --sequence: per-step panels, or a GIF for a "
                       ".gif path)")
    add_config_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--sequence", action="store_true")

    p = sub.add_parser("bench", help="env-steps/s of the heuristic rollout "
                       "(benchmarks.measure_env_steps_per_s)")
    add_config_flags(p)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--iters", type=int, default=10)
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.task == "train" and args.mesh:
        # first: on the card joining the group selects cuda:LOCAL_RANK,
        # the card that "cuda" then names
        from tapnet_torch.parallel import initialize_distributed
        initialize_distributed(
            backend="nccl" if args.device == "cuda" else "gloo")
    from tapnet_torch.train.reinforce import resolve_device
    device = resolve_device(args.device)
    cfg = build_config(args)

    if args.task == "bench":
        from tapnet_torch.benchmarks import measure_env_steps_per_s
        sps = measure_env_steps_per_s(cfg, args.batch, args.iters,
                                      device=device)
        print(json.dumps({"env_steps_per_s": round(sps, 1),
                          "batch": args.batch}))
        return 0

    if args.task == "train":
        from tapnet_torch.train.trainer import TrainLoopConfig, train
        from tapnet_torch.parallel import data_mesh
        mesh = data_mesh(device) if args.mesh else None
        loop = TrainLoopConfig(
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            batch=args.batch, valid_batch=args.valid_batch,
            hidden=args.hidden, lr=args.lr, seed=args.seed,
            ckpt_dir=args.ckpt_dir, metrics_path=args.metrics,
            mixed_p2d=args.mixed_p2d, steps_per_call=args.steps_per_call,
            trace_dir=args.trace_dir, tb_dir=args.tb_dir,
            deterministic=args.deterministic, nan_checks=args.nan_checks)
        try:
            train(cfg, loop, resume=not args.no_resume, device=device,
                  mesh=mesh)
        finally:
            if mesh is not None:
                import torch.distributed as dist
                dist.destroy_process_group()
        return 0

    if args.task == "eval":
        from tapnet_torch.train import checkpoints as ckpt
        from tapnet_torch.train.reinforce import init_train_state
        from tapnet_torch.train.trainer import TrainLoopConfig, evaluate
        path = ckpt.latest_checkpoint(args.ckpt_dir)
        if not path:
            print(f"no checkpoint under {args.ckpt_dir}", file=sys.stderr)
            return 1
        ts = ckpt.restore_checkpoint(
            path, init_train_state(0, cfg, args.hidden, device=device))
        loop = TrainLoopConfig(hidden=args.hidden, valid_batch=args.batch,
                               valid_seed=args.seed,
                               mixed_p2d=args.mixed_p2d)
        out = evaluate(ts.actor, cfg, loop, baselines=args.baselines,
                       device=device)
        print(json.dumps({"ckpt": path, "step": int(ts.step),
                          **{k: float(v) for k, v in out.items()}}))
        return 0

    if args.task == "render":
        from tapnet_torch import random as R
        from tapnet_torch.env import core as E
        from tapnet_torch.env.sampler import sample_instance
        from tapnet_torch.types import Instance
        from tapnet_torch.utils.viz import (render, render_animation,
                                            render_sequence)
        key = R.key(args.seed, device)
        inst = Instance(*(x[0] for x in sample_instance(key[None], cfg)))
        state, actions, reward = E.rollout(inst, key, cfg, policy="random")
        if args.sequence and args.out.endswith(".gif"):
            out = render_animation(inst, actions, cfg, args.out)
        elif args.sequence:
            out = render_sequence(inst, actions, cfg, args.out)
        else:
            out = render(inst, state, cfg, args.out,
                         title=f"reward={float(reward):.3f}")
        print(json.dumps({"path": out, "reward": float(reward)}))
        return 0

    from tapnet_torch.utils.data import generate_dataset
    path = generate_dataset(args.out, cfg, args.num, args.seed,
                            device=device)
    print(json.dumps({"path": path, "num": args.num}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
