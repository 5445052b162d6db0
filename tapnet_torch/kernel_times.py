"""Device times of K1, K2 and K4 at the main paths' shapes, as one JSON line.

    python -m tapnet_torch.kernel_times [--tag NAME]

select_step (K1) on the middle step of a greedy rollout of 2d-basic and
2d-rolling at batch 4096 and of multi-container-capped at batch 256 (the
capped train step's shape); actor_select_step (K2) in both modes on the
middle decode step of a sampled rollout of 2d-basic and 2d-rolling at
batch 4096; fused_rollout_batch (K4) on `random` draws of the six CONFIGS
at batch 4096. Each time is the median of 50 launches (CUDA events after
a spin kernel, `chip_smoke.time_gpu`).

To compare two checkouts on one card in one call,

    python -m tapnet_torch.kernel_times --tree ../parent --tag parent

runs this file in a child process from the root of the other checkout, so
that it times that checkout's `tapnet_torch` with its `chip_smoke.py`
(which needs only `time_gpu`, `check_select_step`, `actor_operands` and
`_instances` there). Run from the repository root; needs a CUDA device and
nvcc.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--tree", default="",
                    help="time the kernels of the checkout at this path")
    args = ap.parse_args(argv)
    if args.tree:
        code = ("import runpy, sys; sys.argv = ['kernel_times', '--tag', "
                f"{args.tag!r}]; runpy.run_path({os.path.abspath(__file__)!r}"
                ", run_name='__main__')")
        return subprocess.run([sys.executable, "-c", code],
                              cwd=args.tree).returncode
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from tapnet_torch import CONFIGS
    from tapnet_torch import random as R
    from tapnet_torch.env import core as E
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import _build
    from tapnet_torch.ops import actor_step as AS
    from tapnet_torch.ops import env as OE
    from tapnet_torch.ops import policy_step as PS
    from tapnet_torch.train import rollout as RO

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    _build.build_all()
    out = {"tag": args.tag, "device": torch.cuda.get_device_name(0)}
    for name, B in (("2d-basic", 4096), ("2d-rolling", 4096),
                    ("multi-container-capped", 256)):
        cfg = CONFIGS[name]
        ops = CS.check_select_step(cfg, B, init_params(0, cfg, 128, dev),
                                   dev, keep=True)
        out[f"K1 {name}"] = CS.time_gpu(
            lambda: PS.select_step(*ops, cfg=cfg), reps=50)
    for name in ("2d-basic", "2d-rolling"):
        cfg, B, N = CONFIGS[name], 4096, CONFIGS[name].num_blocks
        actor = init_params(0, cfg, 128, dev)
        inst = CS._instances(cfg, B, dev, 9)
        with torch.no_grad():  # to the middle step on the kernel's outputs
            o = CS.actor_operands(actor, inst, cfg, R.split(R.key(3, dev), B))
            (dw, dd, dh), packed, hm, plc = RO._batch_last(inst, cfg)
            prev = torch.full((1, B), -1, dtype=torch.int32, device=dev)
            for t in range(N // 2 + 1):
                tf = torch.full((1, 1), t / N, device=dev)
                ops = (tf, packed, hm, plc, prev, dw, dd, dh, o["upm"],
                       o["rotm"], o["fits"], o["g_all"][t], o["se"],
                       o["ctx"], o["statp"], o["statm"], o["params"])
                if t == N // 2:
                    break
                got = AS.actor_select_step(*ops, cfg, logits=False,
                                           params_t=o["params_t"])
                packed, hm, plc, prev = got[0], got[1], got[2], got[3][None]
        pt = o["params_t"]
        out[f"K2 main {name}"] = CS.time_gpu(lambda: AS.actor_select_step(
            *ops, cfg, logits=False, params_t=pt), reps=50)
        out[f"K2 full {name}"] = CS.time_gpu(lambda: AS.actor_select_step(
            *ops, cfg, params_t=pt), reps=50)
    for name, cfg in CONFIGS.items():
        inst = CS._instances(cfg, 4096, dev, 25)
        rbits = E.policy_bits(R.split(R.key(26, dev), 4096), cfg, "random")
        kops = OE.rollout_operands(inst, rbits, cfg)
        out[f"K4 {name}"] = CS.time_gpu(lambda: OE.rollout_kernel(kops, cfg),
                                        reps=50)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
