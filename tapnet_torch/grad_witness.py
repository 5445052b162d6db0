"""The float32 replay backward against its plain version on one record, with
the float64 value of each encoder pre-activation that a disagreement
points at.

    python -m tapnet_torch.grad_witness [--config 2d-rolling] [--hidden 160]
        [--batch 256] [--seed 10] [--out FILE]

It records a sampled rollout of `--batch` instances of `--config` at hidden
width `--hidden` (weights from seed 0, the record from `--seed`, temperature
1: `chip_smoke.replay_operands`), runs the float32 K5b on it (the step-grid
one where the config needs it) and the plain version on the same operands
(dlp a ramp, as `chip_smoke.check_replay`), and prints each gradient's
error scaled by the plain result's max magnitude. For every row j of the
W1 gradient whose scaled error passes `chip_smoke.GRAD_TOL` it finds the
acting (step, container, instance) whose feats that row's difference is
parallel to (`nearest_gate`) and prints its first-layer pre-activation
W1[j] . feats + b1[j] in float64 on the float32 operands, the plain
version's float32 value of it, the float32 rounding bound of the sum
(gamma_{K+1} times the sum of the terms' magnitudes, K = W*D + 2) and the
cosine: -1 or +1 where one ReLU gate opened in one result and stayed shut
in the other. A pre-activation below its rounding bound has no sign that
float32 arithmetic decides: two summation orders may gate it
differently.

Run from the repository root (it imports `chip_smoke`); on a CUDA device
by default, `--device cpu` runs the plain version on both sides.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

U32 = 2.0 ** -24  # float32 unit roundoff


def gamma(n: int) -> float:
    """The bound n u / (1 - n u) on a float32 sum of n terms' relative
    error (u the unit roundoff)."""
    return n * U32 / (1.0 - n * U32)


def pre_activations(ops, cfg):
    """Per step k and container c: (feats f32 [W*D+2, B] as the plain
    version computes them, the plain version's float32 pre-activations
    W1 feats + b1 [h, B], their float64 values on the same float32
    operands, the float32 rounding bound of each [h, B])."""
    from tapnet_torch.ops import replay as RP

    flags, hms, _, acts, _, ctx, _, statm, params = ops
    w1t, b1 = params[3].float(), params[4].float().reshape(-1, 1)
    k_terms = w1t.shape[1] + 1
    prev = RP._prev_rows(acts)
    out = []
    for k in range(cfg.num_blocks):
        _, _, _, sv = RP._head_queries(cfg, k, flags[k], hms[k], prev[k],
                                       ctx, statm, params)
        for c, (feats, _) in enumerate(sv["hm"]):
            pre32 = w1t @ feats + b1
            pre64 = w1t.double() @ feats.double() + b1.double()
            bound = gamma(k_terms) * (w1t.double().abs()
                                      @ feats.double().abs()
                                      + b1.double().abs())
            out.append((k, c, feats, pre32, pre64, bound))
    return out


def nearest_gate(row_diff, j, acts, pres):
    """The acting (step, container, instance) that row j of the W1
    gradients' difference points at: a gate that opened in one result
    and stayed shut in the other adds plus or minus that pair's feats to
    the row, so the pair's feats are the most nearly parallel to
    `row_diff`; among pairs as parallel (equal feats), the one whose
    float64 pre-activation lies nearest 0. Returns the pair, that value,
    the plain version's float32 value, its rounding bound and the
    cosine."""
    d = row_diff.double()
    cands = []
    for k, c, feats, pre32, pre64, bound in pres:
        f = feats.double()
        norm = f.norm(dim=0) * d.norm()
        ok = (acts[k] >= 0) & (norm > 0)
        cos = torch.where(ok, (d @ f) / norm.clamp_min(1e-300),
                          torch.zeros_like(norm))
        cands.append((k, c, cos, pre32, pre64, bound))
    top = max(float(cos.abs().max()) for _, _, cos, *_ in cands)
    best = None
    for k, c, cos, pre32, pre64, bound in cands:
        mag = pre64[j].abs().masked_fill(cos.abs() < top - 1e-9,
                                         float("inf"))
        b = int(mag.argmin())
        if best is None or mag[b] < best[0]:
            best = (float(mag[b]), k, c, b, float(cos[b]),
                    float(pre64[j, b]), float(pre32[j, b]),
                    float(bound[j, b]))
    _, k, c, b, cos, p64, p32, bd = best
    return {"step": k, "container": c, "instance": b, "pre_f64": p64,
            "pre_f32_plain": p32, "rounding_bound": bd, "cosine": cos}


def witness(cfg, hidden, batch, seed, dev):
    """The scaled error of each gradient and, for each W1 row past
    GRAD_TOL, `nearest_gate`'s record."""
    import chip_smoke as CS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    actor = init_params(CS.SEED, cfg, hidden, dev)
    ops, _ = CS.replay_operands(actor, cfg, batch, dev, seed, 1.0)
    steps = RP._steps_grid(cfg)
    _, _, bwd, bwd_ref = CS.replay_fns(ops, cfg, 1.0, steps)
    dlp = torch.linspace(-1.0, 1.0, batch, device=dev)
    with torch.no_grad():
        got = CS._flat_grads(bwd(dlp))
        want = CS._flat_grads(bwd_ref(dlp))
        errs = {n: float((a - w).abs().max() / (w.abs().max() + 1e-12))
                for n, a, w in zip(CS.GRAD_NAMES, got, want)}
        gw1, ww1 = got[2 + 3], want[2 + 3]  # d_params[3]: W1
        diff = gw1 - ww1
        rows = (diff.abs().amax(1) > CS.GRAD_TOL * ww1.abs().max())
        gates = []
        if bool(rows.any()):
            pres = pre_activations(ops, cfg)
            for j in torch.nonzero(rows).flatten().tolist():
                gates.append({"row": j, **nearest_gate(diff[j], j, ops[3],
                                                        pres)})
    return {"hidden": hidden, "batch": batch, "seed": seed,
            "schedule": "steps" if steps else "monolithic",
            "scaled_errors": errs, "gates": gates}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="2d-rolling")
    ap.add_argument("--hidden", type=int, default=160)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("grad_witness: no CUDA device", file=sys.stderr)
        return 2
    from tapnet_torch import CONFIGS

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"config": args.config, **witness(
        CONFIGS[args.config], args.hidden, args.batch, args.seed, dev)}
    if dev.type == "cuda":
        res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
