"""The float32 replay backward against its plain version on one record, with
the float64 value of each encoder pre-activation that a disagreement
points at.

    python -m tapnet_torch.grad_witness [--config 2d-rolling] [--hidden 160]
        [--batch 256] [--seed 10] [--temperature 1.0] [--out FILE]

It records a sampled rollout of `--batch` instances of `--config` at hidden
width `--hidden` (weights from seed 0, the record from `--seed` at
`--temperature`: `chip_smoke.replay_operands`), runs the float32 K5b on
it (the step-grid one where the config needs it) and the plain version
on the same operands (dlp a ramp, as `chip_smoke.check_replay`), and
prints each gradient's error scaled by the plain result's max magnitude.
For every row j of the
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

It also counts every such pair of the record (`near_zero_gates`, from the
plain backward's own pre-activations): each ReLU gate whose value can
matter (W1's of an acting instance, W8's of a live column) and whose
float64 pre-activation lies within the float32 rounding bound of its sum
(every kernel sums W1 feats and W8 x in float32 FMAs), and prints each
gradient's scaled error again with the rows that such a gate feeds (W1
and b1 rows j, W8 and b8 rows m) left out.

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


def sum_bound(w, x, b):
    """(w x + b in float64 on the float32 operands, the float32 rounding
    bound of that sum: gamma of its K + 1 terms times the sum of their
    magnitudes) for w [rows, K], x [K, cols], b [rows, 1]."""
    w, x, b = w.double(), x.double(), b.double().reshape(-1, 1)
    return (w @ x + b,
            gamma(w.shape[1] + 1) * (w.abs() @ x.abs() + b.abs()))


def near_zero_gates(pres, ops, cfg):
    """From the plain backward's ReLU pre-activations and their inputs
    (`replay_logp_bwd_ref(..., pre=True)`), the gates whose sign rounding
    may decide: W1's pairs (step, container, row j, acting instance) and
    W8's (step, row m, live column) whose float64 pre-activation lies
    strictly within its float32 rounding bound (`sum_bound`; an exact 0 of
    exact zero terms is 0 in every order). Only these gates can matter: a
    pair whose instance does not act, or a masked column, adds exact zeros
    through either gate. Returns (the number of such pairs, {"W1": rows
    j, "W8": rows m})."""
    T, C = cfg.num_blocks * cfg.num_rot, cfg.num_containers
    masks, acts, params = ops[2], ops[3], ops[8]
    w8t, b8, w1t, b1 = params[0], params[1], params[3], params[4]
    n = 0
    rows1 = torch.zeros(w1t.shape[0], dtype=torch.bool, device=w1t.device)
    rows8 = torch.zeros(w8t.shape[0], dtype=torch.bool, device=w8t.device)
    for p in pres:
        acting = acts[p["k"]] >= 0                             # [B]
        for f in p["feats"]:
            pre, bound = sum_bound(w1t, f, b1)
            near = (pre.abs() < bound) & acting[None]
            n += int(near.sum())
            rows1 |= near.any(1)
        pre, bound = sum_bound(w8t, p["x"].reshape(8, -1), b8)  # [32, T B]
        live = ((masks[p["k"]].reshape(T, C, -1) == 1).any(1)
                & acting[None]).reshape(-1)                    # [T B]
        near = (pre.abs() < bound) & live[None]
        n += int(near.sum())
        rows8 |= near.any(1)
    return n, {"W1": torch.nonzero(rows1).flatten().tolist(),
               "W8": torch.nonzero(rows8).flatten().tolist()}


def errors_without(got, want, rows):
    """Each gradient's error scaled by the plain result's max magnitude, as
    the full comparison takes it, over every element but the rows that
    `rows` names (`near_zero_gates`): W8 and b8 rows m, W1 and b1 rows
    j."""
    import chip_smoke as CS

    drop = {2 + 0: rows["W8"], 2 + 1: rows["W8"], 2 + 3: rows["W1"],
            2 + 4: rows["W1"]}
    errs = {}
    for i, (name, a, w) in enumerate(zip(CS.GRAD_NAMES, got, want)):
        d = (a - w).abs()
        if drop.get(i):
            d = d.clone()
            d[drop[i]] = 0.0
        errs[name] = float(d.max() / (w.abs().max() + 1e-12))
    return errs


def pre_activations(ops, cfg):
    """Per step k and container c: (feats f32 [W*D+2, B] as the plain
    version computes them, the plain version's float32 pre-activations
    W1 feats + b1 [h, B], their float64 values on the same float32
    operands, the float32 rounding bound of each [h, B])."""
    from tapnet_torch.ops import replay as RP

    flags, hms, _, acts, _, ctx, _, statm, params = ops
    w1t, b1 = params[3].float(), params[4].float().reshape(-1, 1)
    prev = RP._prev_rows(acts)
    out = []
    for k in range(cfg.num_blocks):
        _, _, _, sv = RP._head_queries(cfg, k, flags[k], hms[k], prev[k],
                                       ctx, statm, params)
        for c, (feats, _) in enumerate(sv["hm"]):
            pre64, bound = sum_bound(w1t, feats, b1)
            out.append((k, c, feats, w1t @ feats + b1, pre64, bound))
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


def witness(cfg, hidden, batch, seed, dev, temperature=1.0):
    """The scaled error of each gradient and, for each W1 row past
    GRAD_TOL, `nearest_gate`'s record; the number of gates that rounding
    may decide (`near_zero_gates`) with the rows they feed, and every
    scaled error again with those rows left out (`errors_without`)."""
    import chip_smoke as CS
    from tapnet_torch.models.tapnet import init_params
    from tapnet_torch.ops import replay as RP

    actor = init_params(CS.SEED, cfg, hidden, dev)
    ops, _ = CS.replay_operands(actor, cfg, batch, dev, seed, temperature)
    steps = RP._steps_grid(cfg)
    _, _, bwd, _ = CS.replay_fns(ops, cfg, temperature, steps)
    dlp = torch.linspace(-1.0, 1.0, batch, device=dev)
    ref = RP.replay_logp_bwd_steps_ref if steps else RP.replay_logp_bwd_ref
    so = (ops[:4] + (RP._prev_rows(ops[3]),) + ops[4:]) if steps else ops
    with torch.no_grad():
        got = CS._flat_grads(bwd(dlp))
        *plain, pres = ref(dlp, *so, cfg, temperature, pre=True)
        want = CS._flat_grads(plain)
        errs = {n: float((a - w).abs().max() / (w.abs().max() + 1e-12))
                for n, a, w in zip(CS.GRAD_NAMES, got, want)}
        n_near, near_rows = near_zero_gates(pres, ops, cfg)
        errs_without = errors_without(got, want, near_rows)
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
            "temperature": temperature,
            "schedule": "steps" if steps else "monolithic",
            "scaled_errors": errs, "gates": gates,
            "near_zero_pairs": n_near, "near_zero_rows": near_rows,
            "scaled_errors_without_them": errs_without}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="2d-rolling")
    ap.add_argument("--hidden", type=int, default=160)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--temperature", type=float, default=1.0)
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
        CONFIGS[args.config], args.hidden, args.batch, args.seed, dev,
        args.temperature)}
    if dev.type == "cuda":
        res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
