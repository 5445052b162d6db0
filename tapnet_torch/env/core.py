"""Batched TAP environment core (SPEC.md §3-§9), the port of
`tapnet_tpu/env/core.py`.

Every function takes a leading batch axis (the batch dimension written out
in place of `vmap`): Instance / EnvState fields are [B, ...] tensors, the
integer env math is the same, and `step` is bit-equal to the JAX env for
both placement rules: `lb` (lowest key) and `mcs` (the candidate with the
highest exact score fraction). `select_action` / `rollout_batch` are the
fixed heuristic policies (first-fit, uniform random) over N steps;
`rollout` rolls one instance (a batch of one).
"""

from __future__ import annotations

import torch

from tapnet_torch import random as R
from tapnet_torch.config import TAPConfig
from tapnet_torch.types import EnvState, Instance

BIG = 2**30


def _ar(n, dev):
    return torch.arange(n, dtype=torch.int32, device=dev)


def reset(instances: Instance, cfg: TAPConfig) -> EnvState:
    B, N = instances.dims.shape[:2]
    dev = instances.dims.device
    packed = _ar(N, dev)[None] >= instances.n_total[:, None]
    return EnvState(
        heightmap=torch.zeros((B, cfg.num_containers, cfg.target_width,
                               cfg.target_depth), dtype=torch.int32,
                              device=dev),
        packed=packed,
        placements=torch.full((B, N, 6), -1, dtype=torch.int32, device=dev),
        t=torch.zeros(B, dtype=torch.int32, device=dev))


def _accessibility(instances: Instance, packed: torch.Tensor):
    """acc0[b, i]: removable straight-up; accr: removable with rotation."""
    unpacked = ~packed
    blocked0 = (instances.up & unpacked[:, :, None]).any(dim=1)
    acc0 = unpacked & ~blocked0
    blockedr = (instances.rot & unpacked[:, :, None]).any(dim=1)
    return acc0, acc0 & ~blockedr


def rotated_dims_all(dims: torch.Tensor, r: int, cfg: TAPConfig):
    """dims [..., 3] of every block under the static rotation state r."""
    if r == 0:
        return dims
    ax0, ax1 = cfg.rot_axes
    perm = [ax1 if k == ax0 else ax0 if k == ax1 else k for k in range(3)]
    # a column stack, not dims[..., perm]: a list index is copied to the
    # device from the host, which a CUDA graph capture refuses
    return torch.stack([dims[..., k] for k in perm], -1)


def rotated_dims(instances: Instance, b: torch.Tensor, r: torch.Tensor,
                 cfg: TAPConfig):
    """(w, d, h) [B] of block b [B] under rotation state r [B]."""
    bi = torch.arange(b.shape[0], device=b.device)
    dims = instances.dims[bi, b.long()]                       # [B, 3]
    dims = torch.where((r == 1)[:, None], rotated_dims_all(dims, 1, cfg),
                       dims)
    return dims[:, 0], dims[:, 1], dims[:, 2]


def action_mask(state: EnvState, instances: Instance,
                cfg: TAPConfig) -> torch.Tensor:
    """Feasibility over the flat (block, rot, container) action space [B, A]."""
    B, N = instances.dims.shape[:2]
    acc0, accr = _accessibility(instances, state.packed)
    if cfg.window > 0:
        a0 = acc0.int()
        observable = acc0 & ((a0.cumsum(1) - a0) < cfg.window)
    else:
        observable = acc0
    masks_br = []
    for r in range(cfg.num_rot):
        ok = observable if r == 0 else (observable & accr)
        dims = rotated_dims_all(instances.dims, r, cfg)
        fits = ((dims[..., 0] <= cfg.target_width)
                & (dims[..., 1] <= cfg.target_depth))
        masks_br.append(ok & fits)
    mask_br = torch.stack(masks_br, dim=2)                    # [B, N, R]

    R_, C = cfg.num_rot, cfg.num_containers
    if cfg.target_height > 0:
        # finite cap: require >= 1 candidate with l + h <= cap (SPEC.md §5)
        place_ok = torch.empty((B, N, R_, C), dtype=torch.bool,
                               device=mask_br.device)
        for r in range(R_):
            dims = rotated_dims_all(instances.dims, r, cfg).reshape(B * N, 3)
            for c in range(C):
                hm = state.heightmap[:, c].repeat_interleave(N, dim=0)
                _, _, valid = candidate_scan(hm, dims[:, 0], dims[:, 1],
                                             dims[:, 2], cfg)
                place_ok[:, :, r, c] = valid.flatten(1).any(1).reshape(B, N)
        mask = mask_br[..., None] & place_ok
    else:
        mask = mask_br[..., None].expand(B, N, R_, C)
    return mask.reshape(B, cfg.num_actions)


def _window(a, n, W, fill, axis, op):
    """out[.., x, ..] = op over o < n[b] of a[.., x + o, ..] along `axis`
    (1 = x, 2 = y of a [B, W, D]), `fill` beyond the edge."""
    pad_shape = list(a.shape)
    pad_shape[axis] = W
    pad = torch.cat([a, torch.full(pad_shape, fill, dtype=a.dtype,
                                   device=a.device)], dim=axis)
    out = None
    for o in range(W):
        s = pad.narrow(axis, o, a.shape[axis])
        s = torch.where((o < n)[:, None, None], s, torch.zeros_like(s))
        out = s if out is None else op(out, s)
    return out


def candidate_scan(hm: torch.Tensor, w, d, h, cfg: TAPConfig):
    """Landing height, stability, validity of every offset of a (w, d, h)
    block: hm int32[B, Wt, Dt], w/d/h [B] -> three [B, Wt, Dt] tensors."""
    Wt, Dt = cfg.target_width, cfg.target_depth
    dev = hm.device
    mx = torch.maximum
    rowmax = hm if Dt == 1 else _window(hm, d, Dt, 0, 2, mx)
    colmax = _window(hm, w, Wt, 0, 1, mx)
    landing = _window(rowmax, w, Wt, 0, 1, mx)
    xs = _ar(Wt, dev)[None, :, None]
    ys = _ar(Dt, dev)[None, None, :]

    def extent(src, n, size, axis, idx):
        # min/max doubled coordinate of rows/cols equal to landing in the
        # footprint (fill -1 beyond the edge never matches)
        pad_shape = list(src.shape)
        pad_shape[axis] = size
        pad = torch.cat([src, torch.full(pad_shape, -1, dtype=src.dtype,
                                         device=dev)], dim=axis)
        lo = torch.full_like(src, BIG)
        hi = torch.full_like(src, -BIG)
        for o in range(size):
            s = pad.narrow(axis, o, src.shape[axis])
            sup = (o < n)[:, None, None] & (s == landing)
            i2 = 2 * (idx + o)
            lo = torch.where(sup, torch.minimum(lo, i2), lo)
            hi = torch.where(sup, torch.maximum(hi, i2), hi)
        return lo, hi

    minx, maxx = extent(rowmax, w, Wt, 1, xs)
    cx2 = 2 * xs + w[:, None, None] - 1
    sup_ok = (minx <= cx2) & (cx2 <= maxx)
    if Dt > 1:
        miny, maxy = extent(colmax, d, Dt, 2, ys)
        cy2 = 2 * ys + d[:, None, None] - 1
        sup_ok = sup_ok & (miny <= cy2) & (cy2 <= maxy)
    stable = (landing == 0) | sup_ok
    valid = ((xs <= Wt - w[:, None, None]) & (ys <= Dt - d[:, None, None])
             & (landing + h[:, None, None] <= cfg.height_cap))
    return landing, stable, valid


# ------------------------------------------------------------------ #
# exact comparison of score fractions (SPEC.md §6.4 `mcs`)
#
# `mcs` compares fractions n/d with n, d < 2^63 (the TAPConfig guard) by
# cross-multiplication. The 126-bit products do not fit torch's widest
# integer (signed 64 bits), so each value is cut into three 21-bit limbs:
# a limb product is below 2^42 and a column of three of them below 2^44,
# far inside int64.

_LIMB = 21
_LMASK = (1 << _LIMB) - 1


def _mul_u63(a: torch.Tensor, b: torch.Tensor):
    """a * b of int64 tensors in [0, 2^63) as six 21-bit limbs, most
    significant first (the top limb holds whatever is left)."""
    al = (a & _LMASK, (a >> _LIMB) & _LMASK, a >> (2 * _LIMB))
    bl = (b & _LMASK, (b >> _LIMB) & _LMASK, b >> (2 * _LIMB))
    cols = (al[0] * bl[0], al[0] * bl[1] + al[1] * bl[0],
            al[0] * bl[2] + al[1] * bl[1] + al[2] * bl[0],
            al[1] * bl[2] + al[2] * bl[1], al[2] * bl[2])
    out, carry = [], 0
    for col in cols:
        col = col + carry
        out.append(col & _LMASK)
        carry = col >> _LIMB
    out.append(carry)
    return out[::-1]


def _limbs_gt_eq(a, b):
    """Lexicographic (a > b, a == b) over equal-length limb lists."""
    gt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for ai, bi in zip(a, b):
        gt = gt | (eq & (ai > bi))
        eq = eq & (ai == bi)
    return gt, eq


def _mcs_score_fraction(cfg: TAPConfig, vol_p, dc_p, dp_p, sn_p, sd_p):
    """The configured reward terms (C = vol'/dc', P = vol'/dp', S = sn'/sd')
    summed into one exact fraction (n, d) of int64 tensors."""
    pairs = {"C": (vol_p, dc_p), "P": (vol_p, dp_p), "S": (sn_p, sd_p)}
    n = d = None
    for term in cfg.reward_terms:
        tn, td = (v.long() for v in pairs[term])
        n, d = (tn, td) if n is None else (n * td + tn * d, d * td)
    return n, d


def _mcs_choose(cfg: TAPConfig, stable, valid, key, n, d):
    """The winner's lb key [B] by (class, exact score, lowest lb key), where
    class = valid (+1 if also stable under `hard`: prefer stable, else fall
    back). The order is total (exact rationals, ties to the lowest key,
    padding keyed BIG), so any reduction order gives the JAX tournament's
    winner; this one halves a power-of-two padding, log2 rounds."""
    cls = valid.long()
    if cfg.placement_variant == "hard":
        cls = cls + (valid & stable).long()
    # fractions of invalid candidates compare equal (0/0 against anything)
    zero = torch.zeros_like(n)
    fields = [cls, key.long(), torch.where(valid, n, zero),
              torch.where(valid, d, zero)]
    fields = [f.flatten(1) for f in fields]
    m = fields[0].shape[1]
    p2 = 1 << (m - 1).bit_length()
    if p2 > m:
        pad = fields[0].new_zeros((fields[0].shape[0], p2 - m))
        fields = [torch.cat([f, pad + (BIG if i == 1 else 0)], 1)
                  for i, f in enumerate(fields)]
    while p2 > 1:
        p2 //= 2
        a = [f[:, :p2] for f in fields]
        b = [f[:, p2:] for f in fields]
        gt, eq = _limbs_gt_eq(_mul_u63(a[2], b[3]), _mul_u63(b[2], a[3]))
        take_a = (a[0] > b[0]) | ((a[0] == b[0])
                                  & (gt | (eq & (a[1] <= b[1]))))
        fields = [torch.where(take_a, fa, fb) for fa, fb in zip(a, b)]
    return fields[1][:, 0]


def choose_placement(hm: torch.Tensor, w, d, h, cfg: TAPConfig,
                     score_ctx=None):
    """Placement per SPEC.md §6.4. `lb`: the lowest/leftmost/frontmost valid
    offset by the injective key (l*Wt + x)*Dt + y; `mcs`: the valid offset
    whose placement gives the highest exact score, `score_ctx` = (vol,
    denom_c, denom_p, s_num, s_den) [B] each, the `reward_terms` of the
    pre-step state. The hard variant prefers stable offsets and falls back
    to soft. Returns (x, y, l, stable, any_valid), each [B]."""
    Wt, Dt = cfg.target_width, cfg.target_depth
    landing, stable, valid = candidate_scan(hm, w, d, h, cfg)
    xs = _ar(Wt, hm.device)[None, :, None]
    ys = _ar(Dt, hm.device)[None, None, :]
    key = (landing * Wt + xs) * Dt + ys
    bi = torch.arange(hm.shape[0], device=hm.device)
    if cfg.placement_rule == "mcs":
        if score_ctx is None:
            raise ValueError("mcs placement needs score_ctx")
        vol, denom_c, denom_p, s_num, s_den = (
            v[:, None, None] for v in score_ctx)
        w3, d3, h3 = (v[:, None, None] for v in (w, d, h))
        top = landing + h3
        cur_maxh = hm.amax(dim=(1, 2))[:, None, None]
        rowsum = hm if Dt == 1 else _window(hm, d, Dt, 0, 2, torch.add)
        fpsum = _window(rowsum, w, Wt, 0, 1, torch.add)
        dc_p = denom_c + Wt * Dt * (torch.maximum(cur_maxh, top) - cur_maxh)
        dp_p = denom_p + w3 * d3 * top - fpsum
        n, dn = _mcs_score_fraction(
            cfg, (vol + w3 * d3 * h3).expand_as(key), dc_p, dp_p,
            s_num + stable.int(), (s_den + 1).expand_as(key))
        win = _mcs_choose(cfg, stable, valid, key, n, dn)
        x, y = (win // Dt) % Wt, win % Dt
        return (x.int(), y.int(), landing[bi, x, y], stable[bi, x, y],
                valid.flatten(1).any(1))
    key_soft = torch.where(valid, key, BIG)
    key_used = key_soft
    if cfg.placement_variant == "hard":
        key_hard = torch.where(valid & stable, key, BIG)
        use_hard = (key_hard < BIG).flatten(1).any(1)
        key_used = torch.where(use_hard[:, None, None], key_hard, key_soft)
    flat = torch.argmin(key_used.flatten(1), dim=1)
    x, y = flat // Dt, flat % Dt
    return (x.int(), y.int(), landing[bi, x, y], stable[bi, x, y],
            (key_soft < BIG).flatten(1).any(1))


def step(state: EnvState, action: torch.Tensor, instances: Instance,
         cfg: TAPConfig) -> EnvState:
    """Place the block selected by `action` [B] (negative => no-op)."""
    B = action.shape[0]
    dev = action.device
    bi = torch.arange(B, device=dev)
    do = action >= 0
    b, r, c = cfg.decompose_action(action.clamp(min=0))
    w, d, h = rotated_dims(instances, b, r, cfg)
    hm = state.heightmap[bi, c.long()]
    ctx = (reward_terms(state, instances, cfg)
           if cfg.placement_rule == "mcs" else None)
    x, y, l, stable, any_valid = choose_placement(hm, w, d, h, cfg, ctx)
    do = do & any_valid

    xs = _ar(cfg.target_width, dev)[None, :, None]
    ys = _ar(cfg.target_depth, dev)[None, None, :]
    fp = ((xs >= x[:, None, None]) & (xs < (x + w)[:, None, None])
          & (ys >= y[:, None, None]) & (ys < (y + d)[:, None, None]))
    hm_new = torch.where(fp, (l + h)[:, None, None], hm)
    sel_c = _ar(cfg.num_containers, dev)[None] == c[:, None]   # [B, C]
    heightmap = torch.where((sel_c & do[:, None])[:, :, None, None],
                            hm_new[:, None], state.heightmap)
    sel_b = _ar(state.packed.shape[1], dev)[None] == b[:, None]
    packed = state.packed | (sel_b & do[:, None])
    row = torch.stack([c, r, x, y, l, stable.int()], dim=1).int()
    placements = torch.where((sel_b & do[:, None])[:, :, None],
                             row[:, None, :], state.placements)
    return EnvState(heightmap=heightmap, packed=packed,
                    placements=placements, t=state.t + do.int())


def reward_terms(state: EnvState, instances: Instance, cfg: TAPConfig):
    """Integer reward numerators/denominators [B] each (SPEC.md §7)."""
    return terms_of(state.heightmap, state.placements, instances.dims)


def terms_of(heightmap, placements, dims):
    """(vol, denom_c, denom_p, s_num, s_den) int32[B] from heightmaps
    [B, C, W, D], placements [B, N, 6] and dims [B, N, 3]."""
    placed = placements[..., 0] >= 0
    vol = torch.where(placed, dims.prod(-1), 0).sum(1)
    maxh = heightmap.amax(dim=(2, 3))                          # [B, C]
    under = heightmap.sum(dim=(2, 3))
    used = maxh > 0
    area = heightmap.shape[2] * heightmap.shape[3]
    denom_c = torch.where(used, area * maxh, 0).sum(1)
    denom_p = torch.where(used, under, 0).sum(1)
    s_num = torch.where(placed, placements[..., 5], 0).sum(1)
    s_den = placed.int().sum(1)
    return tuple(v.int() for v in (vol, denom_c, denom_p, s_num, s_den))


def reward(state: EnvState, instances: Instance,
           cfg: TAPConfig) -> torch.Tensor:
    """float32 reward [B] = sum of the configured C/P/S terms."""
    return reward_from_terms(reward_terms(state, instances, cfg),
                             cfg.reward_terms)


def reward_from_terms(terms, reward_terms_cfg) -> torch.Tensor:
    """float32 [B] = the sum of the configured C/P/S fractions of the
    integer terms (vol, denom_c, denom_p, s_num, s_den)."""
    vol, denom_c, denom_p, s_num, s_den = terms

    def f(n, d):
        q = n.float() / d.clamp(min=1).float()
        return torch.where(d > 0, q, torch.zeros_like(q))

    vals = {"C": f(vol, denom_c), "P": f(vol, denom_p), "S": f(s_num, s_den)}
    out = None
    for t in reward_terms_cfg:
        out = vals[t] if out is None else out + vals[t]
    return out


# ------------------------------------------------------------------ #
# fixed-policy rollouts (the heuristic baselines)

POLICIES = ("first", "random")


def policy_bits(keys: torch.Tensor, cfg: TAPConfig, policy: str):
    """The policy's draws, int64[B, N] in [0, 2^32): bits(fold_in(keys[b],
    t)) for `random`, zeros for `first` (which takes the lowest feasible
    action: rank 0). Computed once per rollout, so the general path and the
    fused kernel consume the same numbers."""
    if policy not in POLICIES:
        raise ValueError(policy)
    B, N = keys.shape[0], cfg.num_blocks
    if policy == "first":
        return torch.zeros((B, N), dtype=torch.int64, device=keys.device)
    ts = torch.arange(N, device=keys.device)
    return R.bits(R.fold_in(keys[:, None, :], ts[None, :]))


def select_action(mask: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """The (bits_t % count)-th feasible action of each row of mask [B, A] in
    flat (block, rot, container) order; -1 where the mask is empty."""
    m = mask.int()
    n = m.sum(1)
    k = bits_t % n.clamp(min=1)
    rank = m.cumsum(1) - 1
    a = torch.argmax((mask & (rank == k[:, None])).int(), dim=1)
    return torch.where(n > 0, a, -1).int()


def rollout_bits(instances: Instance, rbits: torch.Tensor, cfg: TAPConfig):
    """N steps of action_mask -> select_action -> step on the draws rbits
    [B, N]. Returns (final EnvState, actions int32[B, N])."""
    state = reset(instances, cfg)
    actions = []
    for t in range(cfg.num_blocks):
        a = select_action(action_mask(state, instances, cfg), rbits[:, t])
        state = step(state, a, instances, cfg)
        actions.append(a)
    return state, torch.stack(actions, 1)


def rollout_batch(instances: Instance, keys: torch.Tensor, cfg: TAPConfig,
                  policy: str = "first"):
    """Roll a batch to termination with a fixed policy (a batched loop over
    the steps, where the JAX package vmaps a per-instance `rollout`).
    Returns (final EnvState, actions int32[B, N], rewards float32[B])."""
    state, actions = rollout_bits(instances,
                                  policy_bits(keys, cfg, policy), cfg)
    return state, actions, reward(state, instances, cfg)


def rollout(instance: Instance, key: torch.Tensor, cfg: TAPConfig,
            policy: str = "first"):
    """Roll one instance to termination with a fixed policy, the JAX
    package's `rollout`: `instance` holds one instance (fields without the
    batch axis), `key` its key [2]. It is `rollout_batch` on a batch of
    one, squeezed, so its draws are `bits(fold_in(key, t))` as in JAX and
    an empty mask records -1. Returns (final EnvState, actions int32[N],
    reward float32 []) on the device of the inputs."""
    state, actions, rewards = rollout_batch(
        Instance(*(x[None] for x in instance)), key[None], cfg, policy)
    return EnvState(*(x[0] for x in state)), actions[0], rewards[0]
