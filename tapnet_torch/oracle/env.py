"""Oracle packing environment: naive per-instance numpy implementation,
the port's copy of `tapnet_tpu/oracle/env.py` (with the port's config and
types; the port imports nothing of the JAX package).

Implements SPEC.md §3-§9 exactly: candidate scan over all (x, y) offsets,
left-bottom greedy scoring with soft/hard stability variants, heightmap
update, precedence mask maintenance, rolling window, multi-container, and the
C/P/S terminal reward. This mirrors the reference's `pack.py` environment
mechanics (SURVEY.md §2.1 / §3.4, unverified names) and is the bit-exactness
parity target for `tapnet_torch/env/`.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from tapnet_torch.config import TAPConfig
from tapnet_torch.types import (
    EnvState,
    Instance,
    PLACE_CONTAINER,
    PLACE_ROT,
    PLACE_STABLE,
    PLACE_X,
    PLACE_Y,
    PLACE_Z,
)


class OracleEnv:
    """One TAP instance stepped with Python loops (the executable spec)."""

    def __init__(self, instance: Instance, cfg: TAPConfig):
        self.cfg = cfg
        self.inst = instance
        self.reset()

    # ------------------------------------------------------------------ #

    def reset(self) -> EnvState:
        cfg = self.cfg
        N = cfg.num_blocks
        packed = np.arange(N) >= int(self.inst.n_total)  # padding pre-packed
        self.state = EnvState(
            heightmap=np.zeros(
                (cfg.num_containers, cfg.target_width, cfg.target_depth),
                dtype=np.int32,
            ),
            packed=packed,
            placements=np.full((N, 6), -1, dtype=np.int32),
            t=np.int32(0),
        )
        return self.state

    # ------------------------------------------------------------------ #

    def rotated_dims(self, b: int, r: int) -> Tuple[int, int, int]:
        w, d, h = (int(v) for v in self.inst.dims[b])
        if r == 1:
            ax0, ax1 = self.cfg.rot_axes
            v = [w, d, h]
            v[ax0], v[ax1] = v[ax1], v[ax0]
            w, d, h = v
        return w, d, h

    def accessible(self, b: int, r: int) -> bool:
        """SPEC.md §3: accessibility under the chosen rotation state."""
        unpacked = ~self.state.packed
        if np.any(self.inst.up[:, b] & unpacked):
            return False
        if r == 1 and np.any(self.inst.rot[:, b] & unpacked):
            return False
        return True

    def in_window(self, b: int) -> bool:
        """SPEC.md §8: window = first K accessible unpacked blocks by index."""
        K = self.cfg.window
        if K <= 0:
            return True
        frontier_before = sum(
            1 for a in range(b)
            if not self.state.packed[a] and self.accessible(a, 0)
        )
        return frontier_before < K

    def action_mask(self) -> np.ndarray:
        cfg = self.cfg
        mask = np.zeros(cfg.num_actions, dtype=bool)
        for a in range(cfg.num_actions):
            b, r, c = cfg.decompose_action(a)
            if b >= int(self.inst.n_total) or self.state.packed[b]:
                continue
            if not self.in_window(b) or not self.accessible(b, r):
                continue
            w, d, h = self.rotated_dims(b, r)
            if w > cfg.target_width or d > cfg.target_depth:
                continue
            if self._best_candidate(c, w, d, h) is None:
                continue
            mask[a] = True
        return mask

    # ------------------------------------------------------------------ #

    def _scan(self, container: int, w: int, d: int, h: int):
        """Candidate scan (SPEC.md §6): landing + stability per offset."""
        cfg = self.cfg
        hm = self.state.heightmap[container]
        Wt, Dt = cfg.target_width, cfg.target_depth
        out = []  # (x, y, landing, stable)
        for x in range(Wt - w + 1):
            for y in range(Dt - d + 1):
                window = hm[x:x + w, y:y + d]
                l = int(window.max())
                if l == 0:
                    stable = True
                else:
                    si, sj = np.nonzero(window == l)
                    cx2, cy2 = 2 * x + w - 1, 2 * y + d - 1
                    stable = (
                        2 * (x + int(si.min())) <= cx2 <= 2 * (x + int(si.max()))
                        and 2 * (y + int(sj.min())) <= cy2 <= 2 * (y + int(sj.max()))
                    )
                if l + h <= cfg.height_cap:
                    out.append((x, y, l, stable))
        return out

    def _cand_score(self, container: int, cand, w: int, d: int, h: int
                    ) -> Fraction:
        """SPEC.md §6.4 `mcs`: exact rational reward (§7, configured terms)
        of the hypothetical state after placing the block at `cand`."""
        cfg = self.cfg
        x, y, l, stable = cand
        hm = self.state.heightmap.copy()
        hm[container, x:x + w, y:y + d] = l + h
        placed = self.state.placements[:, PLACE_CONTAINER] >= 0
        vol = int(sum(int(np.prod(self.inst.dims[b].astype(np.int64)))
                      for b in np.nonzero(placed)[0])) + w * d * h
        area = cfg.target_width * cfg.target_depth
        denom_c = denom_p = 0
        for c in range(cfg.num_containers):
            mh = int(hm[c].max())
            if mh > 0:
                denom_c += area * mh
                denom_p += int(hm[c].sum())
        s_num = int(self.state.placements[placed, PLACE_STABLE].sum()) + int(stable)
        s_den = int(placed.sum()) + 1
        terms = {"C": Fraction(vol, denom_c), "P": Fraction(vol, denom_p),
                 "S": Fraction(s_num, s_den)}
        return sum((terms[t] for t in cfg.reward_terms), Fraction(0))

    def _best_candidate(self, container: int, w: int, d: int, h: int
                        ) -> Optional[Tuple[int, int, int, bool]]:
        """Placement rule (`lb` greedy / `mcs` scored) with soft/hard variant
        (SPEC.md §6.4)."""
        cfg = self.cfg
        cands = self._scan(container, w, d, h)
        if not cands:
            return None

        def key(c):
            x, y, l, _ = c
            return (l * cfg.target_width + x) * cfg.target_depth + y

        if cfg.placement_rule == "mcs":
            def pick(pool):
                # max score, ties broken by the minimal lb key
                return max(pool, key=lambda c: (
                    self._cand_score(container, c, w, d, h), -key(c)))
        else:
            def pick(pool):
                return min(pool, key=key)

        if cfg.placement_variant == "hard":
            stable_cands = [c for c in cands if c[3]]
            if stable_cands:
                return pick(stable_cands)
        return pick(cands)

    # ------------------------------------------------------------------ #

    def step(self, action: int) -> EnvState:
        """Place the selected block. Caller must supply a feasible action
        (per `action_mask`); an all-false mask means the rollout no-ops."""
        cfg = self.cfg
        b, r, c = cfg.decompose_action(int(action))
        assert b < int(self.inst.n_total) and not self.state.packed[b], \
            "step() called on a packed/padded block"
        assert self.in_window(b) and self.accessible(b, r), \
            "step() called on an inaccessible (masked) block"
        w, d, h = self.rotated_dims(b, r)
        best = self._best_candidate(c, w, d, h)
        assert best is not None, "step() called with an unplaceable action"
        x, y, l, stable = best
        self.state.heightmap[c, x:x + w, y:y + d] = l + h
        self.state.packed[b] = True
        self.state.placements[b] = (c, r, x, y, l, int(stable))
        self.state = self.state._replace(t=np.int32(int(self.state.t) + 1))
        return self.state

    def done(self) -> bool:
        return bool(np.all(self.state.packed))

    # ------------------------------------------------------------------ #

    def reward_fractions(self):
        """Exact rational C, P, S per SPEC.md §7 (None if undefined)."""
        cfg = self.cfg
        placed = self.state.placements[:, PLACE_CONTAINER] >= 0
        n_placed = int(placed.sum())
        if n_placed == 0:
            return Fraction(0), Fraction(0), Fraction(0)
        vol = 0
        for b in np.nonzero(placed)[0]:
            w, d, h = self.rotated_dims(int(b), int(self.state.placements[b, PLACE_ROT]))
            vol += w * d * h
        area = cfg.target_width * cfg.target_depth
        denom_c = 0
        denom_p = 0
        used = np.unique(self.state.placements[placed, PLACE_CONTAINER])
        for c in used:
            hm = self.state.heightmap[int(c)]
            denom_c += area * int(hm.max())
            denom_p += int(hm.sum())
        C = Fraction(vol, denom_c)
        P = Fraction(vol, denom_p)
        S = Fraction(int(self.state.placements[placed, PLACE_STABLE].sum()), n_placed)
        return C, P, S

    def reward_ints(self):
        """Integer reward terms (vol, denom_c, denom_p, s_num, s_den) —
        the exact quantities the JAX env's `reward_terms` must reproduce."""
        cfg = self.cfg
        placed = self.state.placements[:, PLACE_CONTAINER] >= 0
        vol = int(sum(int(np.prod(self.inst.dims[b].astype(np.int64)))
                      for b in np.nonzero(placed)[0]))
        area = cfg.target_width * cfg.target_depth
        denom_c = denom_p = 0
        for c in range(cfg.num_containers):
            hm = self.state.heightmap[c]
            if hm.max() > 0:
                denom_c += area * int(hm.max())
                denom_p += int(hm.sum())
        s_num = int(self.state.placements[placed, PLACE_STABLE].sum())
        s_den = int(placed.sum())
        return vol, denom_c, denom_p, s_num, s_den

    def reward(self) -> float:
        C, P, S = self.reward_fractions()
        terms = {"C": C, "P": P, "S": S}
        return float(np.float32(sum(float(np.float32(float(terms[t])))
                                    for t in self.cfg.reward_terms)))
