"""Typed frozen configuration for the TAP environment family.

The port's own copy of `tapnet_tpu/config.py` (the port imports nothing of
the JAX package): the same hashable frozen dataclass, the same validation
and the same `CONFIGS`, field for field (tests/test_torch_config_random.py
holds the two equal).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

_REWARD_RE = re.compile(r"^([CPS](\+[CPS])*)-(lb|mcs)-(soft|hard)$")


@dataclasses.dataclass(frozen=True)
class TAPConfig:
    """Static (trace-time) parameters of a TAP task. See SPEC.md."""

    dim: int = 2                  # 2 or 3 (2D == depth-1 slice of the 3D frame)
    num_blocks: int = 10          # N: padded block capacity per instance
    min_blocks: int = 10          # n_total ~ U{min_blocks..num_blocks} (rolling)
    container_width: int = 10     # initial container W
    container_depth: int = 1      # initial container D (1 for 2D)
    container_height: int = 10    # initial container H (guillotine start)
    target_width: int = 10        # target container Wt
    target_depth: int = 1         # target container Dt (1 for 2D)
    target_height: int = 0        # Ht; 0 => unbounded
    num_containers: int = 1       # C target containers
    allow_rot: bool = False
    window: int = 0               # K-block rolling observation window; 0 => full
    reward_type: str = "C+P+S-lb-soft"

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        if self.dim == 2 and (self.container_depth != 1 or self.target_depth != 1):
            raise ValueError("2D tasks must have depth 1")
        if not (1 <= self.min_blocks <= self.num_blocks):
            raise ValueError("need 1 <= min_blocks <= num_blocks")
        if self.container_width * self.container_depth * self.container_height < self.num_blocks:
            raise ValueError("initial container too small for num_blocks")
        if _REWARD_RE.match(self.reward_type) is None:
            raise ValueError(f"unsupported reward_type {self.reward_type!r}")
        if len(set(self.reward_terms)) != len(self.reward_terms):
            raise ValueError(f"duplicate reward terms in {self.reward_type!r}")
        if self.placement_rule == "mcs":
            # SPEC.md §6.4: mcs scores are compared as exact integer
            # fractions; reject geometries whose worst-case numerator or
            # denominator would overflow the 64-bit accumulators shared by
            # the oracle / JAX (32-bit limb) / native (__int128) tiers.
            area = self.target_width * self.target_depth
            dmax = self.num_containers * area * self.height_cap  # ≥ dc', dp'
            vmax = (self.container_width * self.container_depth
                    * self.container_height)                     # ≥ vol'
            smax = self.num_blocks                               # ≥ s_den'
            n_bound = 2 * vmax * dmax * smax + smax * dmax * dmax
            d_bound = dmax * dmax * smax
            if dmax >= 2**31 or max(n_bound, d_bound) >= 2**63:
                raise ValueError(
                    "geometry too large for exact mcs scoring "
                    f"(worst-case score fraction needs > 63 bits): {self!r}")

    # ---- derived static quantities -------------------------------------

    @property
    def num_rot(self) -> int:
        return 2 if self.allow_rot else 1

    @property
    def rot_axes(self) -> Tuple[int, int]:
        """Axes swapped by rotation state 1 (SPEC.md §4)."""
        return (0, 2) if self.dim == 2 else (0, 1)

    @property
    def split_axes(self) -> Tuple[int, ...]:
        """Axes the guillotine generator may split (SPEC.md §2)."""
        return (0, 2) if self.dim == 2 else (0, 1, 2)

    @property
    def num_actions(self) -> int:
        return self.num_blocks * self.num_rot * self.num_containers

    @property
    def height_cap(self) -> int:
        """Effective target height bound used for feasibility masking."""
        if self.target_height > 0:
            return self.target_height
        # Unbounded: any stack of all blocks fits under this.
        return self.num_blocks * max(self.container_width,
                                     self.container_depth,
                                     self.container_height) + 1

    @property
    def reward_terms(self) -> Tuple[str, ...]:
        return tuple(self.reward_type.split("-")[0].split("+"))

    @property
    def placement_rule(self) -> str:
        return self.reward_type.split("-")[1]

    @property
    def placement_variant(self) -> str:  # soft | hard
        return self.reward_type.split("-")[2]

    def decompose_action(self, a):
        """a -> (block, rot, container); works on ints and arrays."""
        rc = self.num_rot * self.num_containers
        return a // rc, (a // self.num_containers) % self.num_rot, a % self.num_containers

    def compose_action(self, block, rot, container):
        return (block * self.num_rot + rot) * self.num_containers + container


# The five reference configurations of BASELINE.json (lines 6-12).
CONFIGS = {
    # 1. 2D TAP, 10 blocks, no rotation, single container
    "2d-basic": TAPConfig(),
    # 2. 2D TAP, rotation + precedence/accessibility masks
    "2d-rot": TAPConfig(allow_rot=True),
    # 3. 3D TAP, 10 voxelized blocks, heightmap placement, stability reward
    "3d-basic": TAPConfig(dim=3, container_width=8, container_depth=8,
                          container_height=8, target_width=8, target_depth=8,
                          allow_rot=True),
    # 4. Rolling/sequential TAP: 20-50 blocks, sliding K-block window
    "2d-rolling": TAPConfig(num_blocks=50, min_blocks=20, container_width=16,
                            container_height=32, target_width=16, window=10,
                            allow_rot=True),
    # 5. Multi-target-container TAP (container-selection action); mixed 2D/3D
    #    batches are expressed per-instance with depth-1 blocks (SPEC.md §9).
    "multi-container": TAPConfig(dim=3, container_width=8, container_depth=8,
                                 container_height=8, target_width=8,
                                 target_depth=8, num_containers=2,
                                 allow_rot=True),
    # 6. Capped multi-container TAP (VERDICT r3 item 4): per-container
    #    capacity 6*8*8 = 384 < the 512-volume instance, so ANY packing of
    #    more than 384 volume must spill into container 1 — the container-
    #    selection axis provably matters (config 5's unbounded geometry
    #    never forces it). Rotation (w, d swap) keeps every block with
    #    min(w, d) <= 6 placeable.
    "multi-container-capped": TAPConfig(
        dim=3, container_width=8, container_depth=8, container_height=8,
        target_width=6, target_depth=8, target_height=8, num_containers=2,
        allow_rot=True),
}
