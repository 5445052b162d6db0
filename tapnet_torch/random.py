"""Threefry-2x32 keys and draws, bit-equal to `jax.random` (SPEC.md §2).

The JAX package makes every instance and every sampling draw from threefry
keys under `jax_threefry_partitionable=True`. The port reproduces that stream
so that one seed means one instance and one gumbel draw on both sides:

- a key is an int64 tensor [..., 2] holding two uint32 words (torch's uint32
  arithmetic is partial, so words live in int64 and every add is masked);
- `split(key, n)[i]    = threefry(key, (0, i))`;
- `fold_in(key, d)     = threefry(key, (0, d))`;
- `bits(key, shape)[i] = xor of threefry(key, (i >> 32, i & 0xffffffff))`;
- `uniform` and `gumbel` follow `jax._src.random._uniform` / `_gumbel`
  (mode "low") in float32.

Every function is batched over the leading axes of `key`. Python scalars
become device tensors by fills, never by host-to-device copies, so the
draws can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on broadcast int64 words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & M32
    x2 = (x2 + k2) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.key(seed)` contents for a 32-bit seed: (0, seed mod 2^32)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    k = torch.zeros(2, dtype=torch.int64, device=device)
    k[1:].fill_(seed & M32)
    return k


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """[..., 2] -> [..., num, 2]."""
    k1, k2 = key[..., 0:1], key[..., 1:2]
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """[..., 2] -> [..., 2]; `data` an int or an int tensor broadcasting
    against the key's leading axes."""
    k1, k2 = key[..., 0], key[..., 1]
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & M32
    else:
        d = torch.full((), int(data) & M32, dtype=torch.int64,
                       device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """uint32 draws as int64 in [0, 2^32): [..., 2] -> [..., *shape]."""
    shape = tuple(shape)
    n = math.prod(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & M32)
    return (b1 ^ b2).reshape(lead + shape)


def _bits_to_unit(b: torch.Tensor) -> torch.Tensor:
    """Mantissa trick of jax.random.uniform: float32 in [0, 1)."""
    fb = (b >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    f = _bits_to_unit(bits(key, shape))
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """Standard gumbel (jax mode "low"): -log(-log(U[tiny, 1)))."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))
