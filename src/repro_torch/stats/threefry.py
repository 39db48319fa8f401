"""The Threefry-2x32 counter PRNG with the key split and ``randint`` of
``jax.random`` (JAX 0.9.0: ``jax._src.prng`` and ``jax._src.random``,
default implementation ``threefry2x32`` with ``jax_threefry_partitionable``
on and 64-bit mode off), in integer torch ops.  The port's in-memory
bootstrap draws its resample indices here, so they are the reference's
integers bit for bit, on whatever device the session runs.

A key is an int64 tensor of shape (..., 2) holding two uint32 words.  torch
has no full uint32 arithmetic, so every uint32 value lives in an int64
tensor and is masked to 32 bits after each add and shift; the one product
(in ``randint``) is of two values below 2**31, so it fits in int64 before
its mask.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(
    key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of the counter words ``(x0, x1)``
    under ``key`` (..., 2), broadcast against the counters' last axis."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def key(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.key(seed)``: in 32-bit mode the seed is an int32, its
    high word 0 and its low word the seed's two's complement."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def _counters(key: torch.Tensor, n: int) -> torch.Tensor:
    """The low words 0 .. n-1 of a flat uint64 iota (the high words are 0
    below 2**32), shaped to broadcast against ``key``'s batch axes."""
    if n >= 2**32:
        raise ValueError(f"{n} counters exceed 32 bits")
    return torch.arange(n, dtype=torch.int64, device=key.device)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` (the fold-like split): key i is the
    hash of counter (0, i).  Returns (..., num, 2)."""
    lo = _counters(key, num)
    bits0, bits1 = threefry2x32(key, torch.zeros_like(lo), lo)
    return torch.stack([bits0, bits1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``random_bits`` of shape (..., n): the two hash words of
    counter (0, i) xor-ed."""
    lo = _counters(key, n)
    bits0, bits1 = threefry2x32(key, torch.zeros_like(lo), lo)
    return bits0 ^ bits1


def randint(key: torch.Tensor, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` in int32 (the
    default dtype in 32-bit mode): two words of bits per value from the
    two halves of ``split(key, 2)``, folded into the span as
    ``(hi % span * (2**16 % span)**2 % span + lo % span) % span`` in
    wrapping uint32.  Returns int64 (..., n)."""
    if not -(2**31) <= minval <= maxval < 2**31:
        raise ValueError(f"range [{minval}, {maxval}) is not int32")
    span = max(maxval - minval, 1)
    mult = ((2**16 % span) ** 2 & _M) % span
    halves = split(key, 2)
    hi = random_bits(halves[..., 0, :], n)
    lo = random_bits(halves[..., 1, :], n)
    offset = ((hi % span) * mult) & _M
    offset = ((offset + lo % span) & _M) % span
    return minval + offset
