"""The Threefry-2x32 counter PRNG with the key split, ``randint``,
``uniform`` and ``gumbel`` of ``jax.random`` (JAX 0.9.0: ``jax._src.prng``
and ``jax._src.random``, default implementation ``threefry2x32`` with
``jax_threefry_partitionable`` on and 64-bit mode off), in integer torch
ops.  The port's in-memory bootstrap draws its resample indices here, and
its temperature sampling its Gumbel noise, so both are the reference's bits
on whatever device the session runs.

A key is an int64 tensor of shape (..., 2) holding two uint32 words.  torch
has no full uint32 arithmetic, so every uint32 value lives in an int64
tensor and is masked to 32 bits after each add and shift; the one product
(in ``randint``) is of two values below 2**31, so it fits in int64 before
its mask.
"""

from __future__ import annotations

import struct

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




def _f32(v: float) -> float:
    """``v`` rounded to the nearest f32, as XLA holds its constants."""
    return struct.unpack("f", struct.pack("f", v))[0]


#: f32 constants of XLA's CPU logarithm (the Cephes polynomial; see ``log32``)
_F32_TINY = _f32(1.1754943508222875e-38)
_SQRT_HALF = _f32(0.707106781186547524)
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


def uniform(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for one
    key: the top 23 bits of each word fill the mantissa of a float in [1, 2),
    less 1, scaled into the range (one fused multiply-add, as XLA does it)
    and clamped below at ``minval``."""
    n = 1
    for d in shape:
        n *= d
    bits = random_bits(key, n).reshape(shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA fuses the scale and the shift into one multiply-add
    return torch.maximum(lo, _fma32(floats, (hi - lo).double(), lo))


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as a fused multiply-add gives
    it.  The product is exact in f64 and two-sum recovers the f64 sum's
    rounding error exactly; rounding that sum to f32 is then wrong only
    where it lands on an f32 tie with a non-zero error, and there the sum
    is moved one f64 ulp toward the exact value first."""
    p = a.double() * b
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    neighbour = torch.nextafter(r, torch.where(s > r64, inf, -inf)).double()
    tie = (s != r64) & (2 * s == r64 + neighbour) & (err != 0)
    toward = torch.where(err > 0, inf, -inf).double()
    return torch.where(tie, torch.nextafter(s, toward), s).float()


def log32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal f32 values, bit for bit as XLA's CPU
    backend computes it: the Cephes degree-8 polynomial over the mantissa
    folded into [sqrt(1/2), sqrt(2)), with fused multiply-adds where XLA
    fuses them.  ``torch.log`` differs from it by an ulp in ~1 value of 7.
    """
    x = x.float()
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma32(_fma32(m, p[0], p[1]), m, p[2])
    y1 = _fma32(_fma32(m, p[3], p[4]), m, p[5])
    y2 = _fma32(_fma32(m, p[6], p[7]), m, p[8])
    y = _fma32(_fma32(y, m3, y1), m3, y2)
    y = _fma32(y, m3, e * _LOG_Q1)
    return ((m - m2 * 0.5) + y) + e * _LOG_Q2


def gumbel(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default ``"low"``
    mode: ``-log(-log(u))`` of ``uniform`` draws in [tiny, 1)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -log32(-log32(u))
