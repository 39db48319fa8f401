"""Plain PyTorch versions of the bootstrap-partials and bootstrap-means
kernels: the identical counter-based mixer and Poisson(1) inverse CDF as
the JAX package's ``repro/kernels/bootstrap/ref.py``, bit for bit on the
weights.

torch has no full uint32 arithmetic, and an int64 product of two 32-bit
values can overflow, so uint32 values are held in int64 tensors and every
multiply goes through :func:`_mul_u32`, which splits the constant into
16-bit halves so that no intermediate exceeds 2**49.
"""

from __future__ import annotations

import torch

# cumulative Poisson(1) probabilities for k = 0..6 (k=7 tail mass ~8e-5)
POISSON1_CDF = (
    0.36787944117144233,
    0.7357588823428847,
    0.9196986029286058,
    0.9810118431238462,
    0.9963401531726563,
    0.9994058151824183,
    0.9999167588507119,
)

_U32 = 0xFFFFFFFF

#: row-block size; fixed so the f32 accumulation order is reproducible
DEFAULT_BLOCK_N = 1024


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for an int64 tensor of uint32 values."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def mix_bits(boot: torch.Tensor, pos: torch.Tensor, seed: int) -> torch.Tensor:
    """Counter-based 32-bit mixer (murmur3 finalizer over a seeded
    combination of replicate and position counters).  ``boot`` and ``pos``
    are int64 tensors of uint32 values; returns the same."""
    h = _mul_u32(boot, 0x9E3779B1) ^ _mul_u32(pos, 0x85EBCA77) ^ (seed & _U32)
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def poisson1_weight(bits: torch.Tensor) -> torch.Tensor:
    """Uniform uint32 bits -> Poisson(1) draw in f32 via inverse CDF
    (k <= 7): ``(bits >> 8) * 2**-24`` compared in f32 against the
    f32-rounded CDF constants."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    w = torch.zeros_like(u)
    for c in POISSON1_CDF:
        w = w + (u >= torch.tensor(c, dtype=torch.float32)).to(torch.float32)
    return w


def bootstrap_partials_ref(
    scores: torch.Tensor,  # (n, m) — NaN marks unscorable examples
    seed: int,
    start: int,            # absolute example offset of row 0
    *,
    n_boot: int,
    block_n: int = DEFAULT_BLOCK_N,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum w*x, sum w)`` f32 replicate pairs of shape (n_boot, m), the
    weight of (replicate b, row p) keyed by ``(seed, start + p, b)``.
    Streams ``block_n`` rows at a time; f32 products stay IEEE (the caller
    must not enable TF32 on the card)."""
    n, m = scores.shape
    dev = scores.device
    x = scores.to(torch.float32)
    swx = torch.zeros((n_boot, m), dtype=torch.float32, device=dev)
    sw = torch.zeros((n_boot, m), dtype=torch.float32, device=dev)
    boot = torch.arange(n_boot, dtype=torch.int64, device=dev)[:, None]
    for i0 in range(0, n, block_n):
        xb = x[i0 : i0 + block_n]
        pos = (start + i0 + torch.arange(xb.shape[0], device=dev)) & _U32
        w = poisson1_weight(mix_bits(boot, pos[None, :], seed))
        valid = ~torch.isnan(xb)
        swx += w @ torch.where(valid, xb, 0.0)
        sw += w @ valid.to(torch.float32)
    return swx, sw


def bootstrap_means_ref(
    data: torch.Tensor,  # (n,) f32
    n_boot: int,
    seed: int,
) -> torch.Tensor:
    """(n_boot,) Poisson-bootstrap means ``sum w*x / max(sum w, 1)``, the
    weight of (replicate b, example i) keyed by ``(seed, i, b)``.  Streams
    ``DEFAULT_BLOCK_N`` examples at a time, so the (n_boot, n) weight
    matrix is never made.  No NaN masking: a NaN in ``data`` makes every
    mean NaN."""
    dev = data.device
    x = data.to(torch.float32)
    swx = torch.zeros((n_boot,), dtype=torch.float32, device=dev)
    sw = torch.zeros((n_boot,), dtype=torch.float32, device=dev)
    boot = torch.arange(n_boot, dtype=torch.int64, device=dev)[:, None]
    for i0 in range(0, x.shape[0], DEFAULT_BLOCK_N):
        xb = x[i0 : i0 + DEFAULT_BLOCK_N]
        pos = (i0 + torch.arange(xb.shape[0], device=dev)) & _U32
        w = poisson1_weight(mix_bits(boot, pos[None, :], seed))
        swx += w @ xb
        sw += w.sum(dim=1)
    return swx / torch.clamp(sw, min=1.0)
