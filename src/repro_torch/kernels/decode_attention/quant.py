"""Symmetric absmax int8 block quantization of KV pages: the port's copy of
``repro/kernels/decode_attention/quant.py``, bit for bit.

One group per (page, KV head): the scale is the group's absmax over 127,
stored as f32 beside the int8 page; an all-zero group gets scale 1.0.
Rounding is half to even.

The reference runs on XLA, which treats f32 subnormals as zero on input
and flushes subnormal results to zero (on its CPU backend and on the TPU
alike).  PyTorch keeps subnormals, so the port applies the same two rules
explicitly where they can change a stored bit: a subnormal absmax counts
as zero (scale 1.0), a subnormal ``absmax / 127`` becomes a scale of 0.0,
a subnormal element quantizes as zero, and the 0/0 that a zero scale then
makes becomes byte 0, as XLA converts NaN to int8.
"""

from __future__ import annotations

import torch

#: int8 symmetric range [-127, 127]
QMAX = 127.0
#: smallest normal f32; anything smaller in magnitude is a subnormal or 0
_TINY = torch.finfo(torch.float32).tiny


def _norm_axes(ndim: int, axes: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(sorted(a % ndim for a in axes))


def _expand(t: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    for a in axes:
        t = t.unsqueeze(a)
    return t


def absmax_quantize(
    x: torch.Tensor,
    group_axes: tuple[int, ...],
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 values and one f32 scale per group; ``group_axes`` are reduced
    away in the scale.  ``mask`` (broadcastable to ``x``) zeroes elements
    before the absmax and the store."""
    axes = _norm_axes(x.dim(), group_axes)
    xf = x.float()
    if mask is not None:
        xf = torch.where(mask, xf, 0.0)
    absmax = xf.abs().amax(dim=axes)
    scale = torch.where(absmax >= _TINY, absmax / QMAX, 1.0)
    scale = torch.where(scale >= _TINY, scale, 0.0)
    xf = torch.where(xf.abs() >= _TINY, xf, 0.0)
    q = torch.round(xf / _expand(scale, axes))
    q = torch.nan_to_num(q, nan=0.0).clamp(-QMAX, QMAX).to(torch.int8)
    return q, scale


def absmax_dequantize(
    q: torch.Tensor,
    scale: torch.Tensor,
    group_axes: tuple[int, ...],
) -> torch.Tensor:
    """f32 values ``q * scale`` (the inverse of :func:`absmax_quantize` up
    to rounding)."""
    axes = _norm_axes(q.dim(), group_axes)
    return q.float() * _expand(scale, axes)


def quantize_pages(pages: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pool layout ``(P, ps, K, d)`` -> int8 pages and ``(P, K)`` f32
    scales, one group per page and KV head."""
    return absmax_quantize(pages, (1, 3))


def dequantize_pages(q_pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`, in f32."""
    return absmax_dequantize(q_pages, scales, (1, 3))
