"""Binding of the hand-written Hopper prefill-attention kernel
(``csrc/flash_attention.cu``: ``wgmma`` tensor cores, TMA loads through a
2-stage ring), the port of the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py:flash_attention``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, d) bf16, CUDA
    k: torch.Tensor,  # (B, Sk, K, d)
    v: torch.Tensor,  # (B, Sk, K, d)
    *,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal GQA attention on the card: query ``i`` sits at position
    ``q_offset + i`` and sees keys ``0 .. q_offset + i``.  Any ``Sq`` and
    ``Sk``; ``d`` = 128; strided (B, S, heads, d) views with unit
    stride on ``d``.  Returns (B, Sq, H, d) bf16."""
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    for name, t, st in (("q", q, qs), ("k", k, ks), ("v", v, vs)):
        _cuda.require_cuda(t, name, torch.bfloat16)
        # TMA steps through strides that are positive multiples of 16 bytes
        # (a dimension of size 1 is never stepped)
        if t.data_ptr() % 16 or any(
            x % 8 or x <= 0 for x, n in zip(st[:3], t.shape[:3]) if n > 1
        ):
            raise ValueError(f"{name} must be 16-byte aligned in every row")
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kh, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")
    if h % kh or d != 128 or q_offset < 0:
        raise ValueError(f"unsupported: H={h} K={kh} d={d} q_offset={q_offset}")
    out = q.new_empty((b, sq, h, d))
    strides = _cuda.int64_array(
        (*qs[:3], *ks[:3], *vs[:3], sq * h * d, h * d, d)
    )
    err = _cuda.library().repro_flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kh, d, strides, q_offset, d**-0.5, _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
