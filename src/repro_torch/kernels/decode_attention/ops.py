"""Model-facing decode attention: the Hopper kernels for CUDA tensors, the
plain versions for CPU tensors.  There is no fallback: a CUDA tensor a
kernel does not take (a cache that is not f32, say) raises."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention,
)
from repro_torch.kernels.decode_attention.paged import paged_decode_attention
from repro_torch.kernels.decode_attention.paged_quant import (
    quant_paged_decode_attention,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
    quant_paged_decode_attention_ref,
)


def _dispatch(q: torch.Tensor, kernel, plain, *args):
    if q.is_cuda:
        return kernel(q, *args)
    if q.device.type == "cpu":
        return plain(q, *args)
    raise ValueError(f"no decode attention for device {q.device}")


def decode_attention_bshd(
    q: torch.Tensor,        # (B, 1, H, d)
    k_cache: torch.Tensor,  # (B, S, K, d)
    v_cache: torch.Tensor,  # (B, S, K, d)
    lengths: torch.Tensor,  # (B,) int32 valid rows per sequence, in [1, S]
) -> torch.Tensor:
    return _dispatch(q, decode_attention, decode_attention_ref,
                     k_cache, v_cache, lengths)


def paged_decode_attention_bshd(
    q: torch.Tensor,        # (B, 1, H, d)
    k_pages: torch.Tensor,  # (P, ps, K, d) f32
    v_pages: torch.Tensor,
    tables: torch.Tensor,   # (B, nP) int32
    lengths: torch.Tensor,  # (B,) int32 in [1, nP * ps]
) -> torch.Tensor:
    return _dispatch(q, paged_decode_attention, paged_decode_attention_ref,
                     k_pages, v_pages, tables, lengths)


def quant_paged_decode_attention_bshd(
    q: torch.Tensor,         # (B, 1, H, d)
    k_pages: torch.Tensor,   # (P, ps, K, d) int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # (P, K) f32
    v_scales: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    new_rows: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    return _dispatch(q, quant_paged_decode_attention,
                     quant_paged_decode_attention_ref, k_pages, v_pages,
                     k_scales, v_scales, tables, lengths, new_rows)
