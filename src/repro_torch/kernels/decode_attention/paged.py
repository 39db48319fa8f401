"""Binding of the hand-written Hopper paged decode-attention kernel
(``csrc/paged_decode_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/decode_attention/paged.py:paged_decode_attention`` for
the f32 page pool."""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.decode_attention.decode_attention import workspace


def check_paged_inputs(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    pool_dtype: torch.dtype,
) -> None:
    """The wrapper checks shared by the f32 and the int8 paged kernels."""
    _cuda.require_cuda(q, "q", torch.bfloat16)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _cuda.require_cuda(t, name, pool_dtype)
        # rows are read 4 elements a lane: float4 (f32) or char4 (int8)
        if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned, rows 4-element aligned")
    for name, t in (("tables", tables), ("lengths", lengths)):
        _cuda.require_cuda(t, name, torch.int32)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, one, h, d = q.shape
    ps, kh = k_pages.shape[1], k_pages.shape[2]
    if (one != 1 or k_pages.shape[3] != d or v_pages.shape != k_pages.shape
            or tables.dim() != 2 or tables.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(
            f"shape mismatch: q {q.shape}, pages {k_pages.shape} / "
            f"{v_pages.shape}, tables {tables.shape}, lengths {lengths.shape}"
        )
    if h % kh or h // kh > 8 or d != 128:
        raise ValueError(f"unsupported: H={h} K={kh} d={d} page_size={ps}")


def paged_decode_attention(
    q: torch.Tensor,        # (B, 1, H, d) bf16, CUDA
    k_pages: torch.Tensor,  # (P, ps, K, d) f32 page pool of one layer
    v_pages: torch.Tensor,
    tables: torch.Tensor,   # (B, nP) int32 page ids; entries past the length pad
    lengths: torch.Tensor,  # (B,) int32 in [1, nP * ps]
) -> torch.Tensor:
    """One query token per sequence over its first ``lengths[b]`` positions,
    read from the pool through its page table, on the card.  Every table
    entry must be a valid page id.  The contiguous kernel's span split and
    combine, one device kernel a call: on the same rows its bits at any
    page size.  Returns (B, 1, H, d) bf16."""
    check_paged_inputs(q, k_pages, v_pages, tables, lengths, torch.float32)
    b, _, h, d = q.shape
    ps, kh, n_table = k_pages.shape[1], k_pages.shape[2], tables.shape[1]
    out = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device=q.device)
    strides = [q.stride(0), q.stride(2), *k_pages.stride()[:3],
               *v_pages.stride()[:3], out.stride(0), out.stride(2)]
    stream = _cuda.stream_of(q)
    scratch, arrivals = workspace(q, stream, n_table * ps, kh)
    err = _cuda.library().repro_paged_decode_attention_f32(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, kh, d,
        ps, n_table, _cuda.int64_array(strides), d**-0.5, scratch.data_ptr(),
        scratch.numel(), arrivals.data_ptr(), arrivals.numel(), stream,
    )
    _cuda.check(err, "paged_decode_attention")
    _cuda.count_launch(paged_decode_attention)
    return out


#: kernel launches since the count was last set to 0
paged_decode_attention.launches = 0
