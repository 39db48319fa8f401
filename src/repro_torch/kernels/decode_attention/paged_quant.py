"""Binding of the hand-written Hopper int8 paged decode-attention kernel
(``csrc/quant_paged_decode_attention.cu``), the port of the Pallas TPU
kernel
``repro/kernels/decode_attention/paged_quant.py:quant_paged_decode_attention``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.decode_attention.paged import check_paged_inputs

#: positions a block of the split pass reads (``SPAN`` in the CUDA source):
#: a constant, so a sequence's result never depends on the batch
SPAN = 128


def quant_paged_decode_attention(
    q: torch.Tensor,         # (B, 1, H, d) bf16, CUDA
    k_pages: torch.Tensor,   # (P, ps, K, d) int8 page pool of one layer
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # (P, K) f32 per-(page, KV head) scales
    v_scales: torch.Tensor,
    tables: torch.Tensor,    # (B, nP) int32
    lengths: torch.Tensor,   # (B,) int32 in [1, nP * ps]
    new_rows: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Decode attention over int8 pages dequantized in the kernel.
    ``new_rows = (k_new, v_new, new_pos)``, two (B, K, d) f32 rows and a
    (B,) int32 position, are read in place of pool row ``new_pos[b]`` where
    that lies below the length.  One call runs two device kernels (a split
    over spans of ``SPAN`` positions, then their combine in span order) and
    counts one launch.  Returns (B, 1, H, d) bf16."""
    check_paged_inputs(q, k_pages, v_pages, tables, lengths, torch.int8)
    b, _, h, d = q.shape
    p_pool, kh = k_pages.shape[0], k_pages.shape[2]
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        _cuda.require_cuda(t, name, torch.float32)
        if t.shape != (p_pool, kh):
            raise ValueError(f"{name} must be ({p_pool}, {kh}), got {t.shape}")
    k_new = v_new = new_pos = None
    new_strides = [0, 0]
    if new_rows is not None:
        k_new, v_new, new_pos = new_rows
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            _cuda.require_cuda(t, name, torch.float32)
            if t.shape != (b, kh, d) or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name} must be a contiguous ({b}, {kh}, {d}) tensor")
        _cuda.require_cuda(new_pos, "new_pos", torch.int32)
        if new_pos.shape != (b,) or not new_pos.is_contiguous():
            raise ValueError(f"new_pos must be a contiguous ({b},) tensor")
        new_strides = list(k_new.stride()[:2])
    out = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device=q.device)
    n_span = -(-tables.shape[1] * k_pages.shape[1] // SPAN)
    scratch = torch.empty(b * kh * n_span * (h // kh) * (d + 2),
                          dtype=torch.float32, device=q.device)
    strides = [q.stride(0), q.stride(2), *k_pages.stride()[:3],
               *v_pages.stride()[:3], *k_scales.stride(), *v_scales.stride(),
               *new_strides, out.stride(0), out.stride(2)]
    err = _cuda.library().repro_quant_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(),
        None if k_new is None else k_new.data_ptr(),
        None if v_new is None else v_new.data_ptr(),
        None if new_pos is None else new_pos.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, kh, d,
        k_pages.shape[1], tables.shape[1], _cuda.int64_array(strides),
        d**-0.5, scratch.data_ptr(), scratch.numel(), _cuda.stream_of(q),
    )
    _cuda.check(err, "quant_paged_decode_attention")
    _cuda.count_launch(quant_paged_decode_attention)
    return out


#: kernel launches since the count was last set to 0
quant_paged_decode_attention.launches = 0
