"""Binding of the hand-written Hopper decode-attention kernel
(``csrc/decode_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/decode_attention/decode_attention.py:decode_attention`` for
the contiguous f32 cache.  It and the paged f32 kernel are one span-split
design (``csrc/split_decode.cuh``) and share :func:`workspace`."""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

#: positions a block of the span split reads (``SPAN`` in
#: ``csrc/split_decode.cuh``): a constant, so a sequence's result never
#: depends on the batch, the cache length or the page size
SPAN = 128

#: the head widths the contiguous kernel is built for: qwen3's, qwen2.5's and
#: the MoE family's, zamba2's, whisper's, paligemma's (the paged kernels
#: take 128 only: only the dense and MoE families page)
HEAD_DIMS = (128, 112, 64, 256)

#: (device index, stream) -> (f32 partials scratch, uint32 arrival counters)
_WORKSPACES: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(q: torch.Tensor, stream: int, limit: int,
              n_kv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scratch of the f32 decode kernels for a call with query ``q``
    (B, 1, H, d) over ``limit`` positions a sequence (S, or nP * ps) and
    ``n_kv`` KV heads: the span partials, (B, K, n_span, G) rows of d + 2
    floats with n_span = ceil(limit / SPAN), and B * K arrival counters.
    Kept per (device, stream) and grown when a call needs more: calls on
    one stream run in order, so one workspace serves them all, and every
    call leaves the counters at zero (they are zeroed once, when
    allocated)."""
    b, _, h, d = q.shape
    n_floats, n_counters = b * h * -(-limit // SPAN) * (d + 2), b * n_kv
    key = (q.device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_counters:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(n_floats, have[0]), dtype=torch.float32, device=q.device),
              # int32 storage for the kernel's uint32 counters
              torch.zeros(max(n_counters, have[1]), dtype=torch.int32, device=q.device))
        _WORKSPACES[key] = ws
    return ws


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, d) bf16, CUDA
    k_cache: torch.Tensor,  # (B, S, K, d) f32
    v_cache: torch.Tensor,  # (B, S, K, d) f32
    lengths: torch.Tensor,  # (B,) int32, each in [1, S]
) -> torch.Tensor:
    """One query token per sequence over its first ``lengths[b]`` cache
    rows, on the card.  ``d`` in :data:`HEAD_DIMS`, at most 8 query heads
    per KV head.  One device kernel a call: a split over spans of ``SPAN``
    positions whose last block per (sequence, KV head) combines the spans
    in order.  Returns (B, 1, H, d) bf16."""
    _cuda.require_cuda(q, "q", torch.bfloat16)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _cuda.require_cuda(t, name, torch.float32)
        if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned in every row")
    _cuda.require_cuda(lengths, "lengths", torch.int32)
    b, one, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (b, s, kh, d) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"shape mismatch: q {q.shape}, cache {k_cache.shape} / {v_cache.shape}"
        )
    if lengths.shape != (b,) or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous ({b},) tensor")
    if h % kh or h // kh > 8 or d not in HEAD_DIMS:
        raise ValueError(f"unsupported: H={h} K={kh} d={d}")
    out = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device=q.device)
    strides = [q.stride(0), q.stride(2), *k_cache.stride()[:3],
               *v_cache.stride()[:3], out.stride(0), out.stride(2)]
    stream = _cuda.stream_of(q)
    scratch, arrivals = workspace(q, stream, s, kh)
    err = _cuda.library().repro_decode_attention_f32cache(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, h, kh, d, s,
        _cuda.int64_array(strides), d**-0.5, scratch.data_ptr(),
        scratch.numel(), arrivals.data_ptr(), arrivals.numel(), stream,
    )
    _cuda.check(err, "decode_attention")
    _cuda.count_launch(decode_attention)
    return out


#: kernel launches since the count was last set to 0
decode_attention.launches = 0
