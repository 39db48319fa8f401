"""Binding of the hand-written Hopper prefill-attention kernel
(``csrc/flash_attention.cu``: ``wgmma`` tensor cores, TMA loads through a
2-stage ring), the port of the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py:flash_attention``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

#: the (Q/K width, V width) pairs the kernel is built for: qwen3's and
#: qwen2.5's, zamba2's, MLA's decompressed heads (minicpm3: nope 64 + rope
#: 32 for Q and K, 64 for V), whisper's and paligemma's
HEAD_DIMS = ((128, 128), (112, 112), (96, 64), (64, 64), (256, 256))


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, d_qk) bf16, CUDA
    k: torch.Tensor,  # (B, Sk, K, d_qk)
    v: torch.Tensor,  # (B, Sk, K, d_v)
    *,
    q_offset: int = 0,
    causal: bool = True,
    prefix_len: int = 0,
) -> torch.Tensor:
    """GQA attention on the card at scale ``d_qk ** -0.5``.  Causal:
    query ``i`` sits at position ``q = q_offset + i`` and sees keys ``0 ..
    max(q, prefix_len - 1)``: with ``prefix_len`` P > 0 the first P
    positions see each other both ways (the prefix-LM mask of a VLM's image
    prefix); not causal: every query sees all ``Sk`` keys (the encoder's
    and the cross-attention's).  Any ``Sq`` and ``Sk``; ``(d_qk, d_v)`` in :data:`HEAD_DIMS`;
    strided (B, S, heads, d) views with unit stride on ``d``.  Returns (B,
    Sq, H, d_v) bf16."""
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
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (b, sk, kh, d) or v.shape != (b, sk, kh, dv):
        raise ValueError(f"shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")
    if h % kh or (d, dv) not in HEAD_DIMS or q_offset < 0 or prefix_len < 0:
        raise ValueError(
            f"unsupported: H={h} K={kh} d_qk={d} d_v={dv} q_offset={q_offset} "
            f"prefix_len={prefix_len}"
        )
    out = q.new_empty((b, sq, h, dv))
    strides = _cuda.int64_array(
        (*qs[:3], *ks[:3], *vs[:3], sq * h * dv, h * dv, dv)
    )
    err = _cuda.library().repro_flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kh, d, dv, strides, q_offset, int(causal), prefix_len,
        d**-0.5,
        _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_attention")
    _cuda.count_launch(flash_attention)
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
