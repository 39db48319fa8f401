"""Model-facing prefill attention: the Hopper kernel for CUDA tensors, the
plain version for CPU tensors.  There is no fallback: a CUDA tensor the
kernel does not take raises."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention_bshd(
    q: torch.Tensor,  # (B, Sq, H, d_qk)
    k: torch.Tensor,  # (B, Sk, K, d_qk)
    v: torch.Tensor,  # (B, Sk, K, d_v)
    *,
    q_offset: int = 0,
    causal: bool = True,
    prefix_len: int = 0,
) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention(q, k, v, q_offset=q_offset, causal=causal,
                               prefix_len=prefix_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_offset=q_offset, causal=causal,
                                   prefix_len=prefix_len)
    raise ValueError(f"no prefill attention for device {q.device}")
