"""Plain PyTorch version of the prefill-attention kernel (the port's oracle
and its CPU path).  Layout is the model's: q and k (B, Sq or Sk, H or K,
d_qk), v (B, Sk, K, d_v), with H = K * G."""

from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    causal: bool = True,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Exact GQA attention at scale ``d_qk ** -0.5``, causal (query ``i``
    at position ``q_offset + i``; with ``prefix_len`` P > 0 the prefix-LM
    mask, under which queries and keys below P also see each other, the
    reference's ``make_causal_mask``) or over every key: scores and
    softmax in f32, probabilities cast to v's dtype before the P V product
    (as the JAX model's ``naive_attention`` does), output (B, Sq, H, d_v)
    in q's dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d**-0.5
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        k_pos = torch.arange(sk, device=q.device)
        visible = q_pos[:, None] >= k_pos[None, :]
        if prefix_len:
            visible = visible | ((q_pos[:, None] < prefix_len)
                                 & (k_pos[None, :] < prefix_len))
        scores = torch.where(visible, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, -1).to(q.dtype)
