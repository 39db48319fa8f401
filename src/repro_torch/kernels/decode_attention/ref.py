"""Plain PyTorch versions of the decode-attention kernels (the port's
oracles and their CPU path), in the model layout: q (B, 1, H, d), a
contiguous cache (B, S, K, d), a page pool (P, ps, K, d)."""

from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) valid cache rows per sequence
) -> torch.Tensor:
    """Scores and softmax in f32 over the first ``lengths[b]`` rows, P V in
    the cache's dtype, output in q's dtype — the JAX model's decode path
    (``naive_attention`` over the masked cache)."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q[:, 0].reshape(b, kh, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * d**-0.5
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d).to(q.dtype)


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(P, ps, ...) pool and (B, nP) tables -> each sequence's pages laid
    end to end, (B, nP * ps, ...)."""
    g = pool[tables.long()]
    return g.reshape(tables.shape[0], -1, *pool.shape[2:])


def paged_decode_attention_ref(
    q: torch.Tensor,        # (B, 1, H, d)
    k_pages: torch.Tensor,  # (P, ps, K, d)
    v_pages: torch.Tensor,
    tables: torch.Tensor,   # (B, nP) int32; entries past the length are padding
    lengths: torch.Tensor,  # (B,) int32 in [1, nP * ps]
) -> torch.Tensor:
    """Decode attention over each sequence's pages read through its table:
    the gather of the reference's paged decode, then the contiguous
    version."""
    return decode_attention_ref(
        q, gather_pages(k_pages, tables), gather_pages(v_pages, tables), lengths
    )


def _gather_dequantized(
    pages: torch.Tensor, scales: torch.Tensor, tables: torch.Tensor
) -> torch.Tensor:
    """Each sequence's int8 pages times their (page, KV head) scales, laid
    end to end in f32: (B, nP * ps, K, d)."""
    tab = tables.long()
    deq = pages[tab].float() * scales[tab][:, :, None, :, None]
    return deq.reshape(tab.shape[0], -1, *pages.shape[2:])


def quant_paged_decode_attention_ref(
    q: torch.Tensor,         # (B, 1, H, d)
    k_pages: torch.Tensor,   # (P, ps, K, d) int8
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,  # (P, K) f32
    v_scales: torch.Tensor,
    tables: torch.Tensor,    # (B, nP) int32
    lengths: torch.Tensor,   # (B,) int32 in [1, nP * ps]
    new_rows: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Decode attention over int8 pages, each row ``int8 * scale`` in f32.
    ``new_rows = (k_new, v_new, new_pos)``, two (B, K, d) f32 rows and a
    (B,) int32 position, puts the current token's K/V in place of row
    ``new_pos[b]`` where that lies below ``lengths[b]``; without it this is
    the function of the TPU kernel."""
    k = _gather_dequantized(k_pages, k_scales, tables)
    v = _gather_dequantized(v_pages, v_scales, tables)
    if new_rows is not None:
        k_new, v_new, new_pos = new_rows
        rows = torch.arange(q.shape[0], device=q.device)
        idx = new_pos.long().clamp(max=k.shape[1] - 1)
        hit = (new_pos < lengths.clamp(max=k.shape[1]))[:, None, None]
        k[rows, idx] = torch.where(hit, k_new, k[rows, idx])
        v[rows, idx] = torch.where(hit, v_new, v[rows, idx])
    return decode_attention_ref(q, k, v, lengths)
