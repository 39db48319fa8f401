"""GQA attention block of the dense transformer (the GQA path of
``repro/models/attention.py``).

Prefill runs the port's flash kernel at every prompt length: it is exact
attention.  (The reference's ``chunked_attention``, which its prefill takes
from 512 tokens on, scrambles query rows when it uses more than one q-block;
the port is held against the reference's exact attention instead.)  Decode
runs the port's decode kernel over the contiguous f32 cache, or a paged
decode kernel over the f32 or int8 page pool.

The paged functions follow the reference's paged batcher
(``repro/serve/scheduler.py``): suffix prefill reads the shared prefix
pages back in the compute dtype (int8 pages dequantized in f32 first) and
writes only the fresh pages; paged decode stores each slot's new f32 row
and attends through the page tables.  On the int8 pool the token attends
to its own K/V at full precision, and only then is its write page
requantized, from its valid rows, as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_bshd,
    paged_decode_attention_bshd,
    quant_paged_decode_attention_bshd,
)
from repro_torch.kernels.decode_attention.quant import (
    absmax_dequantize,
    absmax_quantize,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.models import layers


def gqa_project_q(
    p: dict, cfg: ModelConfig, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    b, s, _ = x.shape
    q = layers.dense(p["wq"], x).view(b, s, cfg.n_heads, cfg.head_dim)
    q = layers.rms_norm(p["q_norm"], q, cfg.norm_eps)
    return layers.apply_rope(q, *rope)


def gqa_project_kv(
    p: dict, cfg: ModelConfig, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    k = layers.dense(p["wk"], x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = layers.dense(p["wv"], x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    k = layers.rms_norm(p["k_norm"], k, cfg.norm_eps)
    return layers.apply_rope(k, *rope), v


def gqa_prefill(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,        # (1, S, D) hidden states of one prompt
    k_cache: torch.Tensor,  # (n_slots, max_len, K, dh) f32, this layer
    v_cache: torch.Tensor,
    slot: int,
    rope: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Causal self-attention over the prompt.  Its K/V rows are written
    straight into rows ``0 .. S`` of ``slot`` in the f32 cache, in place."""
    b, s, _ = x.shape
    q = gqa_project_q(p, cfg, x, rope)
    k, v = gqa_project_kv(p, cfg, x, rope)
    k_cache[slot, :s] = k[0]
    v_cache[slot, :s] = v[0]
    out = flash_attention_bshd(q, k, v)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def cache_update(
    cache: torch.Tensor,      # (B, S, K, dh), updated in place
    new: torch.Tensor,        # (B, 1, K, dh)
    positions: torch.Tensor,  # (B,)
) -> None:
    """Write each row's new token at its position, in place.  Like the
    reference's masked select, a row whose position is ``S`` (a stale free
    slot that ran its request to ``max_len``) writes nothing: its store goes
    to a clamped row and puts back the value already there, so no index ever
    reaches ``S``."""
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = positions.clamp(max=s - 1)
    keep = (positions < s)[:, None, None]
    cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, idx])


def gqa_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, 1, D)
    k_cache: torch.Tensor,    # (B, max_len, K, dh) f32, this layer
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # (B,) position of the new token
    lengths: torch.Tensor,    # (B,) int32 rows to attend: min(position+1, max_len)
    rope: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    b = x.shape[0]
    q = gqa_project_q(p, cfg, x, rope)
    k_new, v_new = gqa_project_kv(p, cfg, x, rope)
    cache_update(k_cache, k_new, positions)
    cache_update(v_cache, v_new, positions)
    out = decode_attention_bshd(q, k_cache, v_cache, lengths)
    return layers.dense(p["wo"], out.reshape(b, 1, -1))


# -- the page pool (one layer of a PagedKVCache: pools (P, ps, K, dh)) ---------


def read_prefix(pool: torch.Tensor, scale: torch.Tensor | None,
                pages: torch.Tensor) -> torch.Tensor:
    """The shared prefix pages laid end to end, (1, n * ps, K, dh) f32; int8
    pages are dequantized with their (page, KV head) scales."""
    rows = pool[pages]
    if scale is not None:
        rows = absmax_dequantize(rows, scale[pages], (1, 3))
    return rows.reshape(1, -1, *pool.shape[2:])


def write_fresh_pages(pool: torch.Tensor, scale: torch.Tensor | None,
                      pages: torch.Tensor, new: torch.Tensor) -> None:
    """Store a prompt suffix's K or V, (1, s, K, dh), into its fresh pages,
    zeros past the last row.  int8 pages are quantized on the way, one
    scale per page and KV head; the zero rows change neither the absmax
    nor a stored byte, which is the reference's mask of the rows past the
    prompt."""
    n, ps = pages.numel(), pool.shape[1]
    rows = torch.zeros((n * ps, *pool.shape[2:]), dtype=torch.float32,
                       device=pool.device)
    rows[: new.shape[1]] = new[0]
    rows = rows.view(n, ps, *pool.shape[2:])
    if scale is None:
        pool[pages] = rows
    else:
        pool[pages], scale[pages] = absmax_quantize(rows, (1, 3))


def requantize_write_pages(
    pool: torch.Tensor,       # (P, ps, K, dh) int8, updated in place
    scale: torch.Tensor,      # (P, K) f32, updated in place
    new: torch.Tensor,        # (B, K, dh) f32 each slot's new row
    pages: torch.Tensor,      # (B,) write page per slot
    offsets: torch.Tensor,    # (B,) row of the new token in it
) -> None:
    """Requantize each slot's whole write page from its dequantized rows
    with the new row put in, rows past the new one masked out: the f32
    operations of the reference's ``absmax_quantize`` on its decode view."""
    ps = pool.shape[1]
    rows = absmax_dequantize(pool[pages], scale[pages], (1, 3))
    slots = torch.arange(pages.shape[0], device=pool.device)
    rows[slots, offsets] = new
    valid = torch.arange(ps, device=pool.device)[None, :] <= offsets[:, None]
    pool[pages], scale[pages] = absmax_quantize(
        rows, (1, 3), mask=valid[:, :, None, None]
    )


def gqa_prefill_paged(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,      # (1, s, D) hidden states of the prompt from ``start``
    pool,                 # one layer of a PagedKVCache
    pages: torch.Tensor,  # the prompt's page ids, shared prefix first
    start: int,           # shared prefix length, a whole number of pages
    rope: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Suffix prefill: queries at positions ``start .. start + s`` attend
    over the shared prefix read from the pool and the fresh suffix K/V
    (the flash kernel with ``q_offset=start``); the suffix's K/V go to the
    fresh pages."""
    b, s, _ = x.shape
    q = gqa_project_q(p, cfg, x, rope)
    k, v = gqa_project_kv(p, cfg, x, rope)
    n_shared = start // pool.page_size
    k_ctx, v_ctx = k, v
    if start:
        shared = pages[:n_shared]
        k_ctx = torch.cat([read_prefix(pool.k, pool.k_scale, shared).to(k.dtype), k], 1)
        v_ctx = torch.cat([read_prefix(pool.v, pool.v_scale, shared).to(v.dtype), v], 1)
    fresh = pages[n_shared:]
    write_fresh_pages(pool.k, pool.k_scale, fresh, k)
    write_fresh_pages(pool.v, pool.v_scale, fresh, v)
    out = flash_attention_bshd(q, k_ctx, v_ctx, q_offset=start)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def gqa_decode_paged(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, 1, D)
    pool,                     # one layer of a PagedKVCache
    pages,                    # the step's PageTables
    new_pos: torch.Tensor,    # (B,) int32 position of the new token
    lengths: torch.Tensor,    # (B,) int32 positions to attend
    rope: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """One decode step over the page pool.  f32 pool: store each slot's
    new row at its write target, then attend through the tables (the
    reference's gather, write, attend).  int8 pool: attend with the new
    rows in f32 in place of their pool rows, then requantize the write
    pages."""
    b = x.shape[0]
    q = gqa_project_q(p, cfg, x, rope)
    k_new, v_new = gqa_project_kv(p, cfg, x, rope)
    k_new, v_new = k_new[:, 0].float(), v_new[:, 0].float()
    wp, wo = pages.write_pages, pages.write_offsets
    if pool.k_scale is None:
        pool.k[wp, wo] = k_new
        pool.v[wp, wo] = v_new
        out = paged_decode_attention_bshd(q, pool.k, pool.v, pages.tables, lengths)
    else:
        out = quant_paged_decode_attention_bshd(
            q, pool.k, pool.v, pool.k_scale, pool.v_scale, pages.tables,
            lengths, (k_new, v_new, new_pos),
        )
        requantize_write_pages(pool.k, pool.k_scale, k_new, wp, wo)
        requantize_write_pages(pool.v, pool.v_scale, v_new, wp, wo)
    return layers.dense(p["wo"], out.reshape(b, 1, -1))
