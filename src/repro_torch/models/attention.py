"""Attention blocks of the transformer (``repro/models/attention.py``).
GQA: q, k and v projections with a bias where the config has ``qkv_bias``
(``bq``, ``bk``, ``bv``), RMS norms of q and k where it has ``qk_norm``,
then RoPE (none where ``rope`` is None: whisper's learned positions).
Enc-dec (whisper): the encoder's self-attention over the frames and the
decoder's cross-attention over the encoder's output are GQA without a
causal mask; the cross K/V are projected once a prompt into the slot's f32
cross cache, and a decode step attends over all of its rows.  MLA (multi-head latent attention, minicpm3 and deepseek-v2):
the query through a low-rank bottleneck, keys and values compressed into
one normed latent per token beside a shared rope key; prefill decompresses
them and runs the flash kernel with Q and K of width ``nope + rope`` and V
of width ``v_head_dim``, decode keeps the cache compressed and attends in
the latent space (the reference's absorbed form, in f32).

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

Training runs none of the kernels (they have no backward): its
differentiable full-sequence attention is :func:`naive_attention`, the
reference's ``naive_attention`` in plain torch under
:func:`make_causal_mask`, at every length (where the reference's training
takes its chunked path from 512 tokens on), through :func:`gqa_full`
(self-attention, causal or not, the prefix-LM mask, cross-attention over
given K/V) and :func:`mla_full` (MLA decompressed).
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
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import layers


#: RoPE's (cos, sin) tables, or None where the model has no rotary positions
Rope = tuple[torch.Tensor, torch.Tensor] | None


def make_causal_mask(sq: int, sk: int, prefix_len: int = 0, q_offset: int = 0,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """(Sq, Sk) bool: query ``i`` at position ``q_offset + i`` sees key ``j``
    where ``j <= q_offset + i``, or where both lie in the first
    ``prefix_len`` positions (the prefix-LM mask)."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=device)[None, :]
    visible = q_pos >= k_pos
    if prefix_len:
        visible = visible | ((q_pos < prefix_len) & (k_pos < prefix_len))
    return visible


def naive_attention(
    q: torch.Tensor,            # (B, Sq, H, dh)
    k: torch.Tensor,            # (B, Sk, K, dh)
    v: torch.Tensor,            # (B, Sk, K, dv)
    mask: torch.Tensor | None,  # broadcastable to (B, K, G, Sq, Sk)
    scale: float,
) -> torch.Tensor:
    """Grouped attention over the whole score matrix, differentiable: the
    scores in f32, masked to ``NEG_INF``, softmaxed, the probabilities cast
    to v's dtype for the product with v, the output in q's dtype, as the
    reference's ``naive_attention``.  Query head ``h`` reads KV head ``h //
    G``."""
    b, sq, h, dh = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, sq, kheads, h // kheads, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, -1).to(q.dtype)


def gqa_project_q(p: dict, cfg: ModelConfig, x: torch.Tensor, rope: Rope) -> torch.Tensor:
    b, s, _ = x.shape
    q = layers.dense(p["wq"], x, p.get("bq")).view(b, s, cfg.n_heads, cfg.head_dim)
    if "q_norm" in p:
        q = layers.rms_norm(p["q_norm"], q, cfg.norm_eps)
    return q if rope is None else layers.apply_rope(q, *rope)


def gqa_project_kv(
    p: dict, cfg: ModelConfig, x: torch.Tensor, rope: Rope
) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    k = layers.dense(p["wk"], x, p.get("bk")).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = layers.dense(p["wv"], x, p.get("bv")).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    if "k_norm" in p:
        k = layers.rms_norm(p["k_norm"], k, cfg.norm_eps)
    return (k if rope is None else layers.apply_rope(k, *rope)), v


def gqa_prefill(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,        # (1, S, D) hidden states of one prompt
    k_cache: torch.Tensor,  # (n_slots, max_len, K, dh) f32, this layer
    v_cache: torch.Tensor,
    slot: int,
    rope: Rope,
    *,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Causal self-attention over the prompt, under the prefix-LM mask
    where ``prefix_len`` > 0 (a VLM's patch positions see each other both
    ways).  Its K/V rows are written straight into rows ``0 .. S`` of
    ``slot`` in the f32 cache, in place."""
    b, s, _ = x.shape
    q = gqa_project_q(p, cfg, x, rope)
    k, v = gqa_project_kv(p, cfg, x, rope)
    k_cache[slot, :s] = k[0]
    v_cache[slot, :s] = v[0]
    out = flash_attention_bshd(q, k, v, prefix_len=prefix_len)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def gqa_full(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,   # (B, S, D)
    rope: Rope,
    *,
    causal: bool = True,
    prefix_len: int = 0,
    kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Full-sequence attention for training (the reference's ``gqa_full``
    with ``impl="naive"``): self-attention over ``x``, causal (under the
    prefix-LM mask where ``prefix_len`` > 0) or not, or cross-attention
    over the given ``kv``; differentiable, no kernel."""
    b, s, _ = x.shape
    q = gqa_project_q(p, cfg, x, rope)
    k, v = gqa_project_kv(p, cfg, x, rope) if kv is None else kv
    mask = make_causal_mask(s, k.shape[1], prefix_len, device=x.device) if causal else None
    out = naive_attention(q, k, v, mask, cfg.head_dim**-0.5)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def cache_update(
    cache: torch.Tensor,      # (B, S, ...), updated in place
    new: torch.Tensor,        # (B, 1, ...)
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
    keep = (positions < s).view(-1, *(1,) * (new.dim() - 2))
    cache[rows, idx] = torch.where(keep, new[:, 0].to(cache.dtype), cache[rows, idx])


def gqa_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, 1, D)
    k_cache: torch.Tensor,    # (B, max_len, K, dh) f32, this layer
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # (B,) position of the new token
    lengths: torch.Tensor,    # (B,) int32 rows to attend: min(position+1, max_len)
    rope: Rope,
) -> torch.Tensor:
    b = x.shape[0]
    q = gqa_project_q(p, cfg, x, rope)
    k_new, v_new = gqa_project_kv(p, cfg, x, rope)
    cache_update(k_cache, k_new, positions)
    cache_update(v_cache, v_new, positions)
    out = decode_attention_bshd(q, k_cache, v_cache, lengths)
    return layers.dense(p["wo"], out.reshape(b, 1, -1))


# -- enc-dec (whisper): no rotary positions, no causal mask across ----------------


def gqa_full_noncausal(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The encoder's self-attention: every frame sees every frame (the
    flash kernel without the causal mask)."""
    b, s, _ = x.shape
    q = gqa_project_q(p, cfg, x, None)
    k, v = gqa_project_kv(p, cfg, x, None)
    out = flash_attention_bshd(q, k, v, causal=False)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def cross_prefill(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,        # (1, S, D) the prompt's hidden states, normed
    enc_out: torch.Tensor,  # (1, T, D) the encoder's output
    k_cache: torch.Tensor,  # (n_slots, T, K, dh) f32, this layer's cross cache
    v_cache: torch.Tensor,
    slot: int,
) -> torch.Tensor:
    """Cross-attention over the prompt: K/V projected from the encoder's
    output (with their biases) in the compute dtype, stored whole into
    ``slot``'s cross rows in f32 (the reference's ``ck.astype`` of the
    cache), and every query attends over all T of them (the flash kernel,
    not causal)."""
    b, s, _ = x.shape
    ck, cv = gqa_project_kv(p, cfg, enc_out, None)
    k_cache[slot] = ck[0]
    v_cache[slot] = cv[0]
    q = gqa_project_q(p, cfg, x, None)
    out = flash_attention_bshd(q, ck, cv, causal=False)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def cross_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,        # (B, 1, D) normed
    k_cache: torch.Tensor,  # (B, T, K, dh) f32, this layer's cross cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32, T for every slot
) -> torch.Tensor:
    """One token a slot over all T cross rows: the reference's unmasked
    ``naive_attention`` over the f32 cross cache, which is the decode
    kernel at ``lengths = T``."""
    b = x.shape[0]
    q = gqa_project_q(p, cfg, x, None)
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


# -- MLA (minicpm3, deepseek-v2): one layer's compressed cache, c_kv (n_slots,
# max_len, kv_lora_rank) and k_rope (n_slots, max_len, qk_rope_head_dim) f32 --


def mla_q(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The query, (B, S, H, nope + rope), before the rope: through the
    ``q_lora_rank`` bottleneck and its norm, or one projection."""
    b, s, _ = x.shape
    if "wq_a" in p:
        cq = layers.rms_norm(p["q_a_norm"], layers.dense(p["wq_a"], x), cfg.norm_eps)
        q = layers.dense(p["wq_b"], cq)
    else:
        q = layers.dense(p["wq"], x)
    return q.view(b, s, cfg.n_heads, -1)


def mla_ckv(
    p: dict, cfg: ModelConfig, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The normed KV latent (B, S, kv_lora_rank) and the rotated rope key
    shared by every head (B, S, qk_rope_head_dim), from one projection."""
    c_kv, k_rope = layers.dense(p["wkv_a"], x).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = layers.rms_norm(p["kv_a_norm"], c_kv, cfg.norm_eps)
    return c_kv, layers.apply_rope(k_rope[:, :, None, :], *rope)[:, :, 0]


def _mla_q_parts(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 rope: tuple[torch.Tensor, torch.Tensor]):
    q_nope, q_rope = mla_q(p, cfg, x).split(
        [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, layers.apply_rope(q_rope, *rope)


def _mla_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
             rope: tuple[torch.Tensor, torch.Tensor]):
    """MLA's decompressed Q (B, S, H, nope + rope), K (each head's
    ``k_nope`` with the shared rope key after it) and V (B, S, H, dv), and
    the latent and rope key they came from."""
    b, s, _ = x.shape
    h, nope, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q_parts(p, cfg, x, rope)
    c_kv, k_rope = mla_ckv(p, cfg, x, rope)
    k_nope, v = layers.dense(p["wkv_b"], c_kv).view(b, s, h, nope + dv).split(
        [nope, dv], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, c_kv, k_rope


def mla_prefill(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,         # (1, S, D) hidden states of one prompt
    c_cache: torch.Tensor,   # (n_slots, max_len, kv_lora_rank) f32, this layer
    r_cache: torch.Tensor,   # (n_slots, max_len, qk_rope_head_dim) f32
    slot: int,
    rope: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Causal MLA over the prompt in the decompressed form (the reference's
    ``mla_full``): K is each head's ``k_nope`` with the shared rope key
    after it, V each head's value, both from ``wkv_b`` applied to the
    latent; the flash kernel takes Q and K of width ``nope + rope`` and V
    of width ``v_head_dim``, at scale ``(nope + rope) ** -0.5``.  The
    latent and the rope key go to rows ``0 .. S`` of ``slot``, in place."""
    b, s, _ = x.shape
    q, k, v, c_kv, k_rope = _mla_qkv(p, cfg, x, rope)
    c_cache[slot, :s] = c_kv[0]
    r_cache[slot, :s] = k_rope[0]
    out = flash_attention_bshd(q, k, v)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def mla_full(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    rope: tuple[torch.Tensor, torch.Tensor],
    *,
    causal: bool = True,
) -> torch.Tensor:
    """MLA over the whole sequence for training, decompressed as in
    :func:`mla_prefill` (the reference's ``mla_full`` with
    ``impl="naive"``), through :func:`naive_attention`: differentiable, no
    kernel."""
    b, s, _ = x.shape
    q, k, v, _, _ = _mla_qkv(p, cfg, x, rope)
    mask = make_causal_mask(s, s, device=x.device) if causal else None
    out = naive_attention(q, k, v, mask, (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5)
    return layers.dense(p["wo"], out.reshape(b, s, -1))


def mla_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,          # (B, 1, D)
    c_cache: torch.Tensor,    # (B, max_len, kv_lora_rank) f32, this layer
    r_cache: torch.Tensor,    # (B, max_len, qk_rope_head_dim) f32
    positions: torch.Tensor,  # (B,) position of the new token
    lengths: torch.Tensor,    # (B,) rows to attend: min(position+1, max_len)
    rope: tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """One token a slot in the absorbed form of the reference's
    ``mla_decode``, in f32: the new latent and rope key are written at each
    slot's position; ``wkv_b`` viewed (kv_lora, H, nope + dv) gives ``W_uk``
    and ``W_uv``; the scores are ``(q_nope W_uk) c_kv^T + q_rope
    k_rope^T``, scaled, masked past each slot's length and softmaxed; the
    output is ``(p c_kv) W_uv``, cast back and projected by ``wo``."""
    b = x.shape[0]
    h, nope, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q_parts(p, cfg, x, rope)
    c_new, r_new = mla_ckv(p, cfg, x, rope)
    cache_update(c_cache, c_new, positions)
    cache_update(r_cache, r_new, positions)
    w = p["wkv_b"].float().view(cfg.kv_lora_rank, h, nope + dv)
    w_uk, w_uv = w[:, :, :nope], w[:, :, nope:]
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, 0].float(), w_uk)
    scores = (torch.einsum("bhl,bsl->bhs", q_lat, c_cache)
              + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), r_cache))
    scores = scores * (nope + cfg.qk_rope_head_dim) ** -0.5
    valid = torch.arange(c_cache.shape[1], device=x.device)[None, :] < lengths[:, None]
    probs = torch.softmax(torch.where(valid[:, None, :], scores, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", probs, c_cache)
    out = torch.einsum("bhl,lhv->bhv", o_lat, w_uv).to(x.dtype)
    return layers.dense(p["wo"], out.reshape(b, 1, -1))
