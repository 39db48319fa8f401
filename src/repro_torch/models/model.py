"""The port's model families (``repro/models/model.py``): the dense GQA
``TransformerLM`` and the pure-SSM ``MambaLM``, each with a prefill of one
prompt into its cache and one decode step for every slot; :func:`build_model`
picks one by ``cfg.family``.

Two caches: the contiguous :class:`KVCache` (one row block per slot) and
the :class:`PagedKVCache` (a pool of fixed-size pages that slots reach
through page tables, f32 or int8).  The full-precision caches are f32, as
the reference's serving caches are.  Caches are updated in place: the
reference returns a new cache from each call, the port writes the rows it
produces into the one it was given.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models.ssm import SSMCache


@dataclasses.dataclass
class KVCache:
    """Per-slot key and value rows, (n_layers, n_slots, max_len, K, dh) f32."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class PagedKVCache:
    """Page pools ``(n_layers, n_pages, page_size, K, dh)``, the reference's
    ``(P, ps, K, dh)`` pool layout with the layers stacked: f32, or int8
    with one f32 scale per (layer, page, KV head) in ``k_scale`` and
    ``v_scale``, ``(n_layers, n_pages, K)``.  The batcher keeps the last
    page as the trash page that free slots write to.  Pools start as zeros
    and scales as ones (a zero int8 page at scale 1.0 reads as exact 0)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "PagedKVCache":
        """Layer ``i``'s pools, (n_pages, page_size, K, dh), as views."""
        return PagedKVCache(
            self.k[i], self.v[i],
            None if self.k_scale is None else self.k_scale[i],
            None if self.v_scale is None else self.v_scale[i],
        )

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write of one page in every layer: bytes and scales
        verbatim, never a requantization."""
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                t[:, dst] = t[:, src]


@dataclasses.dataclass
class PageTables:
    """One decode step's paging: each slot's page table ``(B, nP)`` int32
    (free slots all zeros) and the pool page and row that receive its new
    K/V (the trash page for free slots), ``(B,)`` int64 each."""

    tables: torch.Tensor
    write_pages: torch.Tensor
    write_offsets: torch.Tensor


def _block(p: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked parameter tree."""
    return {k: _block(v, i) if isinstance(v, dict) else v[i] for k, v in p.items()}


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init_cache(
        self, n_slots: int, max_len: int, device: torch.device | str
    ) -> KVCache:
        cfg = self.cfg
        shape = (cfg.n_layers, n_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
        # zeros, not empty: a masked lane times NaN garbage would be NaN
        return KVCache(
            k=torch.zeros(shape, dtype=torch.float32, device=device),
            v=torch.zeros(shape, dtype=torch.float32, device=device),
        )

    def init_paged_cache(
        self,
        n_pages: int,
        page_size: int,
        device: torch.device | str,
        *,
        quantized: bool = False,
    ) -> PagedKVCache:
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        dtype = torch.int8 if quantized else torch.float32
        scales = (None, None)
        if quantized:
            s_shape = (cfg.n_layers, n_pages, cfg.n_kv_heads)
            scales = tuple(
                torch.ones(s_shape, dtype=torch.float32, device=device)
                for _ in range(2)
            )
        return PagedKVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            *scales,
        )

    def prefill(
        self,
        params: dict,
        tokens: torch.Tensor,  # (1, S) one prompt, or its suffix from ``start``
        cache: KVCache | PagedKVCache,
        target: int | torch.Tensor,
        *,
        start: int = 0,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Run the prompt and return its last position's logits, (1, Vp)
        f32.  With a :class:`KVCache`, ``target`` is the slot whose rows
        ``0 .. S`` receive the prompt's K/V.  With a :class:`PagedKVCache`,
        ``target`` holds the prompt's page ids: its first ``start //
        page_size`` pages are a shared prefix already in the pool, and
        ``tokens`` is the suffix from position ``start`` on (suffix
        prefill); the suffix's K/V fill the remaining, fresh pages."""
        cfg = self.cfg
        if tokens.dim() != 2 or tokens.shape[0] != 1:
            raise ValueError(f"prefill takes one prompt (1, S), got {tokens.shape}")
        s = tokens.shape[1]
        paged = isinstance(cache, PagedKVCache)
        if paged:
            if start % cache.page_size or start + s > len(target) * cache.page_size:
                raise ValueError(
                    f"start {start} and {s} tokens do not fit {len(target)} "
                    f"pages of {cache.page_size}"
                )
        elif start or s > cache.max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {cache.max_len}")
        positions = torch.arange(start, start + s, device=tokens.device)[None, :]
        rope = layers.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        x = layers.embed(params["embed"], tokens, dtype)
        for i in range(cfg.n_layers):
            p = _block(params["layers"], i)
            h = layers.rms_norm(p["ln1"], x, cfg.norm_eps)
            if paged:
                a = attn.gqa_prefill_paged(
                    p["attn"], cfg, h, cache.layer(i), target, start, rope
                )
            else:
                a = attn.gqa_prefill(
                    p["attn"], cfg, h, cache.k[i], cache.v[i], target, rope
                )
            x = x + a
            h = layers.rms_norm(p["ln2"], x, cfg.norm_eps)
            x = x + layers.gated_mlp(p["mlp"], h)
        x = layers.rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]

    def decode_step(
        self,
        params: dict,
        tokens: torch.Tensor,     # (B, 1) one new token per slot
        cache: KVCache | PagedKVCache,
        positions: torch.Tensor,  # (B,) position of the new token
        pages: PageTables | None = None,  # with a PagedKVCache
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Advance every slot by one token; returns (B, Vp) f32 logits.  A
        slot at position ``max_len`` (``nP * page_size`` when paged) keeps
        no new row and attends over all ``max_len`` rows, as in the
        reference."""
        cfg = self.cfg
        paged = isinstance(cache, PagedKVCache)
        if paged != (pages is not None):
            raise ValueError("a PagedKVCache needs PageTables, and only it")
        max_len = pages.tables.shape[1] * cache.page_size if paged else cache.max_len
        rope = layers.rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
        lengths = (positions + 1).clamp(max=max_len).to(torch.int32)
        new_pos = positions.to(torch.int32)
        x = layers.embed(params["embed"], tokens, dtype)
        for i in range(cfg.n_layers):
            p = _block(params["layers"], i)
            h = layers.rms_norm(p["ln1"], x, cfg.norm_eps)
            if paged:
                a = attn.gqa_decode_paged(
                    p["attn"], cfg, h, cache.layer(i), pages, new_pos, lengths, rope
                )
            else:
                a = attn.gqa_decode(
                    p["attn"], cfg, h, cache.k[i], cache.v[i], positions, lengths,
                    rope,
                )
            x = x + a
            h = layers.rms_norm(p["ln2"], x, cfg.norm_eps)
            x = x + layers.gated_mlp(p["mlp"], h)
        x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]


class MambaLM:
    """Pure Mamba2 stack (the ssm family): a pre-norm residual Mamba2 block
    per layer and the tied unembedding.  Its cache is an :class:`SSMCache`,
    O(1) in the sequence length, so ``max_len`` sizes nothing."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init_cache(
        self, n_slots: int, max_len: int, device: torch.device | str
    ) -> SSMCache:
        del max_len  # no sequence axis
        cfg = self.cfg
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        conv = (cfg.n_layers, n_slots, cfg.ssm_conv - 1, conv_dim)
        state = (cfg.n_layers, n_slots, cfg.ssm_nheads, cfg.ssm_head_dim,
                 cfg.ssm_state)
        return SSMCache(
            conv=torch.zeros(conv, dtype=torch.float32, device=device),
            state=torch.zeros(state, dtype=torch.float32, device=device),
        )

    def prefill(
        self,
        params: dict,
        tokens: torch.Tensor,  # (1, S) one prompt
        cache: SSMCache,
        target: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Run the prompt at its exact length and return its last
        position's logits, (1, Vp) f32; slot ``target``'s conv window and
        state are overwritten with the prompt's."""
        cfg = self.cfg
        if tokens.dim() != 2 or tokens.shape[0] != 1:
            raise ValueError(f"prefill takes one prompt (1, S), got {tokens.shape}")
        x = layers.embed(params["embed"], tokens, dtype)
        for i in range(cfg.n_layers):
            p = _block(params["layers"], i)
            h = layers.rms_norm(p["ln"], x, cfg.norm_eps)
            x = x + ssm.mamba2_prefill(
                p["mixer"], cfg, h, cache.conv[i, target], cache.state[i, target]
            )
        x = layers.rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]

    def decode_step(
        self,
        params: dict,
        tokens: torch.Tensor,     # (B, 1) one new token per slot
        cache: SSMCache,
        positions: torch.Tensor,  # unused: SSM decode is position-free
        pages: PageTables | None = None,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Advance every slot by one token; returns (B, Vp) f32 logits."""
        del positions
        if pages is not None:
            raise ValueError("an SSM cache is not paged")
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens, dtype)
        for i in range(cfg.n_layers):
            p = _block(params["layers"], i)
            h = layers.rms_norm(p["ln"], x, cfg.norm_eps)
            x = x + ssm.mamba2_decode(p["mixer"], cfg, h, cache.conv[i], cache.state[i])
        x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]


def build_model(cfg: ModelConfig) -> TransformerLM | MambaLM:
    """The model of ``cfg.family``, as the reference's ``build_model``
    picks it, for the families the port serves."""
    if cfg.family == "dense":
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        return MambaLM(cfg)
    raise ValueError(f"the port does not serve the {cfg.family!r} family yet")
