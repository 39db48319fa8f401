"""The port's model families (``repro/models/model.py``): the
``TransformerLM`` of the dense and MoE families (GQA or MLA attention) and
of the VLM (gemma's decoder after a prefix of patch embeddings), the
pure-SSM ``MambaLM``, the zamba2 ``HybridLM`` (Mamba2 layers and one
shared attention block) and the whisper ``EncDecLM`` (an encoder over
frame embeddings and a decoder with cross-attention), each with a prefill
of one prompt into its cache and one decode step for every slot;
:func:`build_model` picks one by ``cfg.family``.

Three attention caches: the contiguous :class:`KVCache` (one row block per
slot), the :class:`PagedKVCache` (a pool of fixed-size pages that slots
reach through page tables, f32 or int8) and MLA's compressed
:class:`MLACache` (a latent and a rope key a token, contiguous only, as in
the reference); the enc-dec's :class:`EncDecCache` pairs a self
:class:`KVCache` with a cross one of ``encoder_seq`` rows a slot.  The full-precision caches are f32, as the reference's
serving caches are.  Caches are updated in place: the
reference returns a new cache from each call, the port writes the rows it
produces into the one it was given.

Every family also has the training path of the reference, ``forward(params,
batch, *, dtype)`` -> ``(logits_f32, aux)`` over the whole sequence:
differentiable plain torch (:func:`attention.naive_attention`,
:func:`ssm.mamba2_full`), no kernel, each block under the model's remat
policy (the constructor's ``remat``, as in the reference; see
:func:`remat_block`).  It casts the parameters to the compute dtype at each
use, so the f32 masters of training and the stored bf16 serving weights
give the same products.  A stacked leaf may also be given as the list of
its per-layer slices (what ``train.step`` differentiates).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
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
class MLACache:
    """MLA's per-slot compressed rows: the normed KV latent ``c_kv``
    (n_layers, n_slots, max_len, kv_lora_rank) and the rotated rope key
    ``k_rope`` (n_layers, n_slots, max_len, qk_rope_head_dim), f32."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.c_kv.shape[2]


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
    """Layer ``i``'s slice of the stacked parameter tree (a stacked tensor,
    or the list of its per-layer slices)."""
    return {k: _block(v, i) if isinstance(v, dict) else v[i] for k, v in p.items()}


#: the remat policies of the reference's ``_remat``
REMAT_POLICIES = ("none", "full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots``: keep the outputs of plain matrix products (every dense
    projection, the router, the unbatched SSD products) and recompute the
    rest, batched products included (attention's and the experts'), as
    ``dots_with_no_batch_dims_saveable`` keeps them."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _check_remat(policy: str) -> None:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")


def remat_block(fn, policy: str):
    """``fn`` under the reference's remat ``policy``: ``none`` keeps every
    activation, ``full`` recomputes the whole block in the backward pass
    (``torch.utils.checkpoint``, not reentrant), ``dots`` recomputes all
    but the plain matrix products (a selective checkpoint).  No policy
    changes a value."""
    _check_remat(policy)
    if policy == "none":
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False, **kw)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


class TransformerLM:
    """Pre-norm blocks, GQA or (``cfg.use_mla``) MLA attention: the dense
    stack (``params["layers"]``: every layer of the dense and VLM families,
    the ``first_k_dense`` leading layers of the MoE family), then the MoE
    stack (``params["moe_layers"]``), then the tied or untied
    (``params["unembed"]``) unembedding.  The cache's layer axis runs over
    both stacks in that order.  An MLA model keeps an :class:`MLACache`,
    which neither pages nor takes a suffix prefill, as in the reference.

    The VLM (paligemma): a prefill takes the request's ``patches``, (1,
    ``n_vision_tokens``, d_model) precomputed patch embeddings, and runs
    them, cast to the compute dtype and not scaled, before the prompt's
    token embeddings; its positions and cache rows run over the prefix and
    the prompt, and its attention is the prefix-LM mask (the patches see
    each other both ways).  With ``embed_scale`` every token embedding is
    multiplied by ``sqrt(d_model)`` rounded to the compute dtype first, as
    the reference does.  A VLM neither pages nor takes a suffix prefill."""

    def __init__(self, cfg: ModelConfig, *, remat: str = "dots"):
        if cfg.family == "vlm" and cfg.n_vision_tokens <= 0:
            raise ValueError(f"{cfg.name}: the vlm family needs n_vision_tokens > 0")
        _check_remat(remat)
        self.cfg = cfg
        self.remat = remat

    @staticmethod
    def _layers(params: dict):
        """(layer index, layer's parameters) over both stacks, in order."""
        i = 0
        for key in ("layers", "moe_layers"):
            stack = params.get(key)
            for j in range(0 if stack is None else len(stack["ln1"])):
                yield i, _block(stack, j)
                i += 1

    def _train_block(self, p: dict, x: torch.Tensor, rope, prefix_len: int):
        """One block over the whole sequence: (x, its MoE aux loss, 0 for
        a dense block)."""
        cfg = self.cfg
        h = layers.rms_norm(p["ln1"], x, cfg.norm_eps)
        if cfg.use_mla:
            a = attn.mla_full(p["attn"], cfg, h, rope)
        else:
            a = attn.gqa_full(p["attn"], cfg, h, rope, prefix_len=prefix_len)
        x = x + a
        h = layers.rms_norm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            y, aux = moe.moe_block(p["moe"], cfg, h, return_aux=True)
        else:
            y, aux = layers.gated_mlp(p["mlp"], h, cfg.act), _zero(x)
        return x + y, aux

    def forward(
        self,
        params: dict,
        batch: dict,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward (the reference's ``TransformerLM.forward``)
        over ``batch["tokens"]`` (B, S), after a VLM's ``batch["patches"]``
        (B, n_vision_tokens, d_model) under the prefix-LM mask: returns the
        f32 logits over every position, (B, P + S, Vp), and the sum of the
        MoE layers' Switch aux losses (0 without experts)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], dtype)
        prefix = 0
        if cfg.family == "vlm":
            patches = batch["patches"]
            x = torch.cat([patches.to(device=x.device, dtype=dtype), x], dim=1)
            prefix = patches.shape[1]
        rope = self._rope(torch.arange(x.shape[1], device=x.device)[None, :])
        body = remat_block(functools.partial(self._train_block, rope=rope,
                                             prefix_len=prefix),
                           self.remat)
        aux = _zero(x)
        for _, p in self._layers(params):
            x, a = body(p, x)
            aux = aux + a
        x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, x, dtype), aux

    def _mlp(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        if "moe" in p:
            return moe.moe_block(p["moe"], self.cfg, h)
        return layers.gated_mlp(p["mlp"], h, self.cfg.act)

    def _embed(self, params: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Token embeddings in ``dtype``, times ``sqrt(d_model)`` rounded to
        ``dtype`` where the config has ``embed_scale`` (bf16: 45.25 at d =
        2,048, not 45.2548)."""
        x = layers.embed(params["embed"], tokens, dtype)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=dtype)
        return x

    @staticmethod
    def _logits(params: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if "unembed" in params:
            return layers.untied_unembed(params["unembed"], x, dtype)
        return layers.unembed(params["embed"], x, dtype)

    def _rope(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """RoPE tables over the rotated width: the head's, or MLA's rope
        slice."""
        cfg = self.cfg
        width = cfg.qk_rope_head_dim if cfg.use_mla else cfg.head_dim
        return layers.rope_cos_sin(positions, width, cfg.rope_theta)

    def init_cache(
        self, n_slots: int, max_len: int, device: torch.device | str
    ) -> KVCache | MLACache:
        cfg = self.cfg
        if cfg.use_mla:
            lead = (cfg.n_layers, n_slots, max_len)
            return MLACache(
                c_kv=torch.zeros((*lead, cfg.kv_lora_rank), dtype=torch.float32,
                                 device=device),
                k_rope=torch.zeros((*lead, cfg.qk_rope_head_dim),
                                   dtype=torch.float32, device=device),
            )
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
        if cfg.use_mla:
            raise ValueError(f"{cfg.name}: an MLA cache does not page")
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
        cache: KVCache | PagedKVCache | MLACache,
        target: int | torch.Tensor,
        *,
        start: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        patches: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Run the prompt and return its last position's logits, (1, Vp)
        f32.  With a :class:`KVCache`, ``target`` is the slot whose rows
        ``0 .. S`` receive the prompt's K/V (a VLM's ``patches`` first:
        rows ``0 .. P + S``).  With a :class:`PagedKVCache`,
        ``target`` holds the prompt's page ids: its first ``start //
        page_size`` pages are a shared prefix already in the pool, and
        ``tokens`` is the suffix from position ``start`` on (suffix
        prefill); the suffix's K/V fill the remaining, fresh pages.  With an
        :class:`MLACache`, ``target`` is the slot whose rows ``0 .. S``
        receive the prompt's latents and rope keys."""
        cfg = self.cfg
        if tokens.dim() != 2 or tokens.shape[0] != 1:
            raise ValueError(f"prefill takes one prompt (1, S), got {tokens.shape}")
        if cfg.use_mla and start:
            raise ValueError("suffix prefill is not supported for MLA caches")
        vlm = cfg.family == "vlm"
        if vlm and start:
            raise ValueError("suffix prefill is not supported for VLM prompts")
        want = (1, cfg.n_vision_tokens, cfg.d_model)
        if vlm and (patches is None or tuple(patches.shape) != want):
            raise ValueError(f"{cfg.name}: a prefill needs the request's patches "
                             f"{want}, got "
                             f"{None if patches is None else tuple(patches.shape)}")
        if not vlm and patches is not None:
            raise ValueError(f"{cfg.name}: only the vlm family takes patches")
        prefix = cfg.n_vision_tokens if vlm else 0
        s = prefix + tokens.shape[1]
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
        rope = self._rope(positions)
        x = self._embed(params, tokens, dtype)
        if vlm:
            x = torch.cat([patches.to(device=x.device, dtype=dtype), x], dim=1)
        for i, p in self._layers(params):
            h = layers.rms_norm(p["ln1"], x, cfg.norm_eps)
            if cfg.use_mla:
                a = attn.mla_prefill(
                    p["attn"], cfg, h, cache.c_kv[i], cache.k_rope[i], target, rope
                )
            elif paged:
                a = attn.gqa_prefill_paged(
                    p["attn"], cfg, h, cache.layer(i), target, start, rope
                )
            else:
                a = attn.gqa_prefill(
                    p["attn"], cfg, h, cache.k[i], cache.v[i], target, rope,
                    prefix_len=prefix,
                )
            x = x + a
            h = layers.rms_norm(p["ln2"], x, cfg.norm_eps)
            # the MoE capacity follows the length of this call: a suffix
            # prefill routes the suffix alone, as the reference's does
            x = x + self._mlp(p, h)
        x = layers.rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return self._logits(params, x, dtype)[:, 0]

    def decode_step(
        self,
        params: dict,
        tokens: torch.Tensor,     # (B, 1) one new token per slot
        cache: KVCache | PagedKVCache | MLACache,
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
        rope = self._rope(positions[:, None])
        lengths = (positions + 1).clamp(max=max_len).to(torch.int32)
        new_pos = positions.to(torch.int32)
        x = self._embed(params, tokens, dtype)
        for i, p in self._layers(params):
            h = layers.rms_norm(p["ln1"], x, cfg.norm_eps)
            if cfg.use_mla:
                a = attn.mla_decode(
                    p["attn"], cfg, h, cache.c_kv[i], cache.k_rope[i], positions,
                    lengths, rope,
                )
            elif paged:
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
            x = x + self._mlp(p, h)
        x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, x, dtype)[:, 0]


class MambaLM:
    """Pure Mamba2 stack (the ssm family): a pre-norm residual Mamba2 block
    per layer and the tied unembedding.  Its cache is an :class:`SSMCache`,
    O(1) in the sequence length, so ``max_len`` sizes nothing."""

    def __init__(self, cfg: ModelConfig, *, remat: str = "dots"):
        _check_remat(remat)
        self.cfg = cfg
        self.remat = remat

    def forward(
        self,
        params: dict,
        batch: dict,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward (the reference's ``MambaLM.forward``): f32
        logits over every position of ``batch["tokens"]`` and an aux loss
        of 0."""
        cfg = self.cfg
        x = layers.embed(params["embed"], batch["tokens"], dtype)
        body = remat_block(
            lambda p, h: h + ssm.mamba2_full(p["mixer"], cfg,
                                             layers.rms_norm(p["ln"], h, cfg.norm_eps)),
            self.remat)
        for i in range(cfg.n_layers):
            x = body(_block(params["layers"], i), x)
        x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype), _zero(x)

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


class HybridLM:
    """zamba2 (the reference's ``HybridLM``): ``n_layers`` pre-norm Mamba2
    blocks in ``G = n_layers // shared_attn_every`` groups of ``K =
    shared_attn_every`` and a tail of the rest; after each group one
    *shared* transformer block (one set of weights) runs on the hidden
    state normed by that application's own gain, and its residual is
    ``h + (out - normed)``, as the reference adds it.  The embedding also
    unembeds.  Its cache is a :class:`HybridCache`: a KV cache per
    application and the Mamba2 state of every layer."""

    def __init__(self, cfg: ModelConfig, *, remat: str = "dots"):
        if cfg.shared_attn_every <= 0 or cfg.n_heads <= 0:
            raise ValueError(f"{cfg.name}: the hybrid family needs attention heads "
                             f"and shared_attn_every > 0")
        _check_remat(remat)
        self.cfg = cfg
        self.remat = remat
        self.k = cfg.shared_attn_every
        self.g = cfg.n_layers // self.k

    def init_cache(
        self, n_slots: int, max_len: int, device: torch.device | str
    ) -> "HybridCache":
        cfg = self.cfg
        shape = (self.g, n_slots, max_len, cfg.n_kv_heads, cfg.head_dim)
        kv = KVCache(k=torch.zeros(shape, dtype=torch.float32, device=device),
                     v=torch.zeros(shape, dtype=torch.float32, device=device))
        return HybridCache(kv=kv, ssm=MambaLM(cfg).init_cache(n_slots, 0, device))

    def shared_block(
        self, params: dict, g: int, x: torch.Tensor, attend
    ) -> torch.Tensor:
        """Application ``g`` of the shared block on ``x``; ``attend(p, h)``
        is its attention (``p`` the block's attention parameters) on the
        normed input ``h``."""
        cfg, p = self.cfg, params["shared_attn"]
        normed = layers.rms_norm(params["app_norms"][g], x, cfg.norm_eps)
        h = layers.rms_norm(p["ln1"], normed, cfg.norm_eps)
        out = normed + attend(p["attn"], h)
        h = layers.rms_norm(p["ln2"], out, cfg.norm_eps)
        out = out + layers.gated_mlp(p["mlp"], h, cfg.act)
        return x + (out - normed)

    def _stack(self, params: dict, x: torch.Tensor, mamba, attend) -> torch.Tensor:
        """Every Mamba2 block in order, ``x + mamba(i, p, normed)`` for
        layer ``i`` (groups, then the tail), and after each group the shared
        block, whose attention on its normed input is ``attend(g, p, h)``
        for application ``g``."""
        cfg = self.cfg

        def block(i: int, p: dict, x: torch.Tensor) -> torch.Tensor:
            return x + mamba(i, p, layers.rms_norm(p["ln"], x, cfg.norm_eps))

        for gi in range(self.g):
            group = _block(params["groups"], gi)
            for ki in range(self.k):
                x = block(gi * self.k + ki, _block(group, ki), x)
            x = self.shared_block(params, gi, x,
                                  lambda p, h, gi=gi: attend(gi, p, h))
        tail = params.get("tail")
        for ti in range(0 if tail is None else len(tail["ln"])):
            x = block(self.g * self.k + ti, _block(tail, ti), x)
        return x

    def forward(
        self,
        params: dict,
        batch: dict,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward (the reference's ``HybridLM.forward``): the
        Mamba2 blocks and the shared block's applications in serving's
        order, each under the remat policy; f32 logits over every position
        and an aux loss of 0."""
        cfg = self.cfg
        tokens = batch["tokens"]
        rope = layers.rope_cos_sin(torch.arange(tokens.shape[1], device=tokens.device)[None, :],
                                   cfg.head_dim, cfg.rope_theta)
        mamba = remat_block(
            lambda p, h: h + ssm.mamba2_full(p["mixer"], cfg,
                                             layers.rms_norm(p["ln"], h, cfg.norm_eps)),
            self.remat)
        shared = remat_block(
            lambda g, h: self.shared_block(
                params, g, h, lambda p, hh: attn.gqa_full(p, cfg, hh, rope)),
            self.remat)
        x = layers.embed(params["embed"], tokens, dtype)
        for gi in range(self.g):
            group = _block(params["groups"], gi)
            for ki in range(self.k):
                x = mamba(_block(group, ki), x)
            x = shared(gi, x)
        tail = params.get("tail")
        for ti in range(0 if tail is None else len(tail["ln"])):
            x = mamba(_block(tail, ti), x)
        x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype), _zero(x)

    def prefill(
        self,
        params: dict,
        tokens: torch.Tensor,  # (1, S) one prompt
        cache: "HybridCache",
        target: int,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Run the prompt and return its last position's logits, (1, Vp)
        f32.  Every piece of slot ``target``'s state is overwritten: each
        application's K/V rows ``0 .. S`` and each layer's conv window and
        SSD state."""
        cfg = self.cfg
        if tokens.dim() != 2 or tokens.shape[0] != 1:
            raise ValueError(f"prefill takes one prompt (1, S), got {tokens.shape}")
        s = tokens.shape[1]
        if s > cache.kv.max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {cache.kv.max_len}")
        positions = torch.arange(s, device=tokens.device)[None, :]
        rope = layers.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        kv, st = cache.kv, cache.ssm
        x = self._stack(
            params, layers.embed(params["embed"], tokens, dtype),
            lambda i, p, h: ssm.mamba2_prefill(p["mixer"], cfg, h, st.conv[i, target],
                                               st.state[i, target]),
            lambda g, p, h: attn.gqa_prefill(p, cfg, h, kv.k[g], kv.v[g], target,
                                             rope))
        x = layers.rms_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]

    def decode_step(
        self,
        params: dict,
        tokens: torch.Tensor,     # (B, 1) one new token per slot
        cache: "HybridCache",
        positions: torch.Tensor,  # (B,) position of the new token
        pages: PageTables | None = None,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Advance every slot by one token; returns (B, Vp) f32 logits."""
        if pages is not None:
            raise ValueError("a hybrid cache is not paged")
        cfg = self.cfg
        kv, st = cache.kv, cache.ssm
        rope = layers.rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
        lengths = (positions + 1).clamp(max=kv.max_len).to(torch.int32)
        x = self._stack(
            params, layers.embed(params["embed"], tokens, dtype),
            lambda i, p, h: ssm.mamba2_decode(p["mixer"], cfg, h, st.conv[i],
                                              st.state[i]),
            lambda g, p, h: attn.gqa_decode(p, cfg, h, kv.k[g], kv.v[g], positions,
                                            lengths, rope))
        x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]


@dataclasses.dataclass
class HybridCache:
    """A :class:`HybridLM`'s per-slot state: one f32 KV cache per shared
    block application, ``kv.k`` and ``kv.v`` (G, n_slots, max_len, K, dh),
    and every Mamba2 layer's conv window and SSD state (layers indexed
    group by group, then the tail)."""

    kv: KVCache
    ssm: SSMCache


@dataclasses.dataclass
class EncDecCache:
    """An :class:`EncDecLM`'s per-slot state: the decoder's self-attention
    rows ``self_kv`` (n_layers, n_slots, max_len, K, dh) and the cross rows
    ``cross`` (n_layers, n_slots, encoder_seq, K, dh) that a prefill
    projects from the encoder's output, both f32."""

    self_kv: KVCache
    cross: KVCache

    @property
    def max_len(self) -> int:
        return self.self_kv.max_len


class EncDecLM:
    """whisper (the reference's ``EncDecLM``): pre-LayerNorm encoder
    blocks over the frame embeddings plus learned positions (no causal
    mask, the frontend stubbed: a request brings its frames), then decoder
    blocks of causal self-attention, cross-attention over the encoder's
    output and the biased gelu MLP, over token embeddings plus learned
    positions; the embedding also unembeds.  Its prefill encodes the
    request's frames and fills the slot's cross rows whole and its self
    rows ``0 .. S``; its decode step attends over the self rows up to each
    slot's position and over every cross row."""

    def __init__(self, cfg: ModelConfig, *, remat: str = "dots"):
        if cfg.pos_emb != "learned":
            raise ValueError(f"{cfg.name}: the enc-dec family has learned positions")
        _check_remat(remat)
        self.cfg = cfg
        self.remat = remat

    def init_cache(
        self, n_slots: int, max_len: int, device: torch.device | str
    ) -> EncDecCache:
        cfg = self.cfg

        def kv(rows: int) -> KVCache:
            shape = (cfg.n_layers, n_slots, rows, cfg.n_kv_heads, cfg.head_dim)
            return KVCache(k=torch.zeros(shape, dtype=torch.float32, device=device),
                           v=torch.zeros(shape, dtype=torch.float32, device=device))

        return EncDecCache(self_kv=kv(max_len), cross=kv(cfg.encoder_seq))

    def encode(
        self,
        params: dict,
        frames: torch.Tensor,  # (1, encoder_seq, d_model) frame embeddings
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """The encoder's output (1, T, d_model) in the compute dtype."""
        cfg = self.cfg
        if frames.dim() != 3 or frames.shape[1:] != (cfg.encoder_seq, cfg.d_model):
            raise ValueError(
                f"frames must be (1, {cfg.encoder_seq}, {cfg.d_model}), got "
                f"{tuple(frames.shape)}")
        x = frames.to(dtype) + params["enc_pos"][: frames.shape[1]].to(dtype)
        for i in range(cfg.n_encoder_layers):
            p = _block(params["encoder"], i)
            h = layers.layer_norm(p["ln1"], x, cfg.norm_eps)
            x = x + attn.gqa_full_noncausal(p["attn"], cfg, h)
            h = layers.layer_norm(p["ln2"], x, cfg.norm_eps)
            x = x + layers.mlp(p["mlp"], h, cfg.act)
        return layers.layer_norm(params["enc_norm"], x, cfg.norm_eps)

    def forward(
        self,
        params: dict,
        batch: dict,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward (the reference's ``EncDecLM.forward``): the
        encoder over ``batch["frames"]`` (B, T, d_model) plus the learned
        positions, then the decoder over ``batch["tokens"]`` (B, S) with
        cross-attention over the encoder's output; every block under the
        remat policy.  f32 logits over every position and an aux loss of
        0."""
        cfg = self.cfg
        frames, tokens = batch["frames"], batch["tokens"]

        def enc_block(p, h):
            h = h + attn.gqa_full(p["attn"], cfg, layers.layer_norm(p["ln1"], h, cfg.norm_eps),
                                  None, causal=False)
            return h + layers.mlp(p["mlp"], layers.layer_norm(p["ln2"], h, cfg.norm_eps),
                                  cfg.act)

        def dec_block(p, h, enc_out):
            h = h + attn.gqa_full(p["attn"], cfg, layers.layer_norm(p["ln1"], h, cfg.norm_eps),
                                  None)
            kv = attn.gqa_project_kv(p["cross"], cfg, enc_out, None)
            h = h + attn.gqa_full(p["cross"], cfg,
                                  layers.layer_norm(p["ln_cross"], h, cfg.norm_eps), None,
                                  causal=False, kv=kv)
            return h + layers.mlp(p["mlp"], layers.layer_norm(p["ln2"], h, cfg.norm_eps),
                                  cfg.act)

        x = frames.to(dtype) + params["enc_pos"][: frames.shape[1]].to(dtype)
        body = remat_block(enc_block, self.remat)
        for i in range(cfg.n_encoder_layers):
            x = body(_block(params["encoder"], i), x)
        enc_out = layers.layer_norm(params["enc_norm"], x, cfg.norm_eps)
        x = (layers.embed(params["embed"], tokens, dtype)
             + params["dec_pos"][: tokens.shape[1]].to(dtype))
        body = remat_block(dec_block, self.remat)
        for i in range(cfg.n_layers):
            x = body(_block(params["decoder"], i), x, enc_out)
        x = layers.layer_norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype), _zero(x)

    def prefill(
        self,
        params: dict,
        tokens: torch.Tensor,  # (1, S) one prompt
        cache: EncDecCache,
        target: int,
        *,
        frames: torch.Tensor,  # (1, encoder_seq, d_model)
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Encode ``frames``, run the prompt through the decoder and return
        its last position's logits, (1, Vp) f32.  Slot ``target``'s cross
        rows are overwritten whole with this request's, its self rows ``0
        .. S`` with the prompt's K/V."""
        cfg = self.cfg
        if tokens.dim() != 2 or tokens.shape[0] != 1:
            raise ValueError(f"prefill takes one prompt (1, S), got {tokens.shape}")
        s = tokens.shape[1]
        if s > cache.max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {cache.max_len}")
        enc_out = self.encode(params, frames, dtype=dtype)
        x = layers.embed(params["embed"], tokens, dtype) + params["dec_pos"][:s].to(dtype)
        kv, cross = cache.self_kv, cache.cross
        for i in range(cfg.n_layers):
            p = _block(params["decoder"], i)
            h = layers.layer_norm(p["ln1"], x, cfg.norm_eps)
            x = x + attn.gqa_prefill(p["attn"], cfg, h, kv.k[i], kv.v[i], target, None)
            h = layers.layer_norm(p["ln_cross"], x, cfg.norm_eps)
            x = x + attn.cross_prefill(p["cross"], cfg, h, enc_out, cross.k[i],
                                       cross.v[i], target)
            h = layers.layer_norm(p["ln2"], x, cfg.norm_eps)
            x = x + layers.mlp(p["mlp"], h, cfg.act)
        x = layers.layer_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]

    def decode_step(
        self,
        params: dict,
        tokens: torch.Tensor,     # (B, 1) one new token per slot
        cache: EncDecCache,
        positions: torch.Tensor,  # (B,) position of the new token
        pages: PageTables | None = None,
        *,
        dtype: torch.dtype = torch.bfloat16,
    ) -> torch.Tensor:
        """Advance every slot by one token; returns (B, Vp) f32 logits."""
        if pages is not None:
            raise ValueError("an enc-dec cache is not paged")
        cfg = self.cfg
        kv, cross = cache.self_kv, cache.cross
        lengths = (positions + 1).clamp(max=kv.max_len).to(torch.int32)
        cross_len = torch.full_like(lengths, cross.max_len)
        x = (layers.embed(params["embed"], tokens, dtype)
             + params["dec_pos"][positions].to(dtype)[:, None])
        for i in range(cfg.n_layers):
            p = _block(params["decoder"], i)
            h = layers.layer_norm(p["ln1"], x, cfg.norm_eps)
            x = x + attn.gqa_decode(p["attn"], cfg, h, kv.k[i], kv.v[i], positions,
                                    lengths, None)
            h = layers.layer_norm(p["ln_cross"], x, cfg.norm_eps)
            x = x + attn.cross_decode(p["cross"], cfg, h, cross.k[i], cross.v[i],
                                      cross_len)
            h = layers.layer_norm(p["ln2"], x, cfg.norm_eps)
            x = x + layers.mlp(p["mlp"], h, cfg.act)
        x = layers.layer_norm(params["final_norm"], x, cfg.norm_eps)
        return layers.unembed(params["embed"], x, dtype)[:, 0]


def build_model(
    cfg: ModelConfig, *, remat: str = "dots"
) -> TransformerLM | MambaLM | HybridLM | EncDecLM:
    """The model of ``cfg.family``, as the reference's ``build_model``
    picks it, for the families the port serves (dense and MoE with GQA or
    MLA attention, SSM, hybrid, enc-dec, VLM); ``remat`` is its training
    forward's policy."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, remat=remat)
    if cfg.family == "ssm":
        return MambaLM(cfg, remat=remat)
    if cfg.family == "hybrid":
        return HybridLM(cfg, remat=remat)
    if cfg.family == "encdec":
        return EncDecLM(cfg, remat=remat)
    raise ValueError(f"the port does not serve the {cfg.family!r} family yet")
