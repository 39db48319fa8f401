"""Parameters of the port's models (the ``TransformerLM`` of the dense,
MoE and VLM families, with GQA or MLA attention, the Mamba2 ``MambaLM``, the
zamba2 ``HybridLM`` and the whisper ``EncDecLM``):
random init on the target device from a seeded ``torch.Generator``, and
the bridge that takes the JAX package's own parameter tree.

Layout: one tensor per weight with the layers stacked on a leading axis, as
the reference stacks them for its scan (the MoE family's leading dense
layers in ``layers``, its MoE layers in ``moe_layers``; the hybrid's
grouped Mamba2 layers ``(G, K, ...)`` in ``groups``, its unstacked
``shared_attn`` block, its ``tail``; the enc-dec's ``encoder`` and
``decoder`` stacks); dense kernels are stored ``(in, out)``, experts ``(E,
in, out)``, q/k/v biases as ``bq``, ``bk``, ``bv`` beside their kernels and
the plain MLP's as ``bi``, ``bo``; a LayerNorm is a ``{"scale", "bias"}``
pair, as in the reference's tree.  Matmul weights, experts and the embeddings are
stored in the compute dtype (the reference keeps f32 masters and casts
them to the compute dtype at every use, which rounds the same way); norm
scales, biases, the MoE router and the SSM's conv, decay, skip and dt-bias
parameters stay f32, since the reference casts each of them where it uses
them; so does MLA's ``wkv_b``, which the reference's absorbed decode reads
in f32 (its prefill casts it to the compute dtype).  Init is fan-in scaled over ``shape[-2]``, the
reference's convention (``repro/models/params.py:57-68``); ``jax.random``
cannot be reproduced in torch, so parity tests go through
:func:`params_from_jax` instead.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.ssm import mamba2_specs

#: leaf -> (shape, kind); kind "matrix" is a fan-in scaled normal in the
#: compute dtype, "f32" the same kept in f32, "ones" and "zeros" f32
#: constants (the reference's init kinds)
Spec = tuple[tuple[int, ...], str]

#: the most elements a leaf outside the MoE stacks draws at once in f32 (8
#: GiB); a larger one draws a slice of its leading axis at a time
WHOLE_DRAW = 2**31

#: the top-level keys whose leaves carry a layer axis first, as the specs
#: below lay them out: the transformer's ``layers`` and ``moe_layers``,
#: Mamba2's ``layers``, the hybrid's ``groups``, ``tail`` and per-group
#: ``app_norms``, the enc-dec's ``encoder`` and ``decoder``; every other
#: top-level key holds one unstacked leaf or block
STACKED = frozenset({"layers", "moe_layers", "groups", "tail", "app_norms",
                     "encoder", "decoder"})


def _mlp_specs(lead: tuple[int, ...], d: int, f: int) -> dict[str, Spec]:
    return {"wi": ((*lead, d, f), "matrix"), "wg": ((*lead, d, f), "matrix"),
            "wo": ((*lead, f, d), "matrix")}


def _mla_specs(cfg: ModelConfig, lead: tuple[int, ...]) -> dict[str, Spec]:
    """MLA attention (the reference's ``mla_specs``): the query through the
    ``q_lora_rank`` bottleneck (``wq_a``, ``q_a_norm``, ``wq_b``), or one
    ``wq`` where the rank is 0; the compressed KV with its rope slice
    (``wkv_a``), its norm and its decompression (``wkv_b``, kept f32);
    the output projection."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    spec: dict[str, Spec] = {}
    if qlr:
        spec.update(wq_a=((*lead, d, qlr), "matrix"), q_a_norm=((*lead, qlr), "ones"),
                    wq_b=((*lead, qlr, h * (nope + rope)), "matrix"))
    else:
        spec["wq"] = ((*lead, d, h * (nope + rope)), "matrix")
    spec.update(wkv_a=((*lead, d, kvlr + rope), "matrix"),
                kv_a_norm=((*lead, kvlr), "ones"),
                wkv_b=((*lead, kvlr, h * (nope + dv)), "f32"),
                wo=((*lead, h * dv, d), "matrix"))
    return spec


def _block_specs(cfg: ModelConfig, lead: tuple[int, ...],
                 mlp: dict[str, Any]) -> dict[str, Any]:
    """Pre-norm blocks stacked over ``lead`` (``(n,)``, or ``()`` for one
    block): MLA attention where ``cfg.use_mla``, else GQA attention, with
    q/k/v biases where ``cfg.qkv_bias`` and q/k norms where
    ``cfg.qk_norm``; then ``mlp`` (``{"mlp": ...}`` or ``{"moe": ...}``)."""
    d = cfg.d_model
    attn = _mla_specs(cfg, lead) if cfg.use_mla else _gqa_specs(cfg, lead)
    return {"ln1": ((*lead, d), "ones"), "attn": attn,
            "ln2": ((*lead, d), "ones"), **mlp}


def _gqa_specs(cfg: ModelConfig, lead: tuple[int, ...]) -> dict[str, Spec]:
    """GQA attention stacked over ``lead``: q, k, v and output projections,
    q/k/v biases where ``cfg.qkv_bias``, q/k norms where ``cfg.qk_norm``."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hk = cfg.n_heads * dh, cfg.n_kv_heads * dh
    attn: dict[str, Spec] = {
        "wq": ((*lead, d, hq), "matrix"),
        "wk": ((*lead, d, hk), "matrix"),
        "wv": ((*lead, d, hk), "matrix"),
        "wo": ((*lead, hq, d), "matrix"),
    }
    if cfg.qkv_bias:
        # the reference initialises biases to zeros
        attn.update(bq=((*lead, hq), "zeros"), bk=((*lead, hk), "zeros"),
                    bv=((*lead, hk), "zeros"))
    if cfg.qk_norm:
        attn.update(q_norm=((*lead, dh), "ones"), k_norm=((*lead, dh), "ones"))
    return attn


def _moe_specs(cfg: ModelConfig, n: int) -> dict[str, Any]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    spec: dict[str, Any] = {
        "router": ((n, d, e), "f32"),
        "wi": ((n, e, d, f), "matrix"),
        "wg": ((n, e, d, f), "matrix"),
        "wo": ((n, e, f, d), "matrix"),
    }
    if cfg.n_shared_experts:
        # one fused MLP of n_shared * moe_d_ff hidden, as the reference's
        spec["shared"] = _mlp_specs((n,), d, cfg.n_shared_experts * f)
    return spec


def param_specs(cfg: ModelConfig) -> dict[str, Any]:
    if cfg.family == "ssm":
        return _mamba_specs(cfg)
    if cfg.family == "hybrid":
        return _hybrid_specs(cfg)
    if cfg.family == "encdec":
        return _encdec_specs(cfg)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"{cfg.name}: the port serves dense and MoE (GQA or MLA), Mamba2, "
            f"hybrid, enc-dec and VLM"
        )
    n_moe = cfg.n_layers - cfg.first_k_dense if cfg.n_experts else 0
    n_dense = cfg.n_layers - n_moe
    spec: dict[str, Any] = {
        "embed": ((cfg.padded_vocab, cfg.d_model), "matrix"),
        "final_norm": ((cfg.d_model,), "ones"),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ((cfg.d_model, cfg.padded_vocab), "matrix")
    if n_dense:
        spec["layers"] = _block_specs(cfg, (n_dense,), {"mlp": _mlp_specs(
            (n_dense,), cfg.d_model, cfg.dense_d_ff or cfg.d_ff)})
    if n_moe:
        spec["moe_layers"] = _block_specs(cfg, (n_moe,),
                                          {"moe": _moe_specs(cfg, n_moe)})
    return spec


def _mamba_blocks(cfg: ModelConfig, lead: tuple[int, ...]) -> dict[str, Any]:
    """Pre-norm Mamba2 blocks stacked over ``lead``."""
    mixer = {k: ((*lead, *shape), kind)
             for k, (shape, kind) in mamba2_specs(cfg).items()}
    return {"ln": ((*lead, cfg.d_model), "ones"), "mixer": mixer}


def _mamba_specs(cfg: ModelConfig) -> dict[str, Any]:
    """``MambaLM``'s tree: the tied embedding, a pre-norm and a Mamba2 mixer
    per layer (stacked), the final norm."""
    if not cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: the port serves tied-embedding Mamba2")
    d = cfg.d_model
    return {
        "embed": ((cfg.padded_vocab, d), "matrix"),
        "final_norm": ((d,), "ones"),
        "layers": _mamba_blocks(cfg, (cfg.n_layers,)),
    }


def _hybrid_specs(cfg: ModelConfig) -> dict[str, Any]:
    """``HybridLM``'s tree, as the reference's ``HybridLM.param_specs`` lays
    it out: the embedding (which also unembeds, whatever
    ``tie_embeddings`` says), ``G = n_layers // shared_attn_every`` groups of
    ``K = shared_attn_every`` Mamba2 blocks stacked ``(G, K, ...)``, one
    shared transformer block, a norm gain per application ``(G, d)``, the
    final norm and a tail of the ``n_layers - G K`` remaining blocks."""
    d, k = cfg.d_model, cfg.shared_attn_every
    g = cfg.n_layers // k
    spec: dict[str, Any] = {
        "embed": ((cfg.padded_vocab, d), "matrix"),
        "groups": _mamba_blocks(cfg, (g, k)),
        "shared_attn": _block_specs(cfg, (), {"mlp": _mlp_specs((), d, cfg.d_ff)}),
        "app_norms": ((g, d), "ones"),
        "final_norm": ((d,), "ones"),
    }
    if cfg.n_layers - g * k:
        spec["tail"] = _mamba_blocks(cfg, (cfg.n_layers - g * k,))
    return spec


#: the reference's learned decoder positions (``repro/models/model.py:41``)
MAX_LEARNED_POS = 32_768


def _layer_norm(lead: tuple[int, ...], d: int) -> dict[str, Spec]:
    return {"scale": ((*lead, d), "ones"), "bias": ((*lead, d), "zeros")}


def _encdec_block(cfg: ModelConfig, n: int, cross: bool) -> dict[str, Any]:
    """Whisper's pre-LayerNorm blocks stacked over ``n``: self-attention
    with q/k/v biases, the biased two-layer MLP, and (the decoder) a
    cross-attention with its own norm, as the reference's
    ``_eblock_specs``."""
    d, f = cfg.d_model, cfg.d_ff
    spec: dict[str, Any] = {
        "ln1": _layer_norm((n,), d), "attn": _gqa_specs(cfg, (n,)),
        "ln2": _layer_norm((n,), d),
        "mlp": {"wi": ((n, d, f), "matrix"), "bi": ((n, f), "zeros"),
                "wo": ((n, f, d), "matrix"), "bo": ((n, d), "zeros")},
    }
    if cross:
        spec.update(ln_cross=_layer_norm((n,), d), cross=_gqa_specs(cfg, (n,)))
    return spec


def _encdec_specs(cfg: ModelConfig) -> dict[str, Any]:
    """``EncDecLM``'s tree, as the reference's ``EncDecLM.param_specs``: the
    tied embedding, learned encoder (``encoder_seq`` rows) and decoder
    (``MAX_LEARNED_POS`` rows) positions in the compute dtype, the encoder
    and decoder stacks, and their final LayerNorms."""
    d = cfg.d_model
    return {
        "embed": ((cfg.padded_vocab, d), "matrix"),
        "enc_pos": ((cfg.encoder_seq, d), "matrix"),
        "dec_pos": ((MAX_LEARNED_POS, d), "matrix"),
        "encoder": _encdec_block(cfg, cfg.n_encoder_layers, cross=False),
        "enc_norm": _layer_norm((), d),
        "decoder": _encdec_block(cfg, cfg.n_layers, cross=True),
        "final_norm": _layer_norm((), d),
    }


def _map_specs(fn, specs: dict, path: tuple[str, ...] = ()) -> dict:
    return {
        k: _map_specs(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
        for k, v in specs.items()
    }


def init_params(
    cfg: ModelConfig,
    seed: int,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """Random parameters made on ``device`` from ``torch.Generator(seed)``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(path, spec: Spec) -> torch.Tensor:
        shape, kind = spec
        if kind in ("ones", "zeros"):
            fill = torch.ones if kind == "ones" else torch.zeros
            return fill(shape, dtype=torch.float32, device=device)
        std = 1.0 / math.sqrt(max(shape[-2], 1))
        out_dtype = dtype if kind == "matrix" else torch.float32

        def draw(part: tuple[int, ...]) -> torch.Tensor:
            w = torch.randn(part, generator=gen, dtype=torch.float32, device=device)
            return w.mul_(std).to(out_dtype)

        if path[0] != "moe_layers" and math.prod(shape) <= WHOLE_DRAW:
            return draw(shape)
        # a layer at a time: one stacked expert leaf of full-width
        # qwen3-moe-30b-a3b is 38.7 GB in f32, qwen2.5-32b's MLP leaves 36
        out = torch.empty(shape, dtype=out_dtype, device=device)
        for i in range(shape[0]):
            out[i] = draw(shape[1:])
        return out

    return _map_specs(make, param_specs(cfg))


#: the port's bias leaves and the JAX kernels they belong to
_BIAS_OF = {"bq": "wq", "bk": "wk", "bv": "wv", "bi": "wi", "bo": "wo"}
_SCALES = ("ln", "norm", "ln1", "ln2", "q_norm", "k_norm", "app_norms",
           "q_a_norm", "kv_a_norm")
_SSM_KERNELS = ("wz", "wxBC", "wdt", "out_proj")


def _jax_path(path: tuple[str, ...], family: str) -> tuple[str, ...]:
    """A port leaf's path in the JAX model's tree: ``TransformerLM``'s
    (dense, moe, vlm), ``MambaLM``'s (ssm), ``HybridLM``'s (hybrid) or
    ``EncDecLM``'s (encdec, whose LayerNorm leaves keep their paths)."""
    if path in (("embed",), ("enc_pos",), ("dec_pos",)):
        return (path[0], "table")
    if family == "encdec" and path[-1] in ("scale", "bias"):
        return path
    if path == ("unembed",):
        return ("unembed", "kernel")
    if path[0] == "layers" and family in ("dense", "moe", "vlm"):
        path = ("dense_layers", *path[1:])
    leaf = path[-1]
    if leaf in _BIAS_OF:
        return (*path[:-1], _BIAS_OF[leaf], "bias")
    if leaf in _SCALES or path == ("final_norm",):
        return (*path, "scale")
    if path[-2] == "moe" or (path[-2] == "mixer" and leaf not in _SSM_KERNELS):
        # the router and stacked experts; conv_w, conv_b, A_log, D, dt_bias
        return path
    return (*path, "kernel")


def params_from_jax(
    tree: dict,
    cfg: ModelConfig,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """Convert the JAX package's ``TransformerLM`` (dense, MoE, VLM), ``MambaLM``,
    ``HybridLM`` or ``EncDecLM`` parameters, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into the port's tree: layers
    stay stacked (the hybrid's groups nested ``(G, K, ...)``), kernels stay
    ``(in, out)``, the embedding keeps its ``padded_vocab`` rows, and the
    q/k/v and MLP biases, qk-norm scales, MLA's ``wkv_b`` and MoE router or
    the conv, decay, skip and dt-bias parameters (Mamba2) come across in f32
    with the norm scales and biases.  Every leaf of ``tree`` must be taken:
    one the port has no place for (a bias it would drop, say) raises."""
    taken: set[tuple[str, ...]] = set()

    def take(path, spec: Spec) -> torch.Tensor:
        node = tree
        jpath = _jax_path(path, cfg.family)
        for key in jpath:
            node = node[key]
        taken.add(jpath)
        arr = np.array(node, np.float32)  # a writable copy for torch
        shape, kind = spec
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape} != {shape}")
        out_dtype = dtype if kind == "matrix" else torch.float32
        return torch.from_numpy(arr).to(device=device, dtype=out_dtype)

    out = _map_specs(take, param_specs(cfg))
    left = sorted("/".join(p) for p in _leaf_paths(tree) if p not in taken)
    if left:
        raise ValueError(f"{cfg.name}: JAX leaves the port does not take: {left}")
    return out


def _leaf_paths(tree: dict, path: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,)
