"""Parameters of the port's models (the GQA ``TransformerLM`` of the dense
and MoE families and the Mamba2 ``MambaLM``): random init on the target
device from a seeded ``torch.Generator``, and the bridge that takes the JAX
package's own parameter tree.

Layout: one tensor per weight with the layers stacked on a leading axis, as
the reference stacks them for its scan (the MoE family's leading dense
layers in ``layers``, its MoE layers in ``moe_layers``); dense kernels are
stored ``(in, out)``, experts ``(E, in, out)``.  Matmul weights, experts and
the embeddings are stored in the compute dtype (the reference keeps f32
masters and casts them to the compute dtype at every use, which rounds the
same way); norm scales, the MoE router and the SSM's conv, decay, skip and
dt-bias parameters stay f32, since the reference casts each of them to f32
where it uses them.  Init is fan-in scaled over ``shape[-2]``, the
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


def _mlp_specs(n: int, d: int, f: int) -> dict[str, Spec]:
    return {"wi": ((n, d, f), "matrix"), "wg": ((n, d, f), "matrix"),
            "wo": ((n, f, d), "matrix")}


def _block_specs(cfg: ModelConfig, n: int, mlp: dict[str, Any]) -> dict[str, Any]:
    """A stack of ``n`` pre-norm blocks: GQA attention with qk-norm, then
    ``mlp`` (``{"mlp": ...}`` or ``{"moe": ...}``)."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hk = cfg.n_heads * dh, cfg.n_kv_heads * dh
    return {
        "ln1": ((n, d), "ones"),
        "attn": {
            "wq": ((n, d, hq), "matrix"),
            "wk": ((n, d, hk), "matrix"),
            "wv": ((n, d, hk), "matrix"),
            "wo": ((n, hq, d), "matrix"),
            "q_norm": ((n, dh), "ones"),
            "k_norm": ((n, dh), "ones"),
        },
        "ln2": ((n, d), "ones"),
        **mlp,
    }


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
        spec["shared"] = _mlp_specs(n, d, cfg.n_shared_experts * f)
    return spec


def param_specs(cfg: ModelConfig) -> dict[str, Any]:
    if cfg.family == "ssm":
        return _mamba_specs(cfg)
    if cfg.family not in ("dense", "moe") or not cfg.qk_norm:
        raise ValueError(
            f"{cfg.name}: the port serves qk-norm GQA (dense, MoE) and Mamba2"
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
        spec["layers"] = _block_specs(cfg, n_dense, {"mlp": _mlp_specs(
            n_dense, cfg.d_model, cfg.dense_d_ff or cfg.d_ff)})
    if n_moe:
        spec["moe_layers"] = _block_specs(cfg, n_moe, {"moe": _moe_specs(cfg, n_moe)})
    return spec


def _mamba_specs(cfg: ModelConfig) -> dict[str, Any]:
    """``MambaLM``'s tree: the tied embedding, a pre-norm and a Mamba2 mixer
    per layer (stacked), the final norm."""
    if not cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: the port serves tied-embedding Mamba2")
    n, d = cfg.n_layers, cfg.d_model
    mixer = {k: ((n, *shape), kind) for k, (shape, kind) in mamba2_specs(cfg).items()}
    return {
        "embed": ((cfg.padded_vocab, d), "matrix"),
        "final_norm": ((d,), "ones"),
        "layers": {"ln": ((n, d), "ones"), "mixer": mixer},
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

        if path[0] != "moe_layers":
            return draw(shape)
        # a layer at a time: one stacked expert leaf of full-width
        # qwen3-moe-30b-a3b is 38.7 GB in f32
        out = torch.empty(shape, dtype=out_dtype, device=device)
        for i in range(shape[0]):
            out[i] = draw(shape[1:])
        return out

    return _map_specs(make, param_specs(cfg))


def _jax_path(path: tuple[str, ...], family: str) -> tuple[str, ...]:
    """A port leaf's path in the JAX model's tree: ``TransformerLM``'s
    (dense, moe) or ``MambaLM``'s (ssm)."""
    if path == ("embed",):
        return ("embed", "table")
    if path == ("final_norm",):
        return ("final_norm", "scale")
    if path == ("unembed",):
        return ("unembed", "kernel")
    if family == "ssm":
        if path[-1] in ("ln", "norm"):
            return (*path, "scale")
        if path[-1] in ("wz", "wxBC", "wdt", "out_proj"):
            return (*path, "kernel")
        return path  # conv_w, conv_b, A_log, D, dt_bias: bare arrays
    stack = "dense_layers" if path[0] == "layers" else path[0]
    inner = path[1:]
    if inner[0] == "moe" and len(inner) == 2:
        return (stack, *inner)  # router and stacked experts: bare arrays
    leaf = "scale" if inner[-1] in ("ln1", "ln2", "q_norm", "k_norm") else "kernel"
    return (stack, *inner, leaf)


def params_from_jax(
    tree: dict,
    cfg: ModelConfig,
    *,
    device: torch.device | str,
    dtype: torch.dtype = torch.bfloat16,
) -> dict[str, Any]:
    """Convert the JAX package's ``TransformerLM`` or ``MambaLM``
    parameters, given as numpy arrays (``jax.tree.map(np.asarray,
    params)``), into the port's tree: layers stay stacked, kernels stay
    ``(in, out)``, the embedding keeps its ``padded_vocab`` rows, and the
    qk-norm scales and MoE router (dense, moe) or the conv, decay, skip and
    dt-bias parameters (Mamba2) come across in f32 with the norm scales."""

    def take(path, spec: Spec) -> torch.Tensor:
        node = tree
        for key in _jax_path(path, cfg.family):
            node = node[key]
        arr = np.array(node, np.float32)  # a writable copy for torch
        shape, kind = spec
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape} != {shape}")
        out_dtype = dtype if kind == "matrix" else torch.float32
        return torch.from_numpy(arr).to(device=device, dtype=out_dtype)

    return _map_specs(take, param_specs(cfg))
