"""Parameters of the port's models (the dense GQA ``TransformerLM`` and the
Mamba2 ``MambaLM``): random init on the target device from a seeded
``torch.Generator``, and the bridge that takes the JAX package's own
parameter tree.

Layout: one tensor per weight with the layers stacked on a leading axis, as
the reference stacks them for its scan; dense kernels are stored
``(in, out)``.  Matmul weights and the tied embedding are stored in the
compute dtype (the reference keeps f32 masters and casts them to the
compute dtype at every use, which rounds the same way); norm scales and
the SSM's conv, decay, skip and dt-bias parameters stay f32, since the
reference casts each of them to f32 where it uses them.  Init is fan-in
scaled over ``shape[-2]``, the reference's convention
(``repro/models/params.py:57-68``); ``jax.random`` cannot be reproduced in
torch, so parity tests go through :func:`params_from_jax` instead.
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


def param_specs(cfg: ModelConfig) -> dict[str, Any]:
    if cfg.family == "ssm":
        return _mamba_specs(cfg)
    if cfg.family != "dense" or not cfg.tie_embeddings or not cfg.qk_norm:
        raise ValueError(
            f"{cfg.name}: the port serves dense, tied, qk-norm GQA and Mamba2"
        )
    n, d, dh, f = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hk = cfg.n_heads * dh, cfg.n_kv_heads * dh
    return {
        "embed": ((cfg.padded_vocab, d), "matrix"),
        "final_norm": ((d,), "ones"),
        "layers": {
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
            "mlp": {
                "wi": ((n, d, f), "matrix"),
                "wg": ((n, d, f), "matrix"),
                "wo": ((n, f, d), "matrix"),
            },
        },
    }


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

    def make(_path, spec: Spec) -> torch.Tensor:
        shape, kind = spec
        if kind in ("ones", "zeros"):
            fill = torch.ones if kind == "ones" else torch.zeros
            return fill(shape, dtype=torch.float32, device=device)
        std = 1.0 / math.sqrt(max(shape[-2], 1))
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(std).to(dtype if kind == "matrix" else torch.float32)

    return _map_specs(make, param_specs(cfg))


def _jax_path(path: tuple[str, ...], family: str) -> tuple[str, ...]:
    """A port leaf's path in the JAX model's tree: ``TransformerLM``'s
    (dense) or ``MambaLM``'s (ssm)."""
    if path == ("embed",):
        return ("embed", "table")
    if path == ("final_norm",):
        return ("final_norm", "scale")
    if family == "ssm":
        if path[-1] in ("ln", "norm"):
            return (*path, "scale")
        if path[-1] in ("wz", "wxBC", "wdt", "out_proj"):
            return (*path, "kernel")
        return path  # conv_w, conv_b, A_log, D, dt_bias: bare arrays
    inner = path[1:]  # drop "layers"
    leaf = "scale" if inner[-1] in ("ln1", "ln2", "q_norm", "k_norm") else "kernel"
    return ("dense_layers", *inner, leaf)


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
    ``(in, out)``, the tied embedding keeps its ``padded_vocab`` rows, and
    the qk-norm scales (dense) or the conv, decay, skip and dt-bias
    parameters (Mamba2) come across in f32 with the norm scales."""
    if "unembed" in tree or "moe_layers" in tree:
        raise ValueError(
            "only the dense and Mamba2 tied-embedding families are bridged"
        )

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
