"""Layers of the transformer: RMSNorm and LayerNorm, NeoX half-rotation
RoPE, the gated MLP (SwiGLU, or gemma's GeGLU) and the plain biased
two-layer MLP, dense projections
(with an optional bias), the embedding and the tied or untied unembedding.
Each follows the arithmetic of its ``repro/models/layers.py`` counterpart:
where the reference computes in f32 and rounds to the compute dtype, so
does this."""

from __future__ import annotations

import torch


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * scale.float()).to(dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with ``p["scale"]`` and ``p["bias"]``, in f32 (the
    population variance), rounded to x's dtype once at the end."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p["scale"].float() + p["bias"].float()).to(dtype)


def rope_cos_sin(
    positions: torch.Tensor,  # (..., S) integer positions
    head_dim: int,
    theta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (cos, sin) of shape (..., S, 1, head_dim/2), computed once per
    forward pass and shared by every layer's q and k."""
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    inv_freq = 1.0 / (theta**exponents)
    angles = positions.float()[..., :, None] * inv_freq
    angles = angles[..., None, :]  # broadcast over heads
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., S, heads, head_dim) in f32, NeoX half-rotation."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)
    return out.to(x.dtype)


def dense(
    w: torch.Tensor, x: torch.Tensor, b: torch.Tensor | None = None
) -> torch.Tensor:
    """``x @ w (+ b)`` for a kernel stored (in, out), in x's dtype: the bias
    is cast to it and added after the product, as the reference's
    ``layers.dense`` adds it."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(y.dtype)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    """The reference's activations.  ``jax.nn.gelu`` is the tanh
    approximation by default, and so is this one; the exact erf form
    differs from it by up to ~5e-4."""
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The plain two-layer MLP with biases (whisper's): ``wo(act(wi x + bi))
    + bo``."""
    return dense(p["wo"], activation(act, dense(p["wi"], x, p["bi"])), p["bo"])


def gated_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """``wo(act(wg x) * wi x)``: SwiGLU at ``act="silu"``, gemma's GeGLU
    (the tanh gelu) at ``"gelu"``."""
    h = activation(act, dense(p["wg"], x)) * dense(p["wi"], x)
    return dense(p["wo"], h)


def embed(
    table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    return table.to(dtype)[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Logits over the padded vocab through the tied table.  The product is
    rounded to the compute dtype before the cast to f32, as the reference
    does: that rounding decides argmax ties."""
    return (x.to(dtype) @ table.to(dtype).t()).float()


def untied_unembed(w: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Logits over the padded vocab through an untied ``(d, Vp)`` kernel,
    rounded to the compute dtype before the cast to f32, as the reference's
    ``dense(params["unembed"], x)`` is."""
    return dense(w, x.to(dtype)).float()
