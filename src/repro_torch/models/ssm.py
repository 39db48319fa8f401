"""Mamba2 (SSD, state-space duality) blocks: the port of
``repro/models/ssm.py``.

Prefill runs the chunked SSD scan (the hand-written kernel on the card,
:func:`ssd_chunked` on the CPU); training's :func:`mamba2_full` runs
:func:`ssd_chunked` everywhere, since the kernel has no backward; decode is the O(1) recurrent step on a
(B, H, P, N) state, in plain PyTorch.  B and C stay per group, (B, L, G,
N), all the way into the scan: head ``h`` reads group ``h // (H / G)``,
which is what the reference's ``jnp.repeat`` over heads computes without
the copy (80 heads on one group at full width).

Dtypes and cast points follow the reference: activations in the compute
dtype, the depthwise conv in f32 and cast back before the split, ``dt``,
``a`` and the state in f32, ``y`` back in x's dtype.  The serving cache
holds the conv window and the state in f32 and is updated in place: a
prefill overwrites its slot's window and state, so nothing of the slot's
previous request survives.

Reference: Dao & Gu, "Transformers are SSMs" (arXiv:2405.21060).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.ssd.ops import ssd_apply
from repro_torch.models import layers

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def mamba2_specs(cfg: ModelConfig) -> dict:
    """One layer's mixer parameters as ``(shape, kind)`` leaves (see
    :mod:`repro_torch.models.params`); the reference's fused in-projection
    is split per component, as the reference splits it."""
    d, di = cfg.d_model, cfg.d_inner
    h, conv_dim = cfg.ssm_nheads, cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "wz": ((d, di), "matrix"),
        "wxBC": ((d, conv_dim), "matrix"),
        "wdt": ((d, h), "matrix"),
        "conv_w": ((cfg.ssm_conv, conv_dim), "f32"),
        "conv_b": ((conv_dim,), "zeros"),
        "A_log": ((h,), "ones"),
        "D": ((h,), "ones"),
        "dt_bias": ((h,), "zeros"),
        "norm": ((di,), "ones"),
        "out_proj": ((di, d), "matrix"),
    }


@dataclasses.dataclass
class SSMCache:
    """Per-slot decode state of every layer, f32: the conv window of the
    last ``ssm_conv - 1`` raw ``xBC`` rows, (n_layers, n_slots, K-1, C),
    and the SSD state, (n_layers, n_slots, H, P, N).  No sequence axis: the
    state is O(1) in the length."""

    conv: torch.Tensor
    state: torch.Tensor


# ---------------------------------------------------------------------------
# SSD core (the plain chunked version of the kernel)
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = sum_{k=j+1..i} x_k for i >= j, NEG_INF above
    the diagonal (so its exp is exactly 0)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, NEG_INF)


def ssd_chunked(
    x: torch.Tensor,      # (B, L, H, P) conv output, pre-dt
    dt: torch.Tensor,     # (B, L, H) post-softplus
    a: torch.Tensor,      # (H,) negative
    b_mat: torch.Tensor,  # (B, L, G, N)
    c_mat: torch.Tensor,  # (B, L, G, N)
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-dual scan from a zero state: ``y`` (B, L, H, P)
    in x's dtype and the final state (B, H, P, N) f32.

    The chunk is ``min(chunk, L)``, as in the reference.  Where the
    reference asserts that L is a multiple of it, the last chunk is padded
    with ``dt = 0`` (and zero x, B, C): ``exp(0 * a) = 1`` and the update is
    0, so the state passes the padding unchanged and the padded rows are
    dropped -- the function ``ssd_ref`` defines at every length."""
    bsz, slen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    chunk = min(chunk, slen)
    nc = -(-slen // chunk)
    pad = nc * chunk - slen

    xd = x.float() * dt.float()[..., None]  # dt folded into x
    da = dt.float() * a.float()
    bm, cm = b_mat.float(), c_mat.float()
    if pad:
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))

    xc = xd.reshape(bsz, nc, chunk, g, rep, p)
    bc = bm.reshape(bsz, nc, chunk, g, n)
    cc = cm.reshape(bsz, nc, chunk, g, n)
    dac = da.reshape(bsz, nc, chunk, g, rep)
    dacs = torch.cumsum(dac, dim=2)  # (B, nc, q, G, R)

    # intra-chunk (quadratic, attention-like); C B^T once per group
    lmat = torch.exp(_segsum(dac.permute(0, 1, 3, 4, 2)))  # (B, nc, G, R, q, s)
    scores = torch.einsum("bcqgn,bcsgn->bcgqs", cc, bc)
    y_diag = torch.einsum("bcgrqs,bcsgrp->bcqgrp", scores[:, :, :, None] * lmat, xc)

    # per-chunk final states
    decay_states = torch.exp(dacs[:, :, -1:] - dacs)  # (B, nc, q, G, R)
    chunk_states = torch.einsum("bcsgn,bcsgr,bcsgrp->bcgrpn", bc, decay_states, xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(dacs[:, :, -1])  # (B, nc, G, R)
    state = xd.new_zeros((bsz, g, rep, p, n))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, :, None, None] + chunk_states[:, c]
    entering_states = torch.stack(entering, dim=1)  # (B, nc, G, R, P, N)

    # off-diagonal (cross-chunk) contribution
    state_decay = torch.exp(dacs)  # (B, nc, q, G, R)
    y_off = torch.einsum("bcqgn,bcgrpn,bcqgr->bcqgrp", cc, entering_states, state_decay)

    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :slen]
    return y.to(x.dtype), state.reshape(bsz, h, p, n)


# ---------------------------------------------------------------------------
# Block forward (prefill and decode)
# ---------------------------------------------------------------------------


def _depthwise_causal_conv(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """x (B, L, C), w (K, C): the left-padded depthwise conv, in f32 as the
    sum of K shifted products (no cuDNN, so no TF32), cast back to x's
    dtype."""
    k, slen = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = xp[:, 0:slen] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i : i + slen] * wf[i]
    return (out + b.float()).to(x.dtype)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return xbc[..., :di], xbc[..., di : di + gn], xbc[..., di + gn :]


def _to_heads(cfg: ModelConfig, x_ssm, b_mat, c_mat):
    """x to (B, L, H, P); B and C to (B, L, G, N), per group: the scan maps
    heads to groups itself.  All three stay views of ``xBC``."""
    h, p = cfg.ssm_nheads, cfg.ssm_head_dim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    return (x_ssm.unflatten(-1, (h, p)), b_mat.unflatten(-1, (g, n)),
            c_mat.unflatten(-1, (g, n)))


def _dt_a(p: dict, dt_raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def _mixer(p: dict, cfg: ModelConfig, x: torch.Tensor, scan):
    """The block's arithmetic around the SSD scan ``scan(x, dt, a, B, C)``:
    returns (out, xBC before the conv, the final state)."""
    bsz, slen, _ = x.shape
    z = layers.dense(p["wz"], x)
    xbc_raw = layers.dense(p["wxBC"], x)
    dt_raw = layers.dense(p["wdt"], x)

    xbc = F.silu(_depthwise_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    x_h, b_g, c_g = _to_heads(cfg, *_split_xbc(cfg, xbc))
    dt, a = _dt_a(p, dt_raw)

    y, final_state = scan(x_h, dt, a, b_g, c_g)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * x_h
    y = y.reshape(bsz, slen, cfg.d_inner)
    y = layers.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return layers.dense(p["out_proj"], y), xbc_raw, final_state


def mamba2_full(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence block for training (the reference's ``mamba2_full``),
    (B, L, D) -> (B, L, D): differentiable, through the plain
    :func:`ssd_chunked` at ``cfg.ssm_chunk`` (a ragged last chunk padded
    with ``dt = 0``, where the reference refuses the length), never the
    kernel."""
    out, _, _ = _mixer(p, cfg, x, lambda *a: ssd_chunked(*a, chunk=cfg.ssm_chunk))
    return out


def mamba2_prefill(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,      # (1, L, D) one prompt
    conv: torch.Tensor,   # (K-1, C) the slot's conv window, written in place
    state: torch.Tensor,  # (H, P, N) the slot's SSD state, written in place
) -> torch.Tensor:
    """Full-sequence block of one prompt; leaves the trailing conv window
    and the final SSD state in the slot so decoding continues from L."""
    slen = x.shape[1]
    out, xbc_raw, final_state = _mixer(
        p, cfg, x, lambda *a: ssd_apply(*a, chunk=cfg.ssm_chunk))

    # overwrite, never update: a short prompt's window is zero-padded on the
    # left, as the reference's fresh row cache is
    k1 = cfg.ssm_conv - 1
    if slen >= k1:
        conv.copy_(xbc_raw[0, slen - k1 :])
    else:
        conv.zero_()
        conv[k1 - slen :].copy_(xbc_raw[0])
    state.copy_(final_state[0])
    return out


def mamba2_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,      # (B, 1, D)
    conv: torch.Tensor,   # (B, K-1, C), rolled in place
    state: torch.Tensor,  # (B, H, P, N), advanced in place
) -> torch.Tensor:
    """Single-token recurrent step of every slot."""
    bsz = x.shape[0]
    h, pd, n, g = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups

    z = layers.dense(p["wz"], x)[:, 0]           # (B, d_inner)
    xbc_new = layers.dense(p["wxBC"], x)[:, 0]   # (B, C)
    dt_raw = layers.dense(p["wdt"], x)[:, 0]     # (B, H)

    # rolling conv buffer: window = [cache, new]
    window = torch.cat([conv.to(xbc_new.dtype), xbc_new[:, None]], dim=1)
    conv_out = (window.float() * p["conv_w"].float()).sum(dim=1) + p["conv_b"].float()
    xbc = F.silu(conv_out).to(x.dtype)
    conv.copy_(window[:, 1:])

    x_ssm, b_mat, c_mat = _split_xbc(cfg, xbc)
    x_h = x_ssm.reshape(bsz, h, pd).float()
    rep = h // g
    b_h = b_mat.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    c_h = c_mat.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()

    dt, a = _dt_a(p, dt_raw)  # (B, H), (H,)
    da = torch.exp(dt * a)
    state.mul_(da[:, :, None, None]).add_(
        torch.einsum("bhp,bhn->bhpn", dt[..., None] * x_h, b_h)
    )
    y = torch.einsum("bhpn,bhn->bhp", state, c_h)
    y = y + p["D"].float()[None, :, None] * x_h
    y = y.reshape(bsz, cfg.d_inner).to(x.dtype)

    y = layers.rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return layers.dense(p["out_proj"], y[:, None, :])
