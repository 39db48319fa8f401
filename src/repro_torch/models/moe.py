"""Mixture-of-Experts layer (``repro/models/moe.py``): token-choice top-k
routing with capacity dropping (GShard), shared experts, and the Switch
load-balancing loss, which :func:`moe_block` computes only when the
training forward asks for it (``return_aux=True``): serving never pays for
it.

Dispatch and combine go through fixed-shape buffers, as in the reference:
one-hot ``(B, S, E, C)`` tensors contracted with the tokens, experts as
batched products over ``(E, B * C, d)``.  Every shape depends only on B, S
and the config, never on the routing: there is no loop over experts and no
host read, so a layer costs a fixed number of launches, and a prompt's
greedy tokens do not depend on the batch around it (a GEMM of another
shape may sum in another order).  A capacity slot at position S or later
is always empty, so the buffers hold ``C = min(capacity, S)`` slots; decode
(S = 1) needs one slot per row.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import layers


def expert_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Per-expert, per-batch-row token capacity (multiple of 4 for layout)."""
    cap = cfg.n_experts_per_token * seq_len * cfg.capacity_factor / cfg.n_experts
    cap = int(cap + 0.999)
    return max(4, ((cap + 3) // 4) * 4)


def top_k_mask(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, mask) of shape (..., E): every expert whose probability is at
    or above the k-th largest, so a tie admits more than k, with the
    admitted probabilities renormalized; 0 elsewhere."""
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    mask = probs >= thresh
    weights = torch.where(mask, probs, 0.0)
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return weights, mask


def router_probs(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Router logits and softmax in f32 from the f32 router, (B, S, E)."""
    return torch.softmax(x.float() @ p["router"].float(), dim=-1)


def route(
    p: dict, cfg: ModelConfig, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's probabilities (:func:`router_probs`), the top-k
    threshold, and each token's place in its experts' queues (a cumsum over
    the sequence, per batch row).  Returns (probs, weights, mask, keep,
    slot), each (B, S, E): ``keep`` is the mask less the tokens past the
    capacity, ``slot`` a kept token's place in its expert's queue counted
    from 1, and 0 where the token is not kept."""
    probs = router_probs(p, x)
    weights, mask = top_k_mask(probs, cfg.n_experts_per_token)
    place = torch.cumsum(mask, dim=1, dtype=torch.int32)
    keep = mask & (place <= expert_capacity(cfg, x.shape[1]))
    return probs, weights, mask, keep, torch.where(keep, place, 0)


def experts(p: dict, xin: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its slots, (E, n, d) -> (E, n, d), as
    batched products in xin's dtype."""
    h = (torch.nn.functional.silu(torch.bmm(xin, p["wg"].to(xin.dtype)))
         * torch.bmm(xin, p["wi"].to(xin.dtype)))
    return torch.bmm(h, p["wo"].to(xin.dtype))


def switch_aux(probs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss in f32: ``E * sum_e frac_tokens[e] *
    frac_probs[e]``, each fraction a mean over the batch and the sequence
    (``repro/models/moe.py:94-98``)."""
    frac_tokens = mask.float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return probs.shape[-1] * (frac_tokens * frac_probs).sum()


def moe_block(
    p: dict, cfg: ModelConfig, x: torch.Tensor, *, return_aux: bool = False
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Routed experts (plus the shared experts) over ``x`` (B, S, D), in x's
    dtype; dropped tokens get 0 here and fall through on the residual.
    With ``return_aux`` returns (out, the Switch aux loss), as the
    reference's ``moe_block`` does."""
    b, s, d = x.shape
    e = cfg.n_experts
    c = min(expert_capacity(cfg, s), s)
    probs, weights, mask, _, slot = route(p, cfg, x)
    slot_oh = slot[..., None] == torch.arange(1, c + 1, device=x.device)  # (B,S,E,C)
    # dispatch: one nonzero term a slot, so exact in any dtype
    expert_in = torch.bmm(slot_oh.to(x.dtype).view(b, s, e * c).transpose(1, 2), x)
    expert_in = expert_in.view(b, e, c, d).transpose(0, 1).reshape(e, b * c, d)
    expert_out = experts(p, expert_in)
    # combine in f32: (B, S, E * C) x (B, E * C, d)
    expert_out = expert_out.view(e, b, c, d).transpose(0, 1).to(
        torch.float32, copy=True, memory_format=torch.contiguous_format)
    combine = torch.where(slot_oh, weights[..., None], 0.0).view(b, s, e * c)
    out = torch.bmm(combine, expert_out.view(b, e * c, d)).to(x.dtype)
    if "shared" in p:
        out = out + layers.gated_mlp(p["shared"], x, cfg.act)
    return (out, switch_aux(probs, mask)) if return_aux else out


def moe_block_naive(
    p: dict, cfg: ModelConfig, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routed experts token by token in f32, the plain version that
    :func:`moe_block` is held to: the same router probabilities (one f32
    product), then for each batch row and token in order the experts at or
    above the k-th probability, each taking the token while its queue has
    room, and the kept experts' SwiGLU outputs summed with the
    renormalized weights.  Shared experts are not included.  Returns (out
    f32, mask, keep)."""
    b, s, d = x.shape
    k, cap = cfg.n_experts_per_token, expert_capacity(cfg, s)
    probs = router_probs(p, x).cpu()
    mask = torch.zeros(probs.shape, dtype=torch.bool)
    keep = torch.zeros(probs.shape, dtype=torch.bool)
    out = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    for bi in range(b):
        queue = [0] * cfg.n_experts
        for si in range(s):
            row = probs[bi, si]
            thresh = sorted(row.tolist(), reverse=True)[k - 1]
            chosen = [ei for ei, v in enumerate(row.tolist()) if v >= thresh]
            total = sum(float(row[ei]) for ei in chosen)
            tok = x[bi, si].float()
            for ei in chosen:
                mask[bi, si, ei] = True
                if queue[ei] >= cap:
                    continue
                queue[ei] += 1
                keep[bi, si, ei] = True
                h = (torch.nn.functional.silu(tok @ p["wg"][ei].float())
                     * (tok @ p["wi"][ei].float()))
                out[bi, si] += float(row[ei]) / max(total, 1e-9) * (
                    h @ p["wo"][ei].float())
    return out, mask.to(x.device), keep.to(x.device)
