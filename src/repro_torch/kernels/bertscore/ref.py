"""Plain PyTorch version of the BERTScore greedy-matching kernel: the same
math as the JAX package's ``repro/kernels/bertscore/ref.py``, the ``-1e30``
sentinel for masked token pairs included."""

from __future__ import annotations

import torch

#: the value a masked (candidate, reference) token pair takes
NEG_INF = -1e30


def f1_from_pr(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The reference's F1 epilogue ``2pr / max(p + r, 1e-9)``.  It is kept
    as the reference has it: ``p + r < 0`` gives a huge F1, and an empty
    candidate (R = -1e30) gives -0.0."""
    return 2 * p * r / torch.clamp(p + r, min=1e-9)


def bertscore_ref(
    cand: torch.Tensor,       # (B, Lc, D) token embeddings (need not be normalized)
    ref: torch.Tensor,        # (B, Lr, D)
    cand_mask: torch.Tensor,  # (B, Lc) bool / 0-1
    ref_mask: torch.Tensor,   # (B, Lr)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, R, F1) per example, f32: greedy max-cosine matching."""
    c = cand.to(torch.float32)
    r = ref.to(torch.float32)
    c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-9)
    r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True), min=1e-9)
    sim = torch.einsum("bcd,brd->bcr", c, r)  # (B, Lc, Lr)
    cm = cand_mask.to(torch.bool)
    rm = ref_mask.to(torch.bool)
    sim = torch.where(cm[:, :, None] & rm[:, None, :], sim, NEG_INF)

    row_max = sim.amax(dim=2)  # best reference token per candidate token
    col_max = sim.amax(dim=1)  # best candidate token per reference token
    p = torch.where(cm, row_max, 0.0).sum(dim=1) / torch.clamp(
        cm.sum(dim=1), min=1
    ).to(torch.float32)
    r_ = torch.where(rm, col_max, 0.0).sum(dim=1) / torch.clamp(
        rm.sum(dim=1), min=1
    ).to(torch.float32)
    return p, r_, f1_from_pr(p, r_)
