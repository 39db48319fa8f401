"""BERTScore with the F1 epilogue: the Hopper kernel for CUDA tensors, the
plain version for CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.bertscore.bertscore import bertscore_pr
from repro_torch.kernels.bertscore.ref import bertscore_ref, f1_from_pr


def bertscore(
    cand: torch.Tensor,       # (B, Lc, D)
    ref: torch.Tensor,        # (B, Lr, D)
    cand_mask: torch.Tensor,  # (B, Lc) 0-1
    ref_mask: torch.Tensor,   # (B, Lr) 0-1
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, R, F1) per example, f32."""
    if cand.device.type == "cpu":
        return bertscore_ref(cand, ref, cand_mask, ref_mask)
    if cand.device.type != "cuda":
        raise ValueError(f"no bertscore for device {cand.device}")
    f32 = torch.float32
    p, r = bertscore_pr(
        cand.to(f32).contiguous(), ref.to(f32).contiguous(),
        cand_mask.to(f32).contiguous(), ref_mask.to(f32).contiguous(),
    )
    return p, r, f1_from_pr(p, r)
