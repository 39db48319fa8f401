"""Binding of the hand-written Hopper BERTScore kernel
(``csrc/bertscore.cu``), the port of the Pallas TPU kernel
``repro/kernels/bertscore/bertscore.py:bertscore_pr``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

#: the largest token count per side and embedding width the kernel takes
MAX_LEN = 512
MAX_DIM = 1024


def bertscore_pr(
    cand: torch.Tensor,       # (B, Lc, D) f32, CUDA
    ref: torch.Tensor,        # (B, Lr, D) f32
    cand_mask: torch.Tensor,  # (B, Lc) f32, 1 = a token, 0 = padding
    ref_mask: torch.Tensor,   # (B, Lr) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy-matching precision and recall, each (B,) f32, on the card."""
    for name, t, dim in (("cand", cand, 3), ("ref", ref, 3),
                         ("cand_mask", cand_mask, 2), ("ref_mask", ref_mask, 2)):
        _cuda.require_cuda(t, name, torch.float32)
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-d tensor: {t.shape}")
    b, lc, d = cand.shape
    lr = ref.shape[1]
    if (ref.shape != (b, lr, d) or cand_mask.shape != (b, lc)
            or ref_mask.shape != (b, lr)):
        raise ValueError(
            f"shapes disagree: cand {tuple(cand.shape)}, ref {tuple(ref.shape)}, "
            f"masks {tuple(cand_mask.shape)} / {tuple(ref_mask.shape)}"
        )
    if not (1 <= lc <= MAX_LEN and 1 <= lr <= MAX_LEN and 1 <= d <= MAX_DIM):
        raise ValueError(
            f"bertscore_pr takes 1..{MAX_LEN} tokens a side and widths "
            f"1..{MAX_DIM}: Lc={lc} Lr={lr} D={d}"
        )
    p = torch.empty((b,), dtype=torch.float32, device=cand.device)
    r = torch.empty_like(p)
    if b == 0:
        return p, r
    err = _cuda.library().repro_bertscore_pr(
        cand.data_ptr(), ref.data_ptr(), cand_mask.data_ptr(), ref_mask.data_ptr(),
        b, lc, lr, d, p.data_ptr(), r.data_ptr(), _cuda.stream_of(cand),
    )
    _cuda.check(err, "bertscore_pr")
    bertscore_pr.launches += 1
    return p, r


#: kernel launches since the count was last set to 0
bertscore_pr.launches = 0
