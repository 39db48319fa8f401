"""Model-facing SSD scan: the Hopper kernel for CUDA tensors, the plain
chunked version (``repro_torch.models.ssm.ssd_chunked``) for CPU tensors.
There is no fallback: a CUDA tensor the kernel does not take raises."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ssd import ssd as _kernel


def ssd_apply(
    x: torch.Tensor,      # (B, L, H, P)
    dt: torch.Tensor,     # (B, L, H) f32, post-softplus
    a: torch.Tensor,      # (H,) f32
    b_mat: torch.Tensor,  # (B, L, G, N)
    c_mat: torch.Tensor,  # (B, L, G, N)
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    if x.is_cuda:
        return _kernel(x, dt, a, b_mat, c_mat, chunk=chunk)
    if x.device.type == "cpu":
        # the plain version sits with the model code, which imports this
        # module, so it is looked up at call time
        from repro_torch.models.ssm import ssd_chunked

        return ssd_chunked(x, dt, a, b_mat, c_mat, chunk)
    raise ValueError(f"no SSD scan for device {x.device}")
