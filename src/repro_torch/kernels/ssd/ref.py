"""Plain PyTorch oracle for the SSD (Mamba2) kernel: the sequential
recurrence of ``repro/kernels/ssd/ref.py``.

    y_t = C_t^T h_t,   h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t B_t^T

O(L) steps, slow but unambiguous: the chunked plain version
(``repro_torch.models.ssm.ssd_chunked``) and the CUDA kernel are held to it.
B and C come per group, (B, L, G, N); head ``h`` reads group
``h // (H / G)``, as the reference's ``jnp.repeat`` over heads lays them out
(G = H is the reference's per-head form).
"""

from __future__ import annotations

import torch


def ssd_ref(
    x: torch.Tensor,      # (B, L, H, P)
    dt: torch.Tensor,     # (B, L, H) post-softplus
    a: torch.Tensor,      # (H,) negative
    b_mat: torch.Tensor,  # (B, L, G, N)
    c_mat: torch.Tensor,  # (B, L, G, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``y`` (B, L, H, P) in x's dtype and the final state
    (B, H, P, N) f32, from a zero initial state."""
    bsz, slen, h, p = x.shape
    n = b_mat.shape[-1]
    rep = h // b_mat.shape[2]
    bh = b_mat.float().repeat_interleave(rep, dim=2)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    xf, dtf, af = x.float(), dt.float(), a.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(slen):
        decay = torch.exp(dtf[:, t] * af)  # (B, H)
        update = torch.einsum("bhp,bhn->bhpn", dtf[:, t, :, None] * xf[:, t], bh[:, t])
        state = state * decay[..., None, None] + update
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y.to(x.dtype), state
