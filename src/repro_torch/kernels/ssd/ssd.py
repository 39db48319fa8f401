"""Binding of the hand-written Hopper SSD kernel (``csrc/ssd.cu``), the port
of the Pallas TPU kernel ``repro/kernels/ssd/ssd.py:ssd``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

#: the head width and state size the kernel is built for (Mamba2's)
HEAD_DIM, STATE_DIM = 64, 128
MAX_CHUNK = 256


def _check_rows(t: torch.Tensor, name: str) -> None:
    """16-byte loads: the base and every row of a bf16 operand aligned."""
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned in every row")


def scratch_floats(bsz: int, slen: int, h: int, g: int, chunk: int) -> int:
    """f32 scratch of one call (``csrc/ssd.cu``): each chunk's running sums
    (B, H, QP), states (B, H, P, N) and C B^T (B, G, QP, QP), where Q =
    min(chunk, L), QP is Q rounded up to 16 and there are ceil(L / Q)
    chunks."""
    q = min(chunk, slen)
    qp, nc = -(-q // 16) * 16, -(-slen // q)
    return bsz * nc * (h * qp + h * HEAD_DIM * STATE_DIM + g * qp * qp)


def ssd(
    x: torch.Tensor,      # (B, L, H, P) bf16, CUDA
    dt: torch.Tensor,     # (B, L, H) f32, post-softplus
    a: torch.Tensor,      # (H,) f32, negative
    b_mat: torch.Tensor,  # (B, L, G, N) bf16, one row per group
    c_mat: torch.Tensor,  # (B, L, G, N) bf16
    *,
    chunk: int = MAX_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan from a zero state on the card: ``y`` (B, L, H,
    P) bf16 and the final state (B, H, P, N) f32.  ``x``, ``B`` and ``C``
    may be strided views (columns of the fused ``xBC`` projection) with unit
    stride on their last axis; G divides H; P = 64, N = 128, chunk <= 256.
    A ragged last chunk is computed as if padded with ``dt = 0``.  One call
    runs three device kernels (chunk states with C B^T, the recurrence
    across chunks, outputs) and counts one launch."""
    _cuda.require_cuda(x, "x", torch.bfloat16)
    _cuda.require_cuda(dt, "dt", torch.float32)
    _cuda.require_cuda(a, "a", torch.float32)
    for name, t in (("b_mat", b_mat), ("c_mat", c_mat)):
        _cuda.require_cuda(t, name, torch.bfloat16)
        _check_rows(t, name)
    _check_rows(x, "x")
    bsz, slen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if (dt.shape != (bsz, slen, h) or a.shape != (h,) or not a.is_contiguous()
            or b_mat.shape != (bsz, slen, g, n) or c_mat.shape != b_mat.shape):
        raise ValueError(
            f"shape mismatch: x {x.shape}, dt {dt.shape}, a {a.shape}, "
            f"B {b_mat.shape}, C {c_mat.shape}"
        )
    if (bsz == 0 or slen == 0 or h % g or p != HEAD_DIM or n != STATE_DIM
            or not 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"unsupported: B={bsz} L={slen} H={h} G={g} P={p} "
                         f"N={n} chunk={chunk}")
    y = torch.empty((bsz, slen, h, p), dtype=torch.bfloat16, device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_floats(bsz, slen, h, g, chunk),
                          dtype=torch.float32, device=x.device)
    strides = [*x.stride()[:3], *dt.stride(), *b_mat.stride()[:3],
               *c_mat.stride()[:3]]
    err = _cuda.library().repro_ssd_bf16(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), y.data_ptr(), final.data_ptr(), bsz, slen, h, g, p,
        n, chunk, _cuda.int64_array(strides), scratch.data_ptr(),
        scratch.numel(), _cuda.stream_of(x),
    )
    _cuda.check(err, "ssd")
    ssd.launches += 1
    return y, final


#: kernel launches since the count was last set to 0
ssd.launches = 0
