"""Binding of the hand-written Hopper BERTScore kernel
(``csrc/bertscore.cu``), the port of the Pallas TPU kernel
``repro/kernels/bertscore/bertscore.py:bertscore_pr``.

The kernel keeps each example's row and column maxima, inverse norms and
masks in shared memory, :data:`TOKEN_BYTES` a token of either side, beside
its static :data:`RING_BYTES` ``cp.async`` ring; so an example fits where
``TOKEN_BYTES * (Lc + Lr) + RING_BYTES`` is within the shared memory a
block may opt in to.  Compute capability 9.0, the only one the kernel is
built for, allows :data:`SM90_SMEM_OPTIN` bytes: Lc + Lr up to
:func:`max_tokens` (21,731).  The embedding width has no limit."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _cuda

#: dynamic shared memory a token of either side takes: its inverse norm and
#: its running maximum (4 bytes each) and its mask (a byte)
TOKEN_BYTES = 9
#: the static ``cp.async`` ring: 2 stages of 64 x 36 f32 of both sides
RING_BYTES = 2 * 2 * 64 * 36 * 4
#: the shared memory a block may opt in to on compute capability 9.0 (227
#: KB; CUDA C++ Programming Guide, technical specifications)
SM90_SMEM_OPTIN = 232_448


def max_tokens(smem_optin: int = SM90_SMEM_OPTIN) -> int:
    """The most tokens of an example's two sides together (Lc + Lr) that a
    block with ``smem_optin`` bytes of shared memory holds."""
    return (smem_optin - RING_BYTES) // TOKEN_BYTES


def shape_error(lc: int, lr: int, d: int,
                smem_optin: int = SM90_SMEM_OPTIN) -> str | None:
    """Why the kernel cannot take ``Lc`` and ``Lr`` tokens of width ``d``
    on a card with ``smem_optin`` bytes of opt-in shared memory a block, or
    None where it can."""
    if lc < 1 or lr < 1 or d < 1:
        return f"bertscore_pr takes at least 1 token a side and width 1: " \
               f"Lc={lc} Lr={lr} D={d}"
    if lc + lr > max_tokens(smem_optin):
        return (f"bertscore_pr takes at most {max_tokens(smem_optin)} tokens "
                f"of both sides together on a card with {smem_optin} bytes of "
                f"shared memory a block ({TOKEN_BYTES} a token beside its "
                f"{RING_BYTES}-byte ring): Lc={lc} Lr={lr}")
    return None


@functools.cache
def device_smem_optin(index: int) -> int:
    """The opt-in shared memory a block of the card ``index``, from the
    runtime, checked against the ring's static size there."""
    dyn, ring, optin = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = _cuda.library().repro_bertscore_smem(
            1, 1, ctypes.byref(dyn), ctypes.byref(ring), ctypes.byref(optin))
    _cuda.check(err, "bertscore_pr shared memory query")
    if ring.value != RING_BYTES or dyn.value != 2 * TOKEN_BYTES:
        raise RuntimeError(
            f"bertscore_pr's ring is {ring.value} bytes and a token pair "
            f"{dyn.value}; the binding assumes {RING_BYTES} and {2 * TOKEN_BYTES}"
        )
    return optin.value


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
    index = cand.device.index
    why = shape_error(lc, lr, d, device_smem_optin(
        torch.cuda.current_device() if index is None else index))
    if why is not None:
        raise ValueError(why)
    p = torch.empty((b,), dtype=torch.float32, device=cand.device)
    r = torch.empty_like(p)
    if b == 0:
        return p, r
    err = _cuda.library().repro_bertscore_pr(
        cand.data_ptr(), ref.data_ptr(), cand_mask.data_ptr(), ref_mask.data_ptr(),
        b, lc, lr, d, p.data_ptr(), r.data_ptr(), _cuda.stream_of(cand),
    )
    _cuda.check(err, "bertscore_pr")
    _cuda.count_launch(bertscore_pr)
    return p, r


#: kernel launches since the count was last set to 0
bertscore_pr.launches = 0
