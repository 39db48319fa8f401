"""Sampling for the serving loop (``repro/serve/steps.py``): greedy argmax,
and temperature sampling by the Gumbel-max trick with the reference's
``jax.random.categorical`` noise, drawn bit for bit by the port's threefry
(:func:`repro_torch.stats.threefry.gumbel`)."""

from __future__ import annotations

import torch

from repro_torch.stats import threefry


def _mask_padding(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    vp = logits.shape[-1]
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, float("-inf"))
    return logits


def greedy_sample(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Argmax over the un-padded vocab, (B, Vp) -> (B,) int64.  The padded
    columns are masked to -inf; on a tie the first index wins."""
    return torch.argmax(_mask_padding(logits, vocab_size), dim=-1)


def temperature_sample(
    logits: torch.Tensor, vocab_size: int, temperature: float, key: torch.Tensor
) -> torch.Tensor:
    """Sample (B, Vp) f32 logits at ``temperature`` under threefry ``key``
    (on the logits' device), as ``jax.random.categorical(key, logits / T)``
    does: the argmax of ``logits / T`` plus Gumbel noise drawn over the whole
    padded (B, Vp) block, the padded columns at -inf.  ``temperature <= 0``
    is greedy."""
    logits = _mask_padding(logits, vocab_size)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    # a divisor tensor on the device keeps the division exact on the card,
    # where a Python scalar divisor becomes a product with its reciprocal
    t = torch.tensor(temperature, dtype=logits.dtype, device=logits.device)
    noise = threefry.gumbel(key, tuple(logits.shape))
    return torch.argmax(noise + logits / t, dim=-1)
