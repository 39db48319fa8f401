"""Dispatchers of the bootstrap kernels: the Hopper kernel for CUDA
tensors, the plain version for CPU tensors.  The two share the weight
stream bit for bit and differ only in f32 summation order, so the
``backend="device"`` statistics engine records which one ran.  Also the
statistics API :func:`bootstrap_ci`."""

from __future__ import annotations

import torch

from repro_torch.kernels.bootstrap.bootstrap import bootstrap_means as _means_kernel
from repro_torch.kernels.bootstrap.bootstrap import bootstrap_partials as _kernel
from repro_torch.kernels.bootstrap.ref import (
    bootstrap_means_ref,
    bootstrap_partials_ref,
)


def partials_path(device: torch.device) -> str:
    """``"kernel"`` or ``"ref"``: what this module's dispatchers run for
    tensors on ``device``."""
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "ref"
    raise ValueError(f"no bootstrap partials for device {device}")


def bootstrap_partials(
    scores: torch.Tensor,  # (n, m) f32 — NaN marks unscorable examples
    seed: int,
    start: int,
    *,
    n_boot: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    if partials_path(scores.device) == "kernel":
        return _kernel(scores, seed, start, n_boot=n_boot)
    return bootstrap_partials_ref(scores, seed, start, n_boot=n_boot)


def bootstrap_ci(
    data: torch.Tensor,  # (n,) scores
    seed: int = 0,
    *,
    n_boot: int = 1000,
    confidence: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, lo, hi), 0-d f32 tensors on ``data``'s device: the percentile
    interval of ``n_boot`` Poisson-bootstrap means (linear interpolation,
    as ``jnp.quantile``), beside the f32 mean of ``data``."""
    x = data.to(torch.float32).contiguous()
    if partials_path(x.device) == "kernel":
        means = _means_kernel(x, seed, n_boot=n_boot)
    else:
        means = bootstrap_means_ref(x, n_boot, seed)
    alpha = (1.0 - confidence) / 2.0
    lo = torch.quantile(means, alpha)
    hi = torch.quantile(means, 1.0 - alpha)
    return torch.mean(x), lo, hi
