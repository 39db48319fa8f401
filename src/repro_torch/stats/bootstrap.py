"""Confidence intervals from per-example scores (the port of
``repro/stats/bootstrap.py``): the percentile and BCa bootstraps over exact
multinomial resamples, the t-interval and the Wilson score interval, the
``compute_ci`` dispatch that the in-memory aggregation stage calls, and the
bootstrap p-value.

The resample indices are ``jax.random.randint`` draws under threefry, made
by :mod:`repro_torch.stats.threefry` on the data's device: the same
integers as the reference's.  A mean is rounded as XLA rounds ``jnp.mean``,
so on scores whose f32 sums are exact (dyadic scores, such as 0/1) the
intervals are the reference's bit for bit.  Otherwise the f32 replicate
means differ from XLA's in the last bits, because the two sum in other
orders.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.stats import threefry
from repro_torch.stats.special import norm_cdf, norm_ppf, t_ppf

#: replicates resampled together, as the reference's ``lax.map`` batch
MAX_BATCH = 128
#: at most this many resampled values are held at once
MAX_BATCH_ELEMENTS = 1 << 23


@dataclasses.dataclass(frozen=True)
class Interval:
    value: float
    lo: float
    hi: float
    method: str
    n: int


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The f32 mean along the last axis rounded as XLA rounds ``jnp.mean``:
    the sum times the f32 reciprocal of the count."""
    return x.sum(dim=-1) * float(np.float32(1) / np.float32(x.shape[-1]))


def resample_stats(
    data: torch.Tensor,
    stat_fn: Callable[[torch.Tensor], torch.Tensor] = _mean,
    *,
    n_boot: int,
    seed: int,
) -> np.ndarray:
    """(n_boot,) f32 statistic over exact multinomial resamples of the (n,)
    f32 ``data``: replicate b draws ``randint(split(key(seed), n_boot)[b],
    (n,), 0, n)`` and applies ``stat_fn`` along the last axis.  Replicates
    go in batches of at most 128, fewer where n is large, so a batch's
    indices stay within ``MAX_BATCH_ELEMENTS``."""
    x = data.to(torch.float32)
    n = x.shape[0]
    keys = threefry.split(threefry.key(seed, x.device), n_boot)
    batch = max(1, min(n_boot, MAX_BATCH, MAX_BATCH_ELEMENTS // max(n, 1)))
    out = [
        stat_fn(x[threefry.randint(keys[b0 : b0 + batch], n, 0, n)])
        for b0 in range(0, n_boot, batch)
    ]
    return torch.cat(out).cpu().numpy().astype(np.float32)


def _as_f32(data, device: torch.device | None) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        x = data.to(torch.float32)
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(data, np.float32), device=device)


def percentile_bootstrap(
    data,
    stat_fn: Callable[[torch.Tensor], torch.Tensor] = _mean,
    *,
    n_boot: int = 1000,
    confidence: float = 0.95,
    seed: int = 0,
    device: torch.device | None = None,
) -> Interval:
    x = _as_f32(data, device)
    stats = resample_stats(x, stat_fn, n_boot=n_boot, seed=seed)
    alpha = (1 - confidence) / 2
    lo, hi = np.quantile(stats, [alpha, 1 - alpha])
    return Interval(float(stat_fn(x)), float(lo), float(hi), "percentile", x.shape[0])


def bca_bootstrap(
    data,
    stat_fn: Callable[[torch.Tensor], torch.Tensor] = _mean,
    *,
    n_boot: int = 1000,
    confidence: float = 0.95,
    seed: int = 0,
    device: torch.device | None = None,
) -> Interval:
    """Bias-corrected and accelerated bootstrap (Efron & Tibshirani, ch. 14)."""
    x = _as_f32(data, device)
    n = x.shape[0]
    theta_hat = float(stat_fn(x))
    stats = resample_stats(x, stat_fn, n_boot=n_boot, seed=seed)

    # bias correction z0: proportion of bootstrap stats below the estimate
    prop = np.clip(
        np.mean(stats < theta_hat) + 0.5 * np.mean(stats == theta_hat),
        1.0 / (2 * n_boot),
        1.0 - 1.0 / (2 * n_boot),
    )
    z0 = norm_ppf(float(prop))

    # acceleration a from jackknife values: closed form for the mean,
    # jack_i = (sum - x_i) / (n - 1); other statistics take the O(n)
    # leave-one-out loop
    data_np = x.cpu().numpy().astype(np.float64)
    if stat_fn is _mean:
        jack = (data_np.sum() - data_np) / (n - 1)
    else:
        jack = np.empty(n, np.float64)
        for i in range(n):
            rest = torch.from_numpy(np.delete(data_np, i, axis=0))
            jack[i] = float(stat_fn(rest.to(x.device)))
    jmean = jack.mean()
    num = np.sum((jmean - jack) ** 3)
    den = 6.0 * (np.sum((jmean - jack) ** 2) ** 1.5)
    a = float(num / den) if den > 0 else 0.0

    alpha = (1 - confidence) / 2
    z_lo, z_hi = norm_ppf(alpha), norm_ppf(1 - alpha)

    def adj(z: float) -> float:
        w = z0 + (z0 + z) / (1 - a * (z0 + z))
        return norm_cdf(w)

    lo, hi = np.quantile(stats, [adj(z_lo), adj(z_hi)])
    return Interval(theta_hat, float(lo), float(hi), "bca", n)


def t_interval(data, *, confidence: float = 0.95) -> Interval:
    data = np.asarray(data, np.float64)
    n = data.shape[0]
    mean = float(data.mean())
    se = float(data.std(ddof=1) / math.sqrt(n)) if n > 1 else 0.0
    tcrit = t_ppf(1 - (1 - confidence) / 2, n - 1) if n > 1 else 0.0
    return Interval(mean, mean - tcrit * se, mean + tcrit * se, "t", n)


def wilson_interval(successes: int, n: int, *, confidence: float = 0.95) -> Interval:
    """Wilson score interval for proportions (robust near 0/1)."""
    if n == 0:
        return Interval(0.0, 0.0, 1.0, "wilson", 0)
    z = norm_ppf(1 - (1 - confidence) / 2)
    p = successes / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    lo = min(max(0.0, center - half), p)   # clamp numerical dust at the edges
    hi = max(min(1.0, center + half), p)
    return Interval(p, lo, hi, "wilson", n)


def replicate_p_value(replicates, null: float = 0.0) -> float:
    """Two-sided bootstrap p-value from a replicate distribution: the
    smallest alpha at which the percentile interval excludes ``null``
    (CI-inversion; add-one correction keeps p in (0, 1] at finite B)."""
    reps = np.asarray(replicates, np.float64)
    n_boot = reps.size
    if n_boot == 0:
        return 1.0
    p_lo = (1.0 + np.sum(reps <= null)) / (n_boot + 1.0)
    p_hi = (1.0 + np.sum(reps >= null)) / (n_boot + 1.0)
    return float(min(1.0, 2.0 * min(p_lo, p_hi)))


def compute_ci(
    data,
    *,
    method: str = "bca",
    confidence: float = 0.95,
    n_boot: int = 1000,
    seed: int = 0,
    binary: bool = False,
    device: torch.device | None = None,
) -> Interval:
    """Dispatch per ``StatisticsConfig.ci_method`` (+ Wilson for binary
    metrics).  The bootstrap methods resample on ``device`` (the data's
    own, or the CPU for an array)."""
    if method == "analytical":
        arr = np.asarray(data.cpu() if isinstance(data, torch.Tensor) else data)
        if binary:
            return wilson_interval(int(arr.sum()), len(arr), confidence=confidence)
        return t_interval(arr, confidence=confidence)
    if method == "percentile":
        return percentile_bootstrap(
            data, n_boot=n_boot, confidence=confidence, seed=seed, device=device
        )
    if method == "bca":
        return bca_bootstrap(
            data, n_boot=n_boot, confidence=confidence, seed=seed, device=device
        )
    raise ValueError(f"unknown ci method {method!r}")
