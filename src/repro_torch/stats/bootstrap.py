"""Confidence intervals from the data (the port's copy of the analytical
intervals of ``repro/stats/bootstrap.py``): the interval value type, the
t-interval and the Wilson score interval."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.stats.special import norm_ppf, t_ppf


@dataclasses.dataclass(frozen=True)
class Interval:
    value: float
    lo: float
    hi: float
    method: str
    n: int


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
