"""Test selection (the port's copy of ``repro/stats/select.py``, paper
Table 2) and the Shapiro-Wilk normality screen.  Shapiro-Wilk follows
Royston's AS R94 approximation: weights from Blom-scored normal order
statistics with Royston's polynomial corrections, the p-value from the
log-normal transform of (1 - W).  Valid for 4 <= n <= 5000."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.stats.significance import (
    TestResult,
    mcnemar_test,
    paired_t_test,
    permutation_test,
    wilcoxon_signed_rank,
)
from repro_torch.stats.special import norm_ppf, norm_sf


def _polyval(coeffs: list[float], x: float) -> float:
    out = 0.0
    for c in reversed(coeffs):
        out = out * x + c
    return out


def shapiro_wilk(x) -> tuple[float, float]:
    """Returns (W, p). Royston (1992, 1995) approximation."""
    x = np.sort(np.asarray(x, np.float64))
    n = len(x)
    if n < 4:
        return 1.0, 1.0
    if n > 5000:
        x = x[:: n // 5000 + 1]
        n = len(x)

    m = np.array([norm_ppf((i - 0.375) / (n + 0.25)) for i in range(1, n + 1)])
    mm = float(m @ m)
    c = m / math.sqrt(mm)
    u = 1.0 / math.sqrt(n)

    a = np.empty(n)
    an = _polyval([c[-1], 0.221157, -0.147981, -2.071190, 4.434685, -2.706056], u)
    an1 = _polyval([c[-2], 0.042981, -0.293762, -1.752461, 5.682633, -3.582633], u)
    if n <= 5:
        phi = (mm - 2 * m[-1] ** 2) / (1 - 2 * an**2)
        a = m / math.sqrt(phi)
        a[-1] = an
        a[0] = -an
    else:
        phi = (mm - 2 * m[-1] ** 2 - 2 * m[-2] ** 2) / (1 - 2 * an**2 - 2 * an1**2)
        a = m / math.sqrt(phi)
        a[-1], a[-2] = an, an1
        a[0], a[1] = -an, -an1

    xm = x.mean()
    ssq = float(np.sum((x - xm) ** 2))
    if ssq <= 0:
        return 1.0, 1.0
    w = float((a @ x) ** 2 / ssq)
    w = min(w, 1.0)

    # p-value: Royston's normalizing transform
    lw = math.log(max(1e-12, 1.0 - w))
    ln_n = math.log(n)
    if n <= 11:
        g = -2.273 + 0.459 * n
        mu = 0.5440 - 0.39978 * n + 0.025054 * n**2 - 0.0006714 * n**3
        sigma = math.exp(
            1.3822 - 0.77857 * n + 0.062767 * n**2 - 0.0020322 * n**3
        )
        if g <= lw:
            return w, 1e-12
        z = (-math.log(g - lw) - mu) / sigma
    else:
        mu = -1.5861 - 0.31082 * ln_n - 0.083751 * ln_n**2 + 0.0038915 * ln_n**3
        sigma = math.exp(
            -0.4803 - 0.082676 * ln_n + 0.0030302 * ln_n**2
        )
        z = (lw - mu) / sigma
    return w, float(min(1.0, max(0.0, norm_sf(z))))


@dataclasses.dataclass(frozen=True)
class TestRecommendation:
    test: str
    reason: str
    normal_p: float | None = None


def is_binary(x) -> bool:
    vals = np.unique(np.asarray(x, np.float64))
    return len(vals) <= 2 and bool(np.all(np.isin(vals, (0.0, 1.0))))


def recommend_test(a, b, *, alpha: float = 0.05) -> TestRecommendation:
    """Table 2: metric type x sample size -> test."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = len(a)
    if is_binary(a) and is_binary(b):
        return TestRecommendation(
            "mcnemar", f"binary metric (exact for <10 discordant pairs), n={n}"
        )
    d = a - b
    nz = d[d != 0]
    if len(nz) >= 4:
        _, p_norm = shapiro_wilk(nz)
    else:
        p_norm = 0.0
    if n > 30 and p_norm > alpha:
        return TestRecommendation(
            "paired_t",
            f"continuous, normality not rejected (SW p={p_norm:.3f}), n={n}",
            p_norm,
        )
    return TestRecommendation(
        "wilcoxon",
        f"continuous/ordinal, non-normal or small sample (SW p={p_norm:.3f}), n={n}",
        p_norm,
    )


def run_recommended(a, b, *, alpha: float = 0.05, seed: int = 0) -> TestResult:
    rec = recommend_test(a, b, alpha=alpha)
    if rec.test == "mcnemar":
        return mcnemar_test(a, b)
    if rec.test == "paired_t":
        return paired_t_test(a, b)
    if rec.test == "wilcoxon":
        return wilcoxon_signed_rank(a, b)
    return permutation_test(a, b, seed=seed)
