"""Significance tests for paired model comparison (the port's copy of
``repro/stats/significance.py``, paper section 4.3): paired t, McNemar
(exact binomial under 10 discordant pairs, continuity-corrected chi-squared
otherwise), Wilcoxon signed-rank (exact enumeration for small n, else the
normal approximation with tie correction), and the sign-flip permutation
test.  numpy and pure Python, so every statistic and p-value is the
reference's bit for bit; the permutation test draws its signs from numpy's
``default_rng(seed)`` as the reference does."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.stats.special import (
    binom_test_two_sided,
    chi2_sf,
    norm_sf,
    t_sf,
)


@dataclasses.dataclass(frozen=True)
class TestResult:
    test: str
    statistic: float
    p_value: float
    n: int
    detail: dict | None = None

    def significant(self, alpha: float = 0.05) -> bool:
        return self.p_value < alpha


def paired_t_test(a, b) -> TestResult:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = a - b
    n = d.shape[0]
    if n < 2:
        return TestResult("paired_t", 0.0, 1.0, n)
    sd = d.std(ddof=1)
    if sd == 0:
        return TestResult("paired_t", 0.0, 1.0 if d.mean() == 0 else 0.0, n)
    t = d.mean() / (sd / math.sqrt(n))
    p = 2.0 * t_sf(abs(t), n - 1)
    return TestResult("paired_t", float(t), min(1.0, p), n)


def mcnemar_test(a, b, *, exact_threshold: int = 10) -> TestResult:
    """Binary outcomes; considers only discordant pairs."""
    a = np.asarray(a).astype(bool)
    b = np.asarray(b).astype(bool)
    n01 = int(np.sum(~a & b))
    n10 = int(np.sum(a & ~b))
    disc = n01 + n10
    if disc == 0:
        return TestResult("mcnemar", 0.0, 1.0, len(a), {"n01": n01, "n10": n10})
    if disc < exact_threshold:
        p = binom_test_two_sided(min(n01, n10), disc, 0.5)
        return TestResult(
            "mcnemar_exact", float(min(n01, n10)), p, len(a),
            {"n01": n01, "n10": n10},
        )
    stat = (abs(n01 - n10) - 1.0) ** 2 / disc  # continuity-corrected chi2(1)
    p = chi2_sf(stat, 1.0)
    return TestResult(
        "mcnemar", float(stat), min(1.0, p), len(a), {"n01": n01, "n10": n10}
    )


def _wilcoxon_exact_p(w: float, ranks: np.ndarray) -> float:
    """Exact two-sided p by DP over the signed-rank distribution."""
    # distribution of W+ over all 2^n sign assignments, supports tied ranks
    scale = 2  # work in half-units so tied (x.5) ranks stay integral
    r_int = np.round(ranks * scale).astype(int)
    total = int(r_int.sum())
    poly = np.zeros(total + 1, np.float64)
    poly[0] = 1.0
    for r in r_int:
        nxt = poly.copy()
        nxt[r:] += poly[: total + 1 - r]
        poly = nxt
    poly /= poly.sum()
    w_int = int(round(w * scale))
    mu = total / 2.0
    lo = min(w_int, int(2 * mu) - w_int)
    hi = max(w_int, int(2 * mu) - w_int)
    p = poly[: lo + 1].sum() + poly[hi:].sum()
    return float(min(1.0, p))


def wilcoxon_signed_rank(a, b, *, exact_threshold: int = 25) -> TestResult:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = a - b
    d = d[d != 0]  # standard practice: drop zero differences
    n = d.shape[0]
    if n == 0:
        return TestResult("wilcoxon", 0.0, 1.0, 0)
    order = np.argsort(np.abs(d))
    ranks = np.empty(n, np.float64)
    absd = np.abs(d)[order]
    # average ranks over ties
    i = 0
    while i < n:
        j = i
        while j + 1 < n and absd[j + 1] == absd[i]:
            j += 1
        ranks[i : j + 1] = (i + j) / 2.0 + 1.0
        i = j + 1
    signed = np.empty(n, np.float64)
    signed[order] = ranks
    w_plus = float(signed[d > 0].sum())
    w_minus = float(signed[d < 0].sum())
    w = min(w_plus, w_minus)

    if n <= exact_threshold:
        p = _wilcoxon_exact_p(w_plus, ranks)
        return TestResult("wilcoxon_exact", w, p, n)

    mu = n * (n + 1) / 4.0
    sigma2 = n * (n + 1) * (2 * n + 1) / 24.0
    # tie correction
    _, counts = np.unique(np.abs(d), return_counts=True)
    sigma2 -= np.sum(counts**3 - counts) / 48.0
    if sigma2 <= 0:
        return TestResult("wilcoxon", w, 1.0, n)
    z = (w - mu + 0.5) / math.sqrt(sigma2)  # continuity correction
    p = 2.0 * norm_sf(abs(z))
    return TestResult("wilcoxon", w, min(1.0, p), n)


def permutation_test(
    a, b, *, n_perm: int = 2000, seed: int = 0, stat: str = "mean"
) -> TestResult:
    """Sign-flip permutation test on paired differences."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = a - b
    n = d.shape[0]
    rng = np.random.default_rng(seed)
    observed = abs(d.mean() if stat == "mean" else np.median(d))
    signs = rng.choice([-1.0, 1.0], size=(n_perm, n))
    flipped = signs * d[None, :]
    perm_stats = np.abs(
        flipped.mean(axis=1) if stat == "mean" else np.median(flipped, axis=1)
    )
    p = (1.0 + np.sum(perm_stats >= observed - 1e-15)) / (n_perm + 1.0)
    return TestResult("permutation", float(observed), float(min(1.0, p)), n)
