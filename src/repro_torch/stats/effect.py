"""Effect sizes (the port's copy of ``repro/stats/effect.py``, paper
section 4.4): Cohen's d, Hedges' g (from arrays or from streaming moments)
and the odds ratio."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class EffectSize:
    name: str
    value: float
    magnitude: str  # negligible | small | medium | large


def _magnitude(d: float) -> str:
    ad = abs(d)
    if ad < 0.2:
        return "negligible"
    if ad < 0.5:
        return "small"
    if ad < 0.8:
        return "medium"
    return "large"


def _d_from_moments(
    mean_a: float, var_a: float, n_a: int,
    mean_b: float, var_b: float, n_b: int,
) -> float:
    """Cohen's d from sufficient statistics (single home of the
    pooled-SD formula; both the array and the streaming-moments fronts
    delegate here)."""
    pooled = math.sqrt(
        ((n_a - 1) * var_a + (n_b - 1) * var_b) / max(n_a + n_b - 2, 1)
    )
    return (mean_a - mean_b) / pooled if pooled > 0 else 0.0


def _j_correction(n: int) -> float:
    """Hedges' small-sample correction factor."""
    return 1.0 - 3.0 / (4.0 * (n - 2) - 1.0) if n > 2 else 1.0


def cohens_d(a, b) -> EffectSize:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    na, nb = len(a), len(b)
    d = _d_from_moments(
        float(a.mean()), a.var(ddof=1) if na > 1 else 0.0, na,
        float(b.mean()), b.var(ddof=1) if nb > 1 else 0.0, nb,
    )
    return EffectSize("cohens_d", float(d), _magnitude(d))


def hedges_g(a, b) -> EffectSize:
    g = cohens_d(a, b).value * _j_correction(len(a) + len(b))
    return EffectSize("hedges_g", float(g), _magnitude(g))


def hedges_g_from_moments(
    mean_a: float, var_a: float, n_a: int,
    mean_b: float, var_b: float, n_b: int,
) -> EffectSize:
    """Hedges' g from sufficient statistics (streaming runs keep moments,
    not per-example scores); identical to :func:`hedges_g` on the same
    data up to float summation order."""
    d = _d_from_moments(mean_a, var_a, n_a, mean_b, var_b, n_b)
    g = d * _j_correction(n_a + n_b)
    return EffectSize("hedges_g", float(g), _magnitude(g))


def odds_ratio(a, b, *, haldane: bool = True) -> EffectSize:
    """Binary outcomes; Haldane-Anscombe 0.5 correction for zero cells."""
    a = np.asarray(a).astype(bool)
    b = np.asarray(b).astype(bool)
    sa, fa = float(a.sum()), float((~a).sum())
    sb, fb = float(b.sum()), float((~b).sum())
    if haldane and 0.0 in (sa, fa, sb, fb):
        sa, fa, sb, fb = sa + 0.5, fa + 0.5, sb + 0.5, fb + 0.5
    oratio = (sa / fa) / (sb / fb)
    # magnitude buckets via log-odds ~ d conversion (Chinn 2000: d = ln(OR)/1.81)
    d_equiv = math.log(oratio) / 1.81 if oratio > 0 else 0.0
    return EffectSize("odds_ratio", float(oratio), _magnitude(d_equiv))
