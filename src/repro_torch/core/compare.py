"""Model comparison (the port of ``repro/core/compare.py``, paper sections
4.3-4.4): a paired significance test selected per Table 2, an effect size,
and the interval of the per-example difference.

* :func:`compare_scores`: the in-memory path, on aligned per-example
  score vectors.
* :func:`compare_stream_stats`: the streaming path, on the replicate state
  two runs carry in :class:`~repro_torch.stats.streaming.StreamingStats`.
  A Poisson-bootstrap weight depends only on ``(seed, example position)``,
  never on the model, so two runs over the same chunk layout share their
  weight streams replicate for replicate, and the difference of their
  replicate means is the paired bootstrap distribution of the mean
  difference.  Under ``backend="device"`` those replicates are kernel 6's
  partials.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.stages import EvalResult
from repro_torch.device import resolve_device
from repro_torch.stats.bootstrap import compute_ci, replicate_p_value
from repro_torch.stats.effect import (
    EffectSize,
    hedges_g,
    hedges_g_from_moments,
    odds_ratio,
)
from repro_torch.stats.select import TestRecommendation, recommend_test, run_recommended
from repro_torch.stats.significance import TestResult
from repro_torch.stats.streaming import StreamingStats


@dataclasses.dataclass
class Comparison:
    metric: str
    mean_a: float
    mean_b: float
    diff: float
    diff_ci: tuple[float, float]
    test: TestResult
    recommendation: TestRecommendation
    effect: EffectSize
    n: int

    def summary(self, alpha: float = 0.05) -> str:
        sig = "SIGNIFICANT" if self.test.p_value < alpha else "not significant"
        return (
            f"{self.metric}: A={self.mean_a:.4f} B={self.mean_b:.4f} "
            f"Δ={self.diff:+.4f} CI=({self.diff_ci[0]:+.4f},{self.diff_ci[1]:+.4f}) "
            f"{self.test.test} p={self.test.p_value:.4g} [{sig}] "
            f"{self.effect.name}={self.effect.value:.3f} ({self.effect.magnitude})"
        )


def compare_scores(
    metric: str,
    a: np.ndarray,
    b: np.ndarray,
    *,
    confidence: float = 0.95,
    n_boot: int = 1000,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> Comparison:
    """Paired comparison on aligned per-example score vectors.  The test,
    its recommendation and the effect size are host float64, the
    reference's bit for bit; the percentile interval of the mean difference
    resamples on ``device`` (the card when None) with the port's
    ``compute_ci``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    keep = ~(np.isnan(a) | np.isnan(b))
    a, b = a[keep], b[keep]
    rec = recommend_test(a, b)
    test = run_recommended(a, b, seed=seed)
    binary = rec.test == "mcnemar"
    effect = odds_ratio(a, b) if binary else hedges_g(a, b)
    diff = a - b
    iv = compute_ci(
        diff, method="percentile", confidence=confidence, n_boot=n_boot,
        seed=seed, device=resolve_device(device),
    )
    return Comparison(
        metric=metric,
        mean_a=float(a.mean()),
        mean_b=float(b.mean()),
        diff=float(diff.mean()),
        diff_ci=(iv.lo, iv.hi),
        test=test,
        recommendation=rec,
        effect=effect,
        n=len(a),
    )


def compare_stream_stats(
    metric: str,
    a: StreamingStats,
    b: StreamingStats,
    *,
    confidence: float = 0.95,
) -> Comparison:
    """Paired comparison from two streaming runs' replicate states.

    Valid only when ``a.comparable_with(b)`` is None (same seed, B,
    backend and chunk layout — i.e. shared weight streams); callers
    gate on that.  The test is the paired-delta bootstrap: a CI-inversion
    p-value on the replicate-delta distribution, reported as
    ``paired_bootstrap``.  Effect size is Hedges' g from the two arms'
    moments (the discordant-pair table McNemar needs is not recoverable
    from O(B) state, so binary metrics use the same delta test).
    """
    reason = a.comparable_with(b)
    if reason is not None:
        raise ValueError(f"streaming runs are not paired-comparable: {reason}")
    acc_a, acc_b = a.accs[metric], b.accs[metric]
    deltas = a.engine.view(metric).means() - b.engine.view(metric).means()
    diff = acc_a.mean - acc_b.mean
    alpha = (1 - confidence) / 2
    lo, hi = np.quantile(deltas, [alpha, 1 - alpha])
    se = float(deltas.std(ddof=1)) if deltas.size > 1 else 0.0
    n = min(acc_a.n, acc_b.n)
    test = TestResult(
        "paired_bootstrap",
        diff / se if se > 0 else 0.0,
        replicate_p_value(deltas),
        n,
        detail={"n_boot": int(deltas.size), "backend": a.engine.backend},
    )
    rec = TestRecommendation(
        "paired_bootstrap",
        "streaming: paired Poisson-bootstrap replicate deltas over shared "
        f"weight streams (B={deltas.size}), per-example scores not retained",
    )
    effect = hedges_g_from_moments(
        acc_a.mean, acc_a.variance, acc_a.n,
        acc_b.mean, acc_b.variance, acc_b.n,
    )
    return Comparison(
        metric=metric,
        mean_a=acc_a.mean,
        mean_b=acc_b.mean,
        diff=diff,
        diff_ci=(float(lo), float(hi)),
        test=test,
        recommendation=rec,
        effect=effect,
        n=n,
    )


def compare_results(
    res_a: EvalResult, res_b: EvalResult, **kw
) -> dict[str, Comparison]:
    out: dict[str, Comparison] = {}
    for metric in res_a.scores:
        if metric not in res_b.scores:
            continue
        out[metric] = compare_scores(
            metric, res_a.scores[metric], res_b.scores[metric], **kw
        )
    return out
