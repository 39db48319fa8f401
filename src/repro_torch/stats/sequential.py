"""Anytime-valid confidence sequences and certified verdicts (the port of
``repro/stats/sequential.py``; host f64 math over the O(1) moment state
and the O(B) replicate state, as the port's ``significance.py``).

A fixed-n interval peeked at after every chunk loses its coverage; a
confidence sequence ``CI_n`` holds simultaneously over all n, so a run may
stop the moment it is tight enough, or a verdict is certified, without
breaking it (Robbins' normal mixture; Waudby-Smith et al. 2021).

* ``acs`` (default): the asymptotic sequence with the empirical variance,

      x̄_n ± sqrt( 2(σ̂²ρ²n + 1)/(n²ρ²) · log( sqrt(σ̂²ρ²n + 1)/α ) );

* ``mixture``: the same boundary with an a-priori sub-Gaussian ``scale``
  (1/2 for any [0, 1]-bounded metric) in place of σ̂.

:func:`rho_opt` tunes where the sequence is tightest.  Paired verdicts
(:func:`sequential_compare`) take the paired-delta variance from two
runs' shared Poisson-bootstrap weight streams.  :class:`StoppingRule` is
the per-task early-stopping policy the streaming pipelines consult after
every merged chunk; it is a frozen dataclass, fingerprinted into a spill
manifest's resume contract.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import TYPE_CHECKING, Mapping

if TYPE_CHECKING:  # pragma: no cover — annotation-only import
    from repro_torch.stats.streaming import StreamingStats

#: verdict values produced by :func:`certify_verdict`
VERDICTS = ("a_better", "b_better", "equivalent", "undecided")


@dataclasses.dataclass(frozen=True)
class SeqInterval:
    """One element of a confidence sequence (anytime-valid at level alpha)."""

    value: float
    lo: float
    hi: float
    half_width: float
    n: int
    method: str
    alpha: float

    def as_tuple(self) -> tuple[float, float]:
        return (self.lo, self.hi)


def rho_opt(n_opt: int, alpha: float = 0.05) -> float:
    """Mixture parameter minimizing the boundary width at sample size
    ``n_opt`` (Waudby-Smith et al., eq. for the AsympCS tuning).  Any
    ``rho > 0`` is valid; this only moves where the sequence is tightest.
    """
    if n_opt < 1:
        raise ValueError(f"n_opt must be >= 1, got {n_opt}")
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    la = -2.0 * math.log(alpha)
    return math.sqrt((la + math.log(la + 1.0)) / n_opt)


def mixture_half_width(
    var: float, n: int, *, alpha: float = 0.05, rho: float = 0.0
) -> float:
    """Half-width of the Robbins normal-mixture boundary at sample size n
    for increments of variance ``var`` — the shared kernel of both the
    ``acs`` (plug in σ̂²) and ``mixture`` (plug in a-priori scale²)
    sequences.  Infinite below n=1 so callers never stop on no data."""
    if n < 1:
        return float("inf")
    if rho <= 0.0:
        rho = rho_opt(max(n, 1), alpha)
    vr = var * n * rho * rho + 1.0
    return math.sqrt(
        (2.0 * vr / (n * n * rho * rho)) * math.log(math.sqrt(vr) / alpha)
    )


def sequential_ci(
    acc,
    *,
    alpha: float = 0.05,
    rho: float = 0.0,
    method: str = "acs",
    scale: float = 0.5,
) -> SeqInterval:
    """Anytime-valid CI for a metric mean from its moment accumulator.

    ``acc`` is anything with ``mean`` / ``variance`` / ``n`` — in practice
    a :class:`~repro_torch.stats.streaming.MetricAccumulator`, so the interval
    is computable incrementally after every merged chunk, resumed or live.
    """
    if method not in ("acs", "mixture"):
        raise ValueError(f"unknown sequential method {method!r}")
    n = int(acc.n)
    if n == 0:
        nan = float("nan")
        return SeqInterval(nan, nan, nan, float("inf"), 0, method, alpha)
    # acs needs >= 2 points for a variance estimate; mixture does not
    if method == "acs":
        var = acc.variance if n >= 2 else float("inf")
    else:
        var = scale * scale
    hw = (
        mixture_half_width(var, n, alpha=alpha, rho=rho)
        if math.isfinite(var)
        else float("inf")
    )
    return SeqInterval(
        acc.mean, acc.mean - hw, acc.mean + hw, hw, n, method, alpha
    )


def certify_verdict(lo: float, hi: float, margin: float = 0.0) -> str:
    """Map a CI on (mean_A - mean_B) to a certified verdict.

    * ``a_better`` / ``b_better`` — the interval clears ``±margin``
      entirely (superiority beyond the margin; margin 0 = any difference);
    * ``equivalent`` — the interval is contained in ``(-margin, margin)``
      (only reachable with ``margin > 0``);
    * ``undecided`` — keep sampling.

    Because the interval is anytime-valid, a certified verdict is wrong
    with probability at most alpha *regardless of the stopping rule*.
    """
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return "undecided"
    if lo > margin:
        return "a_better"
    if hi < -margin:
        return "b_better"
    if margin > 0.0 and lo > -margin and hi < margin:
        return "equivalent"
    return "undecided"


@dataclasses.dataclass(frozen=True)
class SequentialComparison:
    """Anytime-valid paired comparison of two streaming runs on one metric."""

    metric: str
    mean_a: float
    mean_b: float
    diff: float
    lo: float
    hi: float
    half_width: float
    n: int
    verdict: str
    alpha: float
    margin: float
    #: True when the delta variance came from shared-weight-stream
    #: replicate deltas; False = conservative unpaired var_a + var_b
    paired: bool

    def summary(self) -> str:
        return (
            f"{self.metric}: Δ={self.diff:+.4f} "
            f"CS=({self.lo:+.4f},{self.hi:+.4f}) n={self.n} "
            f"verdict={self.verdict} (margin={self.margin:g}, "
            f"alpha={self.alpha:g}, {'paired' if self.paired else 'unpaired'})"
        )


def paired_delta_variance(
    metric: str, a: "StreamingStats", b: "StreamingStats"
) -> tuple[float, bool]:
    """Per-example variance of the paired score delta, and whether it was
    actually paired.

    The replicate-mean deltas of two runs sharing a weight stream have
    variance ~ Var(x_A - x_B)/n (the paired bootstrap), so scaling back by
    n recovers the per-example delta variance — free from the replicate
    state, no per-example scores.  Falls back to the unpaired upper bound
    ``var_a + var_b`` (correlation ignored) when replicate state is absent
    or the streams are not shared.
    """
    acc_a, acc_b = a.accs[metric], b.accs[metric]
    n = min(acc_a.n, acc_b.n)
    if (
        a.engine is not None
        and b.engine is not None
        and a.comparable_with(b) is None
        and n >= 2
    ):
        import numpy as np

        deltas = a.engine.view(metric).means() - b.engine.view(metric).means()
        var = float(np.var(deltas, ddof=1)) * n
        if math.isfinite(var):
            return max(var, 0.0), True
    return acc_a.variance + acc_b.variance, False


def sequential_compare(
    metric: str,
    a: "StreamingStats",
    b: "StreamingStats",
    *,
    alpha: float = 0.05,
    margin: float = 0.0,
    rho: float = 0.0,
    method: str = "acs",
) -> SequentialComparison:
    """Anytime-valid CI + certified verdict on mean_A - mean_B.

    Safe to call after every round of an adaptive suite: the confidence
    sequence keeps its level under continued monitoring, so the first
    round whose verdict is not ``undecided`` may stop sampling the pair.
    """
    acc_a, acc_b = a.accs[metric], b.accs[metric]
    n = min(acc_a.n, acc_b.n)
    diff = acc_a.mean - acc_b.mean
    var_d, paired = paired_delta_variance(metric, a, b)
    if method == "mixture":
        # deltas of [0,1]-bounded scores live in [-1,1]: scale 1
        hw = mixture_half_width(1.0, n, alpha=alpha, rho=rho)
    else:
        hw = (
            mixture_half_width(var_d, n, alpha=alpha, rho=rho)
            if n >= 2
            else float("inf")
        )
    lo, hi = diff - hw, diff + hw
    return SequentialComparison(
        metric=metric,
        mean_a=acc_a.mean,
        mean_b=acc_b.mean,
        diff=diff,
        lo=lo,
        hi=hi,
        half_width=hw,
        n=n,
        verdict=certify_verdict(lo, hi, margin),
        alpha=alpha,
        margin=margin,
        paired=paired,
    )


# -- per-task early stopping ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StopDecision:
    stop: bool
    reason: str = ""          # "" | "target_half_width" | "max_examples"
    metric: str = ""
    half_width: float = float("inf")
    n: int = 0


@dataclasses.dataclass(frozen=True)
class StoppingRule:
    """Per-task early-stopping policy, consulted after every merged chunk.

    Lives on :class:`~repro_torch.core.config.EvalTask` (``task.stopping``,
    ``task.with_stopping(...)``).  The statistical fields are part of the
    spill-manifest resume contract (:meth:`fingerprint`): a resumed run
    must certify under the *same* rule that wrote the manifest, or refuse
    — mixing stopping regimes inside one manifest would make the recorded
    stop point meaningless.

    * ``target_half_width`` — stop once the anytime-valid CI half-width of
      ``metric`` (or of *every* metric when ``metric`` is empty) is at or
      below this; 0 disables the width trigger.
    * ``max_examples`` — hard sampling cap; reaching it is a final stop
      with reason ``max_examples`` (verdict possibly undecided).  0 means
      unbounded.  Round-level caps belong to the budget scheduler
      (:mod:`repro_torch.core.budget`), which slices the source instead.
    * ``min_examples`` — never stop before this many scored examples; also
      the sample size :func:`rho_opt` tunes the sequence to be tightest at
      when ``rho`` is 0 (auto).
    * ``margin`` — certification margin used for paired verdicts at the
      suite level; carried here so one rule object describes the whole
      certification regime.
    """

    enabled: bool = False
    metric: str = ""
    target_half_width: float = 0.0
    margin: float = 0.0
    min_examples: int = 256
    max_examples: int = 0
    alpha: float = 0.05
    rho: float = 0.0
    method: str = "acs"       # acs | mixture

    def effective_rho(self) -> float:
        if self.rho > 0.0:
            return self.rho
        return rho_opt(max(self.min_examples, 2), self.alpha)

    def fingerprint(self) -> str:
        """Identity of the certification regime — every statistical field.
        Two rules with equal fingerprints make bit-identical stop
        decisions on the same accumulator stream."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def ci(self, acc) -> SeqInterval:
        return sequential_ci(
            acc, alpha=self.alpha, rho=self.effective_rho(), method=self.method
        )

    def should_stop(self, accs: Mapping[str, object], n_examples: int) -> StopDecision:
        """Decide after a merged chunk.  Deterministic in (rule, accs):
        resumed runs replay the identical decision sequence."""
        if not self.enabled:
            return StopDecision(False)
        watched = [self.metric] if self.metric else sorted(accs)
        missing = [m for m in watched if m not in accs]
        if missing:
            raise KeyError(
                f"stopping rule watches unknown metric(s) {missing}; "
                f"task computes {sorted(accs)}"
            )
        widths = {m: self.ci(accs[m]).half_width for m in watched}
        worst = max(watched, key=lambda m: widths[m])
        if n_examples < self.min_examples:
            return StopDecision(False)
        if self.target_half_width > 0.0 and all(
            widths[m] <= self.target_half_width for m in watched
        ):
            return StopDecision(
                True, "target_half_width", worst, widths[worst], n_examples
            )
        if self.max_examples > 0 and n_examples >= self.max_examples:
            return StopDecision(
                True, "max_examples", worst, widths[worst], n_examples
            )
        return StopDecision(False)
