"""The evaluation stages of ``repro/core/stages.py``: each is
``run(artifact, session) -> artifact`` over one :class:`EvalArtifact`.  The
in-memory pipeline (:func:`default_stages`) is prepare -> infer -> score ->
aggregate over the whole task; the streaming pipeline runs the first three
per chunk and aggregates from mergeable state instead."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.config import EvalTask
from repro_torch.core.engines import InferenceRequest, InferenceResponse
from repro_torch.data.templates import render
from repro_torch.metrics.registry import (
    BINARY_METRICS,
    MetricContext,
    resolve_metrics,
)
from repro_torch.stats.bootstrap import compute_ci


@dataclasses.dataclass
class MetricValue:
    name: str
    value: float
    ci: tuple[float, float]
    ci_method: str
    n: int
    n_unscored: int = 0

    def __repr__(self) -> str:
        return (
            f"MetricValue(value={self.value:.3f}, "
            f"ci=({self.ci[0]:.3f}, {self.ci[1]:.3f}), n={self.n})"
        )


@dataclasses.dataclass
class EvalResult:
    task_id: str
    metrics: dict[str, MetricValue]
    engine_stats: dict
    timing: dict
    logs: dict
    #: streaming runs only: merged accumulator and bootstrap-replicate state
    stream_stats: Any = None
    #: in-memory runs only: per-example scores by metric and the responses
    scores: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    responses: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EvalArtifact:
    """The rows of a task (or of one chunk) flowing through the stages:
    ``PrepareStage`` fills ``prompts``, ``InferStage`` ``texts`` and
    ``failures``, ``ScoreStage`` ``scores``, ``AggregateStage``
    ``metrics``; the session records each stage's seconds in ``timing``."""

    rows: list[dict]
    task: EvalTask
    prompts: list[str] = dataclasses.field(default_factory=list)
    texts: list[str] = dataclasses.field(default_factory=list)
    failures: list[dict] = dataclasses.field(default_factory=list)
    scores: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    metrics: dict[str, MetricValue] = dataclasses.field(default_factory=dict)
    timing: dict = dataclasses.field(default_factory=dict)

    def to_result(self, engine_stats: dict) -> EvalResult:
        return EvalResult(
            task_id=self.task.task_id,
            metrics=self.metrics,
            engine_stats=engine_stats,
            timing=self.timing,
            logs={},
            scores=self.scores,
            responses=self.texts,
        )


class PrepareStage:
    name = "prepare"

    def run(self, art: EvalArtifact, session: Any) -> EvalArtifact:
        # fail fast on unknown metrics before any inference happens
        resolve_metrics(art.task.metrics)
        art.prompts = [render(art.task.data.prompt_template, r) for r in art.rows]
        return art


class InferStage:
    """Submit the chunk's prompts to the session's engine, then pump the
    engine until every one of them has come back."""

    name = "infer"

    def run(self, art: EvalArtifact, session: Any) -> EvalArtifact:
        model = art.task.model
        engine = session.engine_for(model, art.task.inference)
        pending = {
            engine.stream_submit(
                InferenceRequest(p, model.max_tokens, model.temperature)
            ): i
            for i, p in enumerate(art.prompts)
        }
        responses: list[InferenceResponse | None] = [None] * len(art.prompts)
        while pending:
            done = engine.stream_pump()
            if not done and not engine.stream_pending():
                raise RuntimeError(f"engine lost {len(pending)} requests")
            for rid, resp in done:
                if rid in pending:
                    responses[pending.pop(rid)] = resp
        art.texts = [r.text if r.error is None else "" for r in responses]
        art.failures = [
            {"index": i, "error": r.error}
            for i, r in enumerate(responses)
            if r.error is not None
        ]
        return art


class ScoreStage:
    name = "metrics"

    def run(self, art: EvalArtifact, session: Any) -> EvalArtifact:
        ctx = MetricContext(device=session.device)
        art.scores = {
            name: np.asarray(scorer(art.rows, art.texts, ctx), np.float64)
            for name, scorer in resolve_metrics(art.task.metrics)
        }
        return art


class AggregateStage:
    """Each metric's value and interval from its per-example scores, NaN
    (unscorable) examples left out: ``compute_ci`` with the task's
    statistics settings, Wilson under ``analytical`` for binary metrics.
    The bootstrap methods resample on the session's device."""

    name = "stats"

    def run(self, art: EvalArtifact, session: Any) -> EvalArtifact:
        stats_cfg = art.task.statistics
        metric_values: dict[str, MetricValue] = {}
        for name, vals in art.scores.items():
            nan_mask = np.isnan(vals)
            ok = vals[~nan_mask]
            n_unscored = int(nan_mask.sum())
            if len(ok) == 0:
                metric_values[name] = MetricValue(
                    name, float("nan"), (float("nan"),) * 2, "none", 0, n_unscored
                )
                continue
            iv = compute_ci(
                ok,
                method=stats_cfg.ci_method,
                confidence=stats_cfg.confidence_level,
                n_boot=stats_cfg.bootstrap_iterations,
                seed=stats_cfg.seed,
                binary=name in BINARY_METRICS,
                device=session.device,
            )
            metric_values[name] = MetricValue(
                name, iv.value, (iv.lo, iv.hi), iv.method, iv.n, n_unscored
            )
        art.metrics = metric_values
        return art


def default_stages() -> list:
    return [PrepareStage(), InferStage(), ScoreStage(), AggregateStage()]
