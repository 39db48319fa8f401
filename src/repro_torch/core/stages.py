"""Per-chunk stages of the streaming evaluation (the prepare, infer and score
stages of ``repro/core/stages.py``): each is ``run(artifact, session) ->
artifact`` over one :class:`EvalArtifact`."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.config import EvalTask
from repro_torch.core.engines import InferenceRequest, InferenceResponse
from repro_torch.data.templates import render
from repro_torch.metrics.registry import MetricContext, resolve_metrics


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
    #: merged accumulator and bootstrap-replicate state of the run
    stream_stats: Any = None


@dataclasses.dataclass
class EvalArtifact:
    """One chunk flowing through the stages: ``PrepareStage`` fills
    ``prompts``, ``InferStage`` ``texts``/``failures``,
    ``ScoreStage`` ``scores``."""

    rows: list[dict]
    task: EvalTask
    prompts: list[str] = dataclasses.field(default_factory=list)
    texts: list[str] = dataclasses.field(default_factory=list)
    failures: list[dict] = dataclasses.field(default_factory=list)
    scores: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


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
