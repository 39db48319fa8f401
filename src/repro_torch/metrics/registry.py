"""Metric resolution (``repro/metrics/registry.py``): ``MetricConfig`` ->
batch scorer ``fn(rows, responses, ctx) -> np.ndarray`` of per-example
scores (NaN = unscorable, left out of the aggregate and counted), with the
config's ``params`` bound as the reference's ``get_metric`` binds them.
``ctx`` carries what scorers share: the judge engine, the embedder (the
default hash embedder when None), the logs the judge's unparseable answers
go to, and the device BERTScore runs on."""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.metrics import lexical, rag, semantic
from repro_torch.metrics.judge import pointwise_judge

if TYPE_CHECKING:  # core imports this module; keep the import one-way
    from repro_torch.core.config import MetricConfig


@dataclasses.dataclass
class MetricContext:
    judge_engine: Any = None
    embedder: semantic.HashEmbedder | None = None
    logs: dict = dataclasses.field(default_factory=dict)
    #: where BERTScore's kernel runs (None: the card)
    device: torch.device | None = None


Scorer = Callable[[list[dict], list[str], MetricContext], np.ndarray]
#: metrics whose scores are 0/1 (their analytical interval is Wilson's)
BINARY_METRICS = {"exact_match", "contains"}
#: metrics that grade with ``ctx.judge_engine`` (the score stage sets one up)
JUDGE_METRICS = {"llm_judge", "faithfulness", "context_relevance"}


def _refs(rows: list[dict]) -> list[str]:
    return [str(r.get("reference", "")) for r in rows]


def _questions(rows: list[dict]) -> list[str]:
    return [str(r.get("question", "")) for r in rows]


def _contexts(rows: list[dict]) -> list[list[str]]:
    return [list(r.get("contexts", [])) for r in rows]


def _judge_of(ctx: MetricContext, metric: str):
    if ctx.judge_engine is None:
        raise ValueError(f"{metric} needs a judge engine")
    return ctx.judge_engine


def _lexical(name: str) -> Scorer:
    def scorer(rows, responses, ctx, **kw):
        return lexical.batch_lexical(name, responses, _refs(rows), **kw)

    return scorer


def _embed_sim(rows, responses, ctx, **kw):
    return semantic.embedding_similarity(responses, _refs(rows), ctx.embedder)


def _bertscore(rows, responses, ctx, **kw):
    return semantic.bertscore_f1(
        responses, _refs(rows), embedder=ctx.embedder, device=ctx.device, **kw
    )


def _llm_judge(rows, responses, ctx, *, rubric: str = "helpfulness", scale: int = 5):
    outcome = pointwise_judge(
        _judge_of(ctx, "llm_judge"), _questions(rows), responses,
        rubric=rubric, scale=scale,
    )
    ctx.logs.setdefault("judge_unparseable", []).extend(outcome.unparseable)
    return outcome.scores


def _faithfulness(rows, responses, ctx, **kw):
    return rag.faithfulness(
        _judge_of(ctx, "faithfulness"), responses, _contexts(rows), **kw
    )


def _context_relevance(rows, responses, ctx, **kw):
    return rag.context_relevance(
        _judge_of(ctx, "context_relevance"), _questions(rows), _contexts(rows), **kw
    )


def _answer_relevance(rows, responses, ctx, **kw):
    return rag.answer_relevance(_questions(rows), responses, ctx.embedder)


def _context_precision(rows, responses, ctx, **kw):
    return rag.context_precision(_contexts(rows), _refs(rows), **kw)


def _context_recall(rows, responses, ctx, **kw):
    return rag.context_recall(_contexts(rows), _refs(rows))


_REGISTRY: dict[str, Scorer] = {
    **{name: _lexical(name) for name in lexical.SCALAR},
    "embedding_similarity": _embed_sim,
    "bertscore": _bertscore,
    "llm_judge": _llm_judge,
    "faithfulness": _faithfulness,
    "context_relevance": _context_relevance,
    "answer_relevance": _answer_relevance,
    "context_precision": _context_precision,
    "context_recall": _context_recall,
}


def get_metric(cfg: "MetricConfig") -> Scorer:
    if cfg.name not in _REGISTRY:
        raise KeyError(
            f"unknown metric {cfg.name!r}; available: {sorted(_REGISTRY)}"
        )
    base = _REGISTRY[cfg.name]
    if cfg.name == "bertscore":
        semantic.check_bertscore(**cfg.params)
    if cfg.params:
        return lambda rows, resp, ctx: base(rows, resp, ctx, **cfg.params)
    return base


def resolve_metrics(cfgs: Sequence["MetricConfig"]) -> list[tuple[str, Scorer]]:
    """Resolve a task's metric configs to bound scorers; unknown ones, and
    a BERTScore shape the kernel cannot take, raise before any inference
    runs."""
    return [(cfg.name, get_metric(cfg)) for cfg in cfgs]


def available_metrics() -> list[str]:
    return sorted(_REGISTRY)
