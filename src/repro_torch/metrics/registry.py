"""Metric resolution: ``MetricConfig`` -> batch scorer
``fn(rows, responses, ctx) -> np.ndarray`` of per-example scores (NaN =
unscorable), with the config's ``params`` bound as the reference's
``get_metric`` binds them.  ``ctx`` carries the device the semantic
metrics run on; they use the default hash embedder.  The port resolves
the lexical and semantic metrics; the judge and RAG metrics raise before
any inference runs, as unknown metrics do."""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

from repro_torch.metrics import lexical, semantic

if TYPE_CHECKING:  # core imports this module; keep the import one-way
    from repro_torch.core.config import MetricConfig


@dataclasses.dataclass
class MetricContext:
    #: where the semantic metrics' kernels run (None: the card)
    device: torch.device | None = None


Scorer = Callable[[list[dict], list[str], MetricContext], np.ndarray]
#: metrics whose scores are 0/1 (their analytical interval is Wilson's)
BINARY_METRICS = {"exact_match", "contains"}


def _refs(rows: list[dict]) -> list[str]:
    return [str(r.get("reference", "")) for r in rows]


def _lexical(name: str) -> Scorer:
    def scorer(rows, responses, ctx, **kw):
        return lexical.batch_lexical(name, responses, _refs(rows), **kw)

    return scorer


def _embed_sim(rows, responses, ctx, **kw):
    return semantic.embedding_similarity(responses, _refs(rows))


def _bertscore(rows, responses, ctx, **kw):
    return semantic.bertscore_f1(responses, _refs(rows), device=ctx.device, **kw)


_REGISTRY: dict[str, Scorer] = {
    **{name: _lexical(name) for name in lexical.SCALAR},
    "embedding_similarity": _embed_sim,
    "bertscore": _bertscore,
}


def get_metric(cfg: "MetricConfig") -> Scorer:
    if cfg.name not in _REGISTRY:
        raise KeyError(
            f"metric {cfg.name!r} is not ported; available: {sorted(_REGISTRY)}"
        )
    base = _REGISTRY[cfg.name]
    if cfg.params:
        return lambda rows, resp, ctx: base(rows, resp, ctx, **cfg.params)
    return base


def resolve_metrics(cfgs: Sequence["MetricConfig"]) -> list[tuple[str, Scorer]]:
    """Resolve a task's metric configs to bound scorers; unknown ones raise
    before any inference runs."""
    return [(cfg.name, get_metric(cfg)) for cfg in cfgs]
