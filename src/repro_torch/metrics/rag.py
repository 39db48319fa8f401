"""RAG metrics (``repro/metrics/rag.py``, after RAGAS): faithfulness and
context relevance graded by a judge engine, answer relevance by embedding
cosine, context precision and recall by token overlap with the
reference."""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.metrics.judge import pointwise_judge
from repro_torch.metrics.lexical import normalize, token_f1
from repro_torch.metrics.semantic import HashEmbedder, embedding_similarity


def faithfulness(
    engine: Any,
    answers: list[str],
    contexts: list[list[str]],
    *,
    scale: int = 5,
) -> np.ndarray:
    """Is the answer supported by its context?  The judge's 1-``scale``
    grade mapped to [0, 1]."""
    questions = [
        "Is the response fully supported by this context? Context: " + " ".join(ctx)
        for ctx in contexts
    ]
    outcome = pointwise_judge(
        engine, questions, answers,
        rubric="groundedness: every claim must appear in the context",
        scale=scale,
    )
    return (outcome.scores - 1.0) / (scale - 1.0)


def context_relevance(
    engine: Any,
    questions: list[str],
    contexts: list[list[str]],
    *,
    scale: int = 5,
) -> np.ndarray:
    outcome = pointwise_judge(
        engine,
        questions,
        [" ".join(ctx) for ctx in contexts],
        rubric="relevance of the retrieved context to the question",
        scale=scale,
    )
    return (outcome.scores - 1.0) / (scale - 1.0)


def answer_relevance(
    questions: list[str],
    answers: list[str],
    embedder: HashEmbedder | None = None,
) -> np.ndarray:
    """Embedding cosine between question and answer."""
    return embedding_similarity(answers, questions, embedder)


def context_precision(
    contexts: list[list[str]],
    references: list[str],
    *,
    overlap_threshold: float = 0.35,
) -> np.ndarray:
    """Mean precision@k over the retrieval ranking, a chunk counting as
    relevant where its token F1 with the reference clears the threshold;
    0 where no chunk is relevant."""
    out = np.zeros(len(contexts))
    for i, (chunks, ref) in enumerate(zip(contexts, references)):
        rel = [token_f1(c, ref) >= overlap_threshold for c in chunks]
        if not any(rel):
            continue
        hits = 0
        precisions = []
        for k, r in enumerate(rel, 1):
            if r:
                hits += 1
                precisions.append(hits / k)
        out[i] = float(np.mean(precisions))
    return out


def context_recall(contexts: list[list[str]], references: list[str]) -> np.ndarray:
    """Fraction of the reference's tokens found in the retrieved context
    (1 for an empty reference)."""
    out = np.zeros(len(contexts))
    for i, (chunks, ref) in enumerate(zip(contexts, references)):
        ref_tokens = set(normalize(ref).split())
        if not ref_tokens:
            out[i] = 1.0
            continue
        ctx_tokens = set(normalize(" ".join(chunks)).split())
        out[i] = len(ref_tokens & ctx_tokens) / len(ref_tokens)
    return out
