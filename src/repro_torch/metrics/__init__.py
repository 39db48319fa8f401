from repro_torch.metrics.judge import (
    JudgeOutcome,
    extract_score,
    pairwise_judge,
    pointwise_judge,
)
from repro_torch.metrics.lexical import (
    batch_lexical,
    bleu,
    contains,
    exact_match,
    normalize,
    rouge_l,
    token_f1,
)
from repro_torch.metrics.rag import (
    answer_relevance,
    context_precision,
    context_recall,
    context_relevance,
    faithfulness,
)
from repro_torch.metrics.registry import (
    BINARY_METRICS,
    JUDGE_METRICS,
    MetricContext,
    available_metrics,
    get_metric,
    resolve_metrics,
)
from repro_torch.metrics.semantic import (
    HashEmbedder,
    bertscore_f1,
    embedding_similarity,
)

__all__ = [
    "BINARY_METRICS",
    "HashEmbedder",
    "JUDGE_METRICS",
    "JudgeOutcome",
    "MetricContext",
    "answer_relevance",
    "available_metrics",
    "batch_lexical",
    "bertscore_f1",
    "bleu",
    "contains",
    "context_precision",
    "context_recall",
    "context_relevance",
    "embedding_similarity",
    "exact_match",
    "extract_score",
    "faithfulness",
    "get_metric",
    "normalize",
    "pairwise_judge",
    "pointwise_judge",
    "resolve_metrics",
    "rouge_l",
    "token_f1",
]
