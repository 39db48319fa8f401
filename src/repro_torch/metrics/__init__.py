from repro_torch.metrics.lexical import (
    batch_lexical,
    bleu,
    contains,
    exact_match,
    normalize,
    rouge_l,
    token_f1,
)
from repro_torch.metrics.registry import (
    BINARY_METRICS,
    MetricContext,
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
    "MetricContext",
    "batch_lexical",
    "bertscore_f1",
    "bleu",
    "contains",
    "embedding_similarity",
    "exact_match",
    "get_metric",
    "normalize",
    "resolve_metrics",
    "rouge_l",
    "token_f1",
]
