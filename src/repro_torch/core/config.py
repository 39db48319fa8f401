"""Evaluation-task configuration: the parts of ``repro/core/config.py`` that
the port's in-memory and streaming paths, its inference service, response
cache and suites read.  A task serializes to JSON (``EvalTask.to_json``)."""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Any


class CachePolicy(str, enum.Enum):
    ENABLED = "enabled"      # lookup before inference, cache new responses
    READ_ONLY = "read_only"  # lookup only
    WRITE_ONLY = "write_only"  # cache warming: always infer, always cache
    REPLAY = "replay"        # strict: error on cache miss (zero engine calls)
    DISABLED = "disabled"


@dataclasses.dataclass(frozen=True)
class EngineModelConfig:
    """Which model answers the prompts.  The port's local engine has its
    own provider name, so a response cache keyed by provider never hands
    JAX-engine answers to the port or back."""

    provider: str = "torch_local"
    model_name: str = "qwen3-4b"
    temperature: float = 0.0
    max_tokens: int = 64
    reduced: bool = True             # serve the reduced config (CPU tests)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MetricConfig:
    name: str                         # registry key, e.g. "exact_match"
    type: str = "lexical"             # lexical | semantic | llm_judge | rag
    #: keyword arguments bound to the scorer, e.g. {"max_len": 32} for
    #: bertscore or {"normalized": False} for exact_match and contains
    #: left out of the hash (a dict has none), so a task stays hashable
    params: dict = dataclasses.field(default_factory=dict, hash=False)


@dataclasses.dataclass(frozen=True)
class StatisticsConfig:
    confidence_level: float = 0.95
    bootstrap_iterations: int = 1000
    ci_method: str = "bca"            # percentile | bca | analytical
    significance_threshold: float = 0.05
    seed: int = 0
    #: streaming replicate state: "numpy" = host Philox(seed, chunk_start)
    #: weight blocks (the reference's default); "device" = the
    #: bootstrap-partials kernel, one launch a chunk ("pallas" names the same
    #: weight stream).  The two draw different weights.
    backend: str = "numpy"


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Bounded-memory chunked execution.  When ``enabled``, the session
    prepares, infers and scores one chunk of ``max_memory_rows`` examples
    at a time, folding scores into mergeable accumulators, so peak
    per-example state is one chunk; otherwise (the default, as in the
    reference) it runs the stages over the whole task in memory and keeps
    the per-example scores."""

    enabled: bool = False
    max_memory_rows: int = 1024


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """How the task's prompts reach the engine (the fields of
    ``repro/core/config.py:InferenceConfig`` that the port reads), with the
    reference's defaults."""

    #: prompts per shard: the unit of per-shard cache and call accounting
    batch_size: int = 16
    cache_policy: CachePolicy = CachePolicy.ENABLED
    #: "" = no response cache
    cache_dir: str = ""
    #: outstanding requests the service queue holds before submit blocks
    service_queue_depth: int = 256
    #: single-flight coalescing of identical in-flight cache keys
    coalesce: bool = True
    #: batch-formation window of a cold batcher loop
    max_batch_wait_ms: float = 2.0
    #: at most this many prompts prefilled per batcher step (0 = unlimited)
    max_prefills_per_step: int = 0
    #: 0 = contiguous per-slot KV cache; > 0 = page pool with this many
    #: tokens per page and hash-chain prompt-prefix sharing (DESIGN.md §8)
    kv_page_size: int = 0
    #: with a paged cache, share resident prompt-prefix pages across requests
    prefix_cache: bool = True
    #: page storage: "bf16" = full-precision pages (f32, as the reference's
    #: pool), "int8" = absmax-quantized pages with per-(page, KV head) f32
    #: scales (DESIGN.md §10); int8 requires kv_page_size > 0
    kv_cache_dtype: str = "bf16"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    prompt_template: str = "{question}"


@dataclasses.dataclass(frozen=True)
class EvalTask:
    task_id: str
    model: EngineModelConfig = EngineModelConfig()
    inference: InferenceConfig = InferenceConfig()
    metrics: tuple[MetricConfig, ...] = (MetricConfig("exact_match"),)
    statistics: StatisticsConfig = StatisticsConfig()
    data: DataConfig = DataConfig()
    streaming: StreamingConfig = StreamingConfig()

    def with_model(self, model: EngineModelConfig) -> "EvalTask":
        """Rebind the task to another model (suite model sweeps)."""
        return dataclasses.replace(self, model=model)

    def with_streaming(self, **kw: Any) -> "EvalTask":
        """Enable (or reconfigure) streaming execution; unspecified fields
        keep their current values."""
        kw.setdefault("enabled", True)
        return dataclasses.replace(
            self, streaming=dataclasses.replace(self.streaming, **kw)
        )

    def with_metrics(self, *metrics: MetricConfig) -> "EvalTask":
        """Rebind the metric set (cache-replay metric iteration)."""
        return dataclasses.replace(self, metrics=tuple(metrics))

    def to_json(self) -> str:
        def default(o: Any):
            if isinstance(o, enum.Enum):
                return o.value
            raise TypeError(type(o))

        return json.dumps(dataclasses.asdict(self), default=default, sort_keys=True)

    def fingerprint(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


def cache_key(
    prompt: str,
    model_name: str,
    provider: str,
    temperature: float,
    max_tokens: int,
) -> str:
    """Content-addressable key: SHA256(prompt||model||provider||T||max_tokens).
    The provider is part of it, so the port's ``"torch_local"`` answers and
    the JAX engine's never replay for each other."""
    payload = "\x1f".join(
        [prompt, model_name, provider, f"{temperature:.6g}", str(max_tokens)]
    )
    return hashlib.sha256(payload.encode()).hexdigest()

