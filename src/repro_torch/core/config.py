"""Evaluation-task configuration (the port of ``repro/core/config.py``).  A
task serializes to JSON (``EvalTask.to_json``), which equals the
reference's for a provider both packages share: the resume key of a spill
manifest and tracking's ``params.json`` are built from it."""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Any

from repro_torch.stats.sequential import StoppingRule


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
    JAX-engine answers to the port or back; any other provider (``openai``,
    ``anthropic``, ``google``) is the simulated API engine."""

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
    #: bertscore, {"normalized": False} for exact_match and contains, or
    #: {"rubric": ..., "scale": n} for llm_judge
    params: dict = dataclasses.field(default_factory=dict)

    def __hash__(self) -> int:
        # a dict has no hash: hash its JSON, as the reference does
        return hash((self.name, self.type, json.dumps(self.params, sort_keys=True)))


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
    the per-example scores.

    With a ``spill_dir`` each finished chunk commits its partial state to a
    manifest (:class:`~repro_torch.storage.spill.ChunkManifest`), so an
    interrupted run resumes by merging the committed chunks instead of
    running them again.  ``max_inflight_chunks > 1`` runs that many chunks
    at once (peak resident examples ``max_inflight_chunks x
    max_memory_rows``), merged in chunk order, so the result equals the
    serial run's bit for bit.  ``max_examples`` caps the examples taken
    from the source (0 = no cap); a declared cap lets a resumed run tell
    "stopped at my cap" from "the source shrank".  The concurrency, the
    spill location, ``resume`` and the cap stay out of the resume key."""

    enabled: bool = False
    max_memory_rows: int = 1024       # chunk size == peak resident examples
    spill_dir: str = ""               # "" = no spill, run is not resumable
    resume: bool = True               # skip chunks already in the manifest
    max_inflight_chunks: int = 1      # >1 = concurrent chunk execution
    max_examples: int = 0


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """How the task's prompts reach the engine (the fields of
    ``repro/core/config.py:InferenceConfig`` that the port reads), with the
    reference's defaults."""

    #: prompts per shard: the unit of per-shard cache and call accounting
    batch_size: int = 16
    #: lock-step worker threads (and their rate-limit split); through the
    #: service, the least number of dispatcher threads of an API engine
    n_workers: int = 4
    #: global requests and tokens a minute, split over the workers
    rate_limit_rpm: float = 10_000.0
    rate_limit_tpm: float = 2_000_000.0
    #: re-grant the global rate budget to the workers by demand each window
    adaptive_rate: bool = False
    cache_policy: CachePolicy = CachePolicy.ENABLED
    #: "" = no response cache
    cache_dir: str = ""
    #: retries of a recoverable engine error, with exponential backoff
    #: from ``retry_delay`` seconds (slept only with a wall-clock session)
    max_retries: int = 3
    retry_delay: float = 1.0
    #: lock-step path: re-issue a shard slower than ``straggler_factor`` x
    #: the median finished shard
    speculative_reissue: bool = False
    straggler_factor: float = 3.0
    #: False = the lock-step path: shards on the session's worker pool, one
    #: engine call a prompt, rate limits acquired by the workers
    use_service: bool = True
    #: outstanding requests the service queue holds before submit blocks
    service_queue_depth: int = 256
    #: single-flight coalescing of identical in-flight cache keys
    coalesce: bool = True
    #: batch-formation window of a cold batcher loop
    max_batch_wait_ms: float = 2.0
    #: data-parallel engine replicas behind one service front, each its own
    #: engine (own batcher and decode slots) on the session's device; the
    #: flight table stays global, and responses are a pure function of the
    #: request, so the replica count never changes a metric byte.  On one
    #: card the replicas' batcher threads share one interpreter lock: they
    #: buy fault tolerance, not throughput (two took 3.2-4.0x one engine's
    #: wall on an H100, ``chip_smoke.py`` phase 9 (a))
    n_replicas: int = 1
    #: replica placement: least_loaded | prefix_affinity | round_robin
    routing: str = "least_loaded"
    #: prompt-prefix characters hashed by prefix_affinity
    routing_prefix_len: int = 64
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
    # fault tolerance of the serving fabric (DESIGN.md §9):
    #: a request's deadline on the service path (0 = none); on expiry it is
    #: hedged to another alive replica, the first completion wins and the
    #: loser's slot is cancelled
    request_deadline_s: float = 0.0
    #: restarts of a broken replica before its in-flight work fails (0: the
    #: first crash retires it)
    max_replica_restarts: int = 2
    #: base delay of the doubling restart backoff
    restart_backoff_s: float = 0.05
    #: a replica with work in flight and no engine progress for this many
    #: pumps in a row is declared hung and restarted (0 = no probe)
    health_probe_steps: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    prompt_template: str = "{question}"
    input_columns: tuple[str, ...] = ("question",)
    reference_column: str = "reference"


@dataclasses.dataclass(frozen=True)
class EvalTask:
    task_id: str
    model: EngineModelConfig = EngineModelConfig()
    inference: InferenceConfig = InferenceConfig()
    metrics: tuple[MetricConfig, ...] = (MetricConfig("exact_match"),)
    statistics: StatisticsConfig = StatisticsConfig()
    data: DataConfig = DataConfig()
    streaming: StreamingConfig = StreamingConfig()
    #: adaptive early stopping (:mod:`repro_torch.stats.sequential`): when
    #: enabled, the streaming pipelines consult the rule after every merged
    #: chunk; its fields are part of a spill manifest's resume contract
    stopping: StoppingRule = StoppingRule()

    def with_model(self, model: EngineModelConfig) -> "EvalTask":
        """Rebind the task to another model (suite model sweeps)."""
        return dataclasses.replace(self, model=model)

    def with_streaming(self, **kw: Any) -> "EvalTask":
        """Enable (or reconfigure) streaming execution; unspecified fields
        keep their current values.  ``concurrency`` is an alias of
        ``max_inflight_chunks``: ``task.with_streaming(concurrency=4)``
        runs four chunks in flight."""
        kw.setdefault("enabled", True)
        if "concurrency" in kw:
            kw["max_inflight_chunks"] = kw.pop("concurrency")
        return dataclasses.replace(
            self, streaming=dataclasses.replace(self.streaming, **kw)
        )

    def with_stopping(self, **kw: Any) -> "EvalTask":
        """Enable (or reconfigure) adaptive early stopping, e.g.
        ``task.with_stopping(target_half_width=0.02, min_examples=512)``;
        unspecified fields keep their current values.  Only streaming runs
        consult it."""
        kw.setdefault("enabled", True)
        return dataclasses.replace(
            self, stopping=dataclasses.replace(self.stopping, **kw)
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

