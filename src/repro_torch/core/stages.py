"""The evaluation stages of ``repro/core/stages.py``: each is
``run(artifact, session) -> artifact`` over one :class:`EvalArtifact`.  The
in-memory pipeline (:func:`default_stages`) is prepare -> infer -> score ->
aggregate over the whole task; the streaming pipeline runs the first three
per chunk and aggregates from mergeable state instead.  The cache-replay
loop re-scores earlier responses by swapping :class:`InferStage` for
:class:`StaticResponsesStage` (:func:`rescore_stages`, no engine calls).

:class:`Middleware` objects observe the pipeline (``on_task_start``,
``on_stage_start``, ``on_stage_end``, ``on_chunk_end``, ``on_task_end``):
progress reporting, and the session cost-budget abort."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.cache import CacheEntry
from repro_torch.core.config import CachePolicy, EvalTask, cache_key
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
    #: in-memory runs only: per-example scores by metric and the responses
    scores: dict[str, np.ndarray]
    responses: list[str]
    #: ``{"index", "error"}`` of each example whose inference failed (index
    #: into the task's rows; a streaming run keeps the first 100)
    failures: list[dict]
    #: this task's cache traffic (hits, misses, writes, hit_rate) and the
    #: cache's entries and version; {} without a cache
    cache_stats: dict
    #: this task's engine calls, cost and coalesced submissions
    engine_stats: dict
    timing: dict
    logs: dict
    #: streaming runs only: merged accumulator and bootstrap-replicate state
    stream_stats: Any = None

    @property
    def throughput_per_min(self) -> float:
        dt = self.timing.get("infer_s", 0.0)
        # streaming runs discard responses; the count lives in the logs
        n = len(self.responses) or self.logs.get("streaming", {}).get(
            "n_examples", 0
        )
        return n / dt * 60.0 if dt > 0 else float("inf")


@dataclasses.dataclass
class EvalArtifact:
    """The rows of a task (or of one chunk) flowing through the stages:
    ``PrepareStage`` fills ``prompts``, ``InferStage`` (or a replacement)
    ``responses``, ``texts``, ``failures`` and the task's cache and engine
    stats, ``ScoreStage`` ``scores``, ``AggregateStage`` ``metrics``; the
    session records each stage's seconds in ``timing``."""

    rows: list[dict]
    task: EvalTask
    prompts: list[str] = dataclasses.field(default_factory=list)
    responses: list[InferenceResponse | None] = dataclasses.field(
        default_factory=list
    )
    texts: list[str] = dataclasses.field(default_factory=list)
    failures: list[dict] = dataclasses.field(default_factory=list)
    scores: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    metrics: dict[str, MetricValue] = dataclasses.field(default_factory=dict)
    cache_stats: dict = dataclasses.field(default_factory=dict)
    engine_stats: dict = dataclasses.field(default_factory=dict)
    timing: dict = dataclasses.field(default_factory=dict)
    logs: dict = dataclasses.field(default_factory=dict)

    def to_result(self) -> EvalResult:
        return EvalResult(
            task_id=self.task.task_id,
            metrics=self.metrics,
            scores=self.scores,
            responses=self.texts,
            failures=self.failures,
            cache_stats=self.cache_stats,
            engine_stats=self.engine_stats,
            timing=self.timing,
            logs=self.logs,
        )


@runtime_checkable
class Stage(Protocol):
    name: str

    def run(self, artifact: EvalArtifact, session: Any) -> EvalArtifact: ...


class PrepareStage:
    name = "prepare"

    def run(self, art: EvalArtifact, session: Any) -> EvalArtifact:
        # fail fast on unknown metrics before any inference happens
        resolve_metrics(art.task.metrics)
        art.prompts = [render(art.task.data.prompt_template, r) for r in art.rows]
        return art


@dataclasses.dataclass
class _ShardStats:
    """One shard's own traffic, counted where it happens, so a task's stats
    stay exact while other tasks share the engine, cache and service."""

    calls: int = 0
    cost: float = 0.0
    hits: int = 0
    misses: int = 0
    writes: int = 0
    #: submissions answered by another submission's engine call
    coalesced: int = 0


def _sum_shard_stats(parts) -> _ShardStats:
    totals = _ShardStats()
    for st in parts:
        for f in dataclasses.fields(_ShardStats):
            setattr(totals, f.name, getattr(totals, f.name) + getattr(st, f.name))
    return totals


def _publish_infer_stats(art: EvalArtifact, cache, totals: _ShardStats) -> None:
    """``art.cache_stats`` and ``art.engine_stats`` from the summed shard
    stats, as the reference assembles them."""
    if cache is not None:
        stats = cache.stats()  # entries/version stay session-absolute
        h, m = totals.hits, totals.misses
        stats.update(
            hits=h, misses=m, writes=totals.writes,
            hit_rate=h / (h + m) if h + m else 0.0,
        )
        art.cache_stats = stats
    else:
        art.cache_stats = {}
    art.engine_stats = {
        "calls": totals.calls,
        "total_cost": totals.cost,
        "coalesced": totals.coalesced,
        "pool": {},
    }


class InferStage:
    """Submit every cache miss to the session's shared
    :class:`~repro_torch.core.service.InferenceService` before gathering
    any response, so batches span shards (and, through the per-engine
    service, chunks and the tasks of a suite).

    Prompts are counted in shards of ``inference.batch_size``: cache hits,
    misses and writes per shard, and each engine call to the shard of its
    primary submitter.  A repeated key within the stage reuses the first
    occurrence's ticket (stage-local single-flight, deterministic whatever
    the dispatch timing) and counts as coalesced; the service's own flight
    table covers concurrent stages."""

    name = "infer"

    def run(self, art: EvalArtifact, session: Any) -> EvalArtifact:
        task = art.task
        inf = task.inference
        model = task.model
        prompts = art.prompts
        service = session.service_for(model, inf)
        cache = session.cache_for(inf)

        count_lookups = cache is not None and cache.policy not in (
            CachePolicy.DISABLED, CachePolicy.WRITE_ONLY,
        )
        shards = [
            list(range(i, min(i + inf.batch_size, len(prompts))))
            for i in range(0, len(prompts), inf.batch_size)
        ]
        responses: list[InferenceResponse | None] = [None] * len(prompts)
        failures: list[dict] = []
        acct = session.accounting
        plans: list[tuple[_ShardStats, list]] = []
        #: gather cursor over the flattened plan entries, so an aborted
        #: gather can sweep the spend of ungathered flights
        gathered = 0
        n_cached = 0
        in_tok = out_tok = 0
        local: dict[str, Any] = {}

        service.attach()
        try:
            # submit: cache lookups counted per shard; misses go straight
            # to the service
            for idxs in shards:
                st = _ShardStats()
                pending: list[tuple[int, str, Any, bool]] = []
                plans.append((st, pending))
                for i in idxs:
                    key = cache_key(
                        prompts[i], model.model_name, model.provider,
                        model.temperature, model.max_tokens,
                    )
                    if cache is not None:
                        hit = cache.lookup(key)
                        if hit is not None:
                            st.hits += 1
                            n_cached += 1
                            responses[i] = InferenceResponse(
                                text=hit.response_text,
                                input_tokens=hit.input_tokens or 0,
                                output_tokens=hit.output_tokens or 0,
                                latency_ms=0.0,
                            )
                            continue
                        if count_lookups:
                            st.misses += 1
                    if inf.coalesce and key in local:
                        service.note_coalesced()
                        pending.append((i, key, local[key], False))
                        continue
                    ticket = service.submit(
                        InferenceRequest(prompts[i], model.max_tokens, model.temperature),
                        key=key,
                        coalesce=inf.coalesce,
                    )
                    local[key] = ticket
                    pending.append((i, key, ticket, True))

            # gather: per-shard stats; a coalesced follower's spend belongs
            # to its leader's shard
            for st, pending in plans:
                new_entries: list[CacheEntry] = []
                for i, key, ticket, owner in pending:
                    resp = ticket.result()
                    gathered += 1
                    responses[i] = resp
                    primary = owner and ticket.primary
                    if primary:
                        st.calls += ticket.attempts
                        st.cost += resp.cost_usd
                    else:
                        st.coalesced += 1
                    if resp.error is not None:
                        failures.append({"index": i, "error": resp.error})
                    elif primary:
                        in_tok += resp.input_tokens
                        out_tok += resp.output_tokens
                        if cache is not None:
                            new_entries.append(
                                CacheEntry(
                                    prompt_hash=key,
                                    model_name=model.model_name,
                                    provider=model.provider,
                                    prompt_text=prompts[i],
                                    response_text=resp.text,
                                    input_tokens=resp.input_tokens,
                                    output_tokens=resp.output_tokens,
                                    latency_ms=resp.latency_ms,
                                    created_at=time.time(),
                                )
                            )
                if new_entries:
                    st.writes += cache.put(new_entries)
        finally:
            service.detach()
            # the spend of flights that resolved but were never gathered
            # (a REPLAY miss or a failed gather aborted the stage) still
            # reaches the session accounting: those engine calls happened
            flat = [(st, entry) for st, pending in plans for entry in pending]
            for st, (i, key, ticket, owner) in flat[gathered:]:
                if not (owner and ticket.primary and ticket.done()):
                    continue
                try:
                    resp = ticket.result(0.0)
                except BaseException:  # noqa: BLE001 — failed flight: no spend
                    continue
                st.calls += ticket.attempts
                st.cost += resp.cost_usd
            with acct.lock:
                for st, _ in plans:
                    acct.engine_calls += st.calls
                    acct.cost_usd += st.cost
                    acct.coalesced_requests += st.coalesced

        art.responses = responses
        art.texts = [
            r.text if r is not None and r.error is None else "" for r in responses
        ]
        art.failures = failures
        _publish_infer_stats(art, cache, _sum_shard_stats(st for st, _ in plans))
        with acct.lock:
            acct.input_tokens += in_tok
            acct.output_tokens += out_tok
            if cache is not None:
                acct.cache_hits += n_cached
                acct.cache_misses += len(prompts) - n_cached
        return art


class StaticResponsesStage:
    """Stage-swap replacement for :class:`InferStage`: inject earlier
    response texts (e.g. an :class:`EvalResult`'s ``responses``) and
    re-score them with other metrics, with no engine calls."""

    name = "infer"

    def __init__(self, texts: list[str]):
        self._texts = list(texts)

    def run(self, art: EvalArtifact, session: Any) -> EvalArtifact:
        if len(self._texts) != len(art.rows):
            raise ValueError(f"{len(self._texts)} responses for {len(art.rows)} rows")
        art.texts = list(self._texts)
        art.responses = [None] * len(art.rows)
        art.cache_stats = {}
        art.engine_stats = {"calls": 0, "total_cost": 0.0, "pool": {}}
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


def default_stages() -> list[Stage]:
    return [PrepareStage(), InferStage(), ScoreStage(), AggregateStage()]


def rescore_stages(texts: list[str]) -> list[Stage]:
    """The cache-replay iteration loop: re-score existing responses without
    inference."""
    return [PrepareStage(), StaticResponsesStage(texts), ScoreStage(), AggregateStage()]


# -- middleware -----------------------------------------------------------------


class Middleware:
    """No-op base; subclass and override the hooks you need."""

    def on_task_start(self, task: EvalTask, rows: list[dict], session: Any) -> None:
        pass

    def on_stage_start(self, stage: Stage, art: EvalArtifact, session: Any) -> None:
        pass

    def on_stage_end(self, stage: Stage, art: EvalArtifact, session: Any) -> None:
        pass

    def on_chunk_end(self, chunk_index: int, state: dict, session: Any) -> None:
        """Streaming only: a chunk finished."""

    def on_task_end(self, task: EvalTask, result: EvalResult, session: Any) -> None:
        pass


class CostBudgetExceeded(RuntimeError):
    """Raised by :class:`CostBudgetMiddleware` when session spend crosses
    the budget; aborts the pipeline between stages."""


class CostBudgetMiddleware(Middleware):
    def __init__(self, max_usd: float):
        self.max_usd = max_usd

    def on_stage_end(self, stage, art, session) -> None:
        self._check(session, f"after stage {stage.name!r} of task {art.task.task_id!r}")

    def on_chunk_end(self, chunk_index, state, session) -> None:
        self._check(session, f"after streaming chunk {chunk_index}")

    def _check(self, session, where: str) -> None:
        spent = session.accounting.cost_usd
        if spent > self.max_usd:
            raise CostBudgetExceeded(
                f"session cost ${spent:.4f} exceeds budget ${self.max_usd:.4f} ({where})"
            )


class ProgressMiddleware(Middleware):
    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self._t0: dict[str, float] = {}

    def on_task_start(self, task, rows, session) -> None:
        print(
            f"[{task.task_id}] {len(rows)} examples, "
            f"model={task.model.provider}:{task.model.model_name}",
            file=self.stream,
        )

    def on_stage_start(self, stage, art, session) -> None:
        self._t0[stage.name] = time.monotonic()

    def on_stage_end(self, stage, art, session) -> None:
        dt = time.monotonic() - self._t0.get(stage.name, time.monotonic())
        print(f"[{art.task.task_id}]   {stage.name}: {dt:.2f}s", file=self.stream)

    def on_chunk_end(self, chunk_index, state, session) -> None:
        print(
            f"  chunk {chunk_index}: rows {state['start']}.."
            f"{state['start'] + state['n_rows']}, "
            f"{state['n_failures']} failures",
            file=self.stream,
        )

    def on_task_end(self, task, result, session) -> None:
        vals = ", ".join(f"{n}={mv.value:.3f}" for n, mv in result.metrics.items())
        print(f"[{task.task_id}] done: {vals}", file=self.stream)
