"""Serial streaming evaluation (``StreamingPipeline.run`` of
``repro/core/streaming.py``, without the spill manifest and without
concurrent chunks): prepare, infer and score one chunk at a time through
the same stages as the in-memory path (so the inference service and the
response cache serve streaming too), fold its scores into mergeable
accumulators and, for the bootstrap interval methods, the task's bootstrap
engine, and drop it, so peak per-example state is one chunk.
``EvalSession.run_task`` takes this path for a task with
``streaming.enabled``.

The result keeps up to ``MAX_FAILURE_SAMPLE`` failures with their indices
into the whole source, and sums the chunks' engine and cache stats.  Its
``timing`` holds the chunks' summed stage seconds, the seconds spent
folding chunks into the accumulators and the bootstrap engine
(``partials_s``), and the final interval step (``stats_s``, as in the
reference)."""

from __future__ import annotations

import time
from typing import Any, Iterable

from repro_torch.core.config import EvalTask
from repro_torch.core.stages import (
    EvalArtifact,
    EvalResult,
    InferStage,
    MetricValue,
    PrepareStage,
    ScoreStage,
)
from repro_torch.data.datasets import iter_chunks
from repro_torch.metrics.registry import BINARY_METRICS, resolve_metrics
from repro_torch.stats.streaming import (
    BootstrapEngine,
    MetricAccumulator,
    StreamingStats,
    make_bootstrap_engine,
    streaming_ci,
)

#: failures kept in the result (a full per-example list defeats O(chunk) memory)
MAX_FAILURE_SAMPLE = 100


class StreamingPipeline:
    def __init__(self, *, chunk_size: int = 1024):
        self.chunk_size = chunk_size

    @classmethod
    def from_task(cls, task: EvalTask) -> "StreamingPipeline":
        return cls(chunk_size=task.streaming.max_memory_rows)

    def run(self, source: Iterable[dict], task: EvalTask, session: Any) -> EvalResult:
        stages = [PrepareStage(), InferStage(), ScoreStage()]
        stats_cfg = task.statistics
        names = [name for name, _ in resolve_metrics(task.metrics)]
        accs = {m: MetricAccumulator() for m in names}
        # the analytical interval comes straight from the moments; only the
        # bootstrap methods pay for replicate state, as in the reference
        use_boot = stats_cfg.ci_method in ("percentile", "bca")
        engine = make_bootstrap_engine(
            stats_cfg.backend, stats_cfg.bootstrap_iterations, stats_cfg.seed,
            tuple(names), device=session.device,
        ) if use_boot else None
        failures: list[dict] = []
        timing: dict[str, float] = {}
        engine_stats = {"calls": 0, "total_cost": 0.0, "coalesced": 0, "pool": {}}
        cache_stats: dict = {}
        n_failures = n_examples = n_chunks = max_resident = 0
        start = 0
        for ci, chunk in enumerate(iter_chunks(source, self.chunk_size)):
            n_chunks += 1
            n_examples += len(chunk)
            max_resident = max(max_resident, len(chunk))
            art = EvalArtifact(rows=chunk, task=task)
            chunk_timing: dict[str, float] = {}
            for stage in stages:
                t0 = time.monotonic()
                art = stage.run(art, session)
                chunk_timing[f"{stage.name}_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            for m in names:
                accs[m].update(art.scores[m])
            if engine is not None:
                chunk_engine = engine.spawn()
                chunk_engine.update(art.scores, start)
                engine.merge(chunk_engine)
            chunk_timing["partials_s"] = time.monotonic() - t0
            for key, dt in chunk_timing.items():
                timing[key] = timing.get(key, 0.0) + dt
            chunk_failures = [{**f, "index": f["index"] + start} for f in art.failures]
            state = {
                "start": start,
                "n_rows": len(chunk),
                "failures": chunk_failures[:MAX_FAILURE_SAMPLE],
                "n_failures": len(chunk_failures),
                "engine_stats": art.engine_stats,
                "cache_stats": art.cache_stats,
                "timing": chunk_timing,
            }
            n_failures += len(chunk_failures)
            _merge_failures(failures, chunk_failures)
            _merge_engine_stats(engine_stats, art.engine_stats)
            _merge_cache_stats(cache_stats, art.cache_stats)
            for mw in session.middleware:
                mw.on_chunk_end(ci, state, session)
            start += len(chunk)
            del art, chunk  # the chunk's per-example state dies here

        t0 = time.monotonic()
        metrics = _finalize_metrics(names, accs, engine, task)
        timing["stats_s"] = time.monotonic() - t0
        if cache_stats:
            h, mi = cache_stats.get("hits", 0), cache_stats.get("misses", 0)
            cache_stats["hit_rate"] = h / (h + mi) if h + mi else 0.0
        return EvalResult(
            task_id=task.task_id,
            metrics=metrics,
            scores={},       # per-example scores are never materialized
            responses=[],    # raw responses were dropped per chunk
            failures=failures[:MAX_FAILURE_SAMPLE],
            cache_stats=cache_stats,
            engine_stats=engine_stats,
            timing=timing,
            logs={
                "streaming": {
                    "n_examples": n_examples,
                    "n_chunks": n_chunks,
                    "chunk_size": self.chunk_size,
                    "max_resident_rows": max_resident,
                    "n_failures": n_failures,
                    "stats_backend": stats_cfg.backend if use_boot else "",
                    "stats_stream": engine.stream_id() if use_boot else None,
                }
            },
            stream_stats=StreamingStats(
                accs=accs, engine=engine, chunk_size=self.chunk_size,
                n_examples=n_examples,
            ),
        )


def _merge_failures(acc: list[dict], new: list[dict]) -> None:
    room = MAX_FAILURE_SAMPLE - len(acc)
    if room > 0:
        acc.extend(new[:room])


def _merge_engine_stats(total: dict, delta: dict) -> None:
    total["calls"] += delta.get("calls") or 0
    total["total_cost"] += delta.get("total_cost", 0.0)
    total["coalesced"] = total.get("coalesced", 0) + (delta.get("coalesced") or 0)
    for k, v in delta.get("pool", {}).items():
        total["pool"][k] = total["pool"].get(k, 0) + v


def _merge_cache_stats(total: dict, delta: dict) -> None:
    for k, v in delta.items():
        if not isinstance(v, (int, float)) or k == "hit_rate":
            continue  # hit_rate is recomputed from the summed counters
        if k in ("hits", "misses", "writes"):
            total[k] = total.get(k, 0) + v
        else:
            total[k] = v  # entries/version stay absolute: latest wins


def _finalize_metrics(
    names: list[str],
    accs: dict[str, MetricAccumulator],
    engine: BootstrapEngine | None,
    task: EvalTask,
) -> dict[str, MetricValue]:
    stats_cfg = task.statistics
    out: dict[str, MetricValue] = {}
    for m in names:
        acc = accs[m]
        if acc.n == 0:
            out[m] = MetricValue(
                m, float("nan"), (float("nan"),) * 2, "none", 0, acc.n_nan
            )
            continue
        iv = streaming_ci(
            acc, engine.view(m) if engine is not None else None,
            method=stats_cfg.ci_method,
            confidence=stats_cfg.confidence_level, binary=m in BINARY_METRICS,
        )
        out[m] = MetricValue(m, iv.value, (iv.lo, iv.hi), iv.method, iv.n, acc.n_nan)
    return out
