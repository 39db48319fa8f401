"""Serial streaming evaluation (``StreamingPipeline.run`` of
``repro/core/streaming.py``, without the spill manifest and without
concurrent chunks): prepare, infer and score one chunk at a time, fold its
scores into mergeable accumulators and, for the bootstrap interval methods,
the device bootstrap engine, and drop it, so peak per-example state is one
chunk.  ``EvalSession.run_task`` takes this path for a task with
``streaming.enabled``."""

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
        # bootstrap methods pay for replicate state (one partials launch per
        # chunk), as in the reference
        use_boot = stats_cfg.ci_method in ("percentile", "bca")
        engine = make_bootstrap_engine(
            stats_cfg.backend, stats_cfg.bootstrap_iterations, stats_cfg.seed,
            tuple(names), device=session.device,
        ) if use_boot else None
        timing: dict[str, float] = {}
        n_failures = n_examples = n_chunks = 0
        start = 0
        for chunk in iter_chunks(source, self.chunk_size):
            n_chunks += 1
            n_examples += len(chunk)
            art = EvalArtifact(rows=chunk, task=task)
            for stage in stages:
                t0 = time.monotonic()
                art = stage.run(art, session)
                key = f"{stage.name}_s"
                timing[key] = timing.get(key, 0.0) + time.monotonic() - t0
            t0 = time.monotonic()
            for m in names:
                accs[m].update(art.scores[m])
            if engine is not None:
                chunk_engine = engine.spawn()
                chunk_engine.update(art.scores, start)
                engine.merge(chunk_engine)
            timing["stats_s"] = timing.get("stats_s", 0.0) + time.monotonic() - t0
            n_failures += len(art.failures)
            start += len(chunk)
            del art, chunk  # the chunk's per-example state dies here

        metrics = _finalize_metrics(names, accs, engine, task)
        return EvalResult(
            task_id=task.task_id,
            metrics=metrics,
            engine_stats=session.engine_for(task.model, task.inference).serving_stats(),
            timing=timing,
            logs={
                "streaming": {
                    "n_examples": n_examples,
                    "n_chunks": n_chunks,
                    "chunk_size": self.chunk_size,
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
