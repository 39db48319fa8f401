"""Streaming evaluation (the port of ``repro/core/streaming.py``): prepare,
infer and score one chunk at a time through the same stages as the
in-memory path (so the inference service and the response cache serve
streaming too), fold its scores into mergeable accumulators and, for the
bootstrap interval methods, the task's bootstrap engine, and drop it, so
peak per-example state is one chunk.  ``EvalSession.run_task`` takes this
path for a task with ``streaming.enabled``.

With a ``spill_dir`` every finished chunk commits its partial state to a
:class:`~repro_torch.storage.spill.ChunkManifest` (one DeltaLite commit a
chunk).  A restarted run merges the committed chunks instead of running
them again and ends bit for bit where an uninterrupted run ends: the
bootstrap weights are keyed by (seed, chunk offset), not by the order in
which chunks ran, and committed f64 partials come back from JSON exactly.
The manifest has the reference's format, so either package resumes a run
the other began.  A task's :class:`~repro_torch.stats.sequential.
StoppingRule` is consulted after every merged chunk; its fingerprint and
its stop point are part of the manifest's resume contract
(:class:`_StopTracker`).

:class:`ConcurrentStreamingExecutor` runs whole chunks at once on a
chunk-level :class:`~repro_torch.ft.workers.WorkerPool` window
(``StreamingConfig.max_inflight_chunks``) and folds their states in chunk
order, so its result equals the serial pipeline's bit for bit; racing
attempts of one chunk resolve first-committer-wins in the manifest.

The result keeps up to ``MAX_FAILURE_SAMPLE`` failures with their indices
into the whole source, and sums the chunks' engine and cache stats.  Its
``timing`` holds the chunks' summed stage seconds, the seconds spent
folding a live chunk into fresh accumulators and a fresh bootstrap engine
(``partials_s``), and the final interval step (``stats_s``).  Its
``logs["streaming"]`` has the reference's keys plus ``n_failures`` (every
failure, not only the sample) and ``stats_stream`` (the bootstrap
engine's stream id); ``logs["adaptive"]`` reports the stopping rule."""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import time
from typing import Any, Iterable, Iterator

from repro_torch.core.config import EvalTask, StatisticsConfig
from repro_torch.core.stages import (
    EvalArtifact,
    EvalResult,
    InferStage,
    MetricValue,
    PrepareStage,
    ScoreStage,
)
from repro_torch.data.datasets import iter_chunks
from repro_torch.ft.workers import WorkerPool
from repro_torch.metrics.registry import BINARY_METRICS, resolve_metrics
from repro_torch.stats.streaming import (
    BootstrapEngine,
    MetricAccumulator,
    StreamingStats,
    make_bootstrap_engine,
    streaming_ci,
)
from repro_torch.storage.spill import ChunkManifest

#: failures kept in the result (a full per-example list defeats O(chunk) memory)
MAX_FAILURE_SAMPLE = 100


class ManifestMismatch(RuntimeError):
    """Manifest row disagrees with the observed chunk layout — the data
    source differs from the run that wrote the manifest."""


class _StopTracker:
    """Adaptive early-stopping state for one streaming run (both
    pipelines).  Owns the three manifest-backed invariants:

    * **one regime per manifest** — the stopping rule's fingerprint is
      committed as the manifest's regime row before any adaptive chunk
      commits; resuming with a different rule (or flipping adaptive mode
      on/off over existing chunks) refuses with a remediation hint.
    * **one stop per run** — the first firing of the rule commits a stop
      row (first-committer-wins for racing runs); the stop point then
      becomes part of the resume contract.
    * **bit-identical replay** — a resumed run re-consults the rule after
      every merged chunk (committed chunks replay the same accumulator
      states, so the same decision sequence), and any disagreement with
      the recorded stop row is a :class:`ManifestMismatch`, never a silent
      re-opening of sampling.
    """

    def __init__(
        self,
        task: EvalTask,
        manifest: ChunkManifest | None,
        completed: dict[int, dict],
    ):
        self.rule = task.stopping if task.stopping.enabled else None
        self.manifest = manifest
        self.stopped = False
        self.decision: dict | None = None
        self.recorded: dict | None = None
        if manifest is None:
            return
        fp = self.rule.fingerprint() if self.rule is not None else ""
        row = manifest.regime_row()
        if row is None and self.rule is not None:
            if completed:
                raise ManifestMismatch(
                    f"manifest {manifest.run_key} has {len(completed)} "
                    "committed chunk(s) but no certification-regime row — "
                    "it was written by a run without adaptive stopping. "
                    "Resume without a stopping rule, or clear the spill "
                    "dir to start an adaptive run"
                )
            if not manifest.try_record_regime({"rule": fp}):
                row = manifest.regime_row()  # lost the race: validate
        if row is not None and row.get("rule") != fp:
            ours = f"rule {fp}" if self.rule is not None else "stopping disabled"
            raise ManifestMismatch(
                f"manifest {manifest.run_key} was written under "
                f"certification regime {row.get('rule')!r} but this run has "
                f"{ours} — resuming would mix stopping regimes. Resume with "
                "the original StoppingRule, or clear the spill dir to "
                "re-certify under the new rule"
            )
        if self.rule is not None:
            self.recorded = manifest.stop_row()

    def after_chunk(
        self, ci: int, accs: dict[str, MetricAccumulator], n_examples: int
    ) -> bool:
        """Consult the rule after chunk ``ci`` merged; True = stop now.
        Validates (or commits) the manifest stop row as a side effect."""
        if self.rule is None:
            return False
        d = self.rule.should_stop(accs, n_examples)
        rec = self.recorded
        if not d.stop:
            if rec is not None and int(rec["stop_chunk"]) == ci:
                raise ManifestMismatch(
                    f"manifest records a certified stop at chunk {ci} "
                    f"(n={rec['n_examples']}, reason={rec['reason']!r}) but "
                    "this run's rule does not fire there — was the data "
                    "source or the rule changed?"
                )
            return False
        state = {
            "stop_chunk": ci,
            "n_examples": n_examples,
            "reason": d.reason,
            "metric": d.metric,
            "half_width": d.half_width,
            "rule": self.rule.fingerprint(),
        }
        if rec is None and self.manifest is not None:
            if not self.manifest.try_record_stop(state):
                rec = self.manifest.stop_row()  # lost the race: validate
        if rec is not None and (
            int(rec["stop_chunk"]),
            int(rec["n_examples"]),
            rec["reason"],
        ) != (ci, n_examples, d.reason):
            raise ManifestMismatch(
                f"stop decision diverged from the manifest: recorded "
                f"chunk {rec['stop_chunk']} n={rec['n_examples']} "
                f"reason={rec['reason']!r}, this run fired at chunk {ci} "
                f"n={n_examples} reason={d.reason!r} — was the data source "
                "or the rule changed?"
            )
        self.stopped = True
        self.decision = state
        return True

    def finish(self) -> None:
        """Source exhausted without the rule firing — legal, unless the
        manifest promised a stop this run never reached."""
        if self.recorded is not None and not self.stopped:
            raise ManifestMismatch(
                f"manifest records a certified stop at chunk "
                f"{self.recorded['stop_chunk']} "
                f"(n={self.recorded['n_examples']}) that this run never "
                "reached — was the data source shortened?"
            )

    def info(self) -> dict | None:
        """``logs['adaptive']`` payload, or None when stopping is off."""
        if self.rule is None:
            return None
        out = {
            "enabled": True,
            "stopped": self.stopped,
            "rule": self.rule.fingerprint(),
        }
        if self.decision is not None:
            out.update(self.decision)
        return out


class _Run:
    """What both pipelines set up for a run and fold chunks into: the
    accumulators, the bootstrap engine, the manifest and its committed
    rows, the stop tracker, and the summed failures, stats and timing."""

    def __init__(self, task: EvalTask, session: Any, spill_dir: str, resume: bool):
        stats_cfg = task.statistics
        self.task = task
        self.names = [name for name, _ in resolve_metrics(task.metrics)]
        self.accs = {m: MetricAccumulator() for m in self.names}
        # the analytical interval comes straight from the moments; only the
        # bootstrap methods pay for replicate state, as in the reference
        self.use_boot = stats_cfg.ci_method in ("percentile", "bca")
        self.engine: BootstrapEngine | None = make_bootstrap_engine(
            stats_cfg.backend, stats_cfg.bootstrap_iterations, stats_cfg.seed,
            tuple(self.names), device=session.device,
        ) if self.use_boot else None
        self.manifest = (
            ChunkManifest(spill_dir, _run_key(task)) if spill_dir else None
        )
        self.completed = (
            self.manifest.completed() if self.manifest is not None and resume
            else {}
        )
        self.stopper = _StopTracker(task, self.manifest, self.completed)
        self.failures: list[dict] = []
        self.timing: dict[str, float] = {}
        self.engine_stats = {"calls": 0, "total_cost": 0.0, "coalesced": 0, "pool": {}}
        self.cache_stats: dict = {}
        self.n_failures = 0

    def score_chunk(
        self, ci: int, start: int, chunk: list[dict], session: Any, stages: list,
    ) -> tuple[dict, dict[str, MetricAccumulator], BootstrapEngine | None]:
        """Run the stages over a live chunk and fold its scores into fresh
        accumulators and a fresh engine; returns the chunk's state (with
        its serialized partials when it will be committed) and both."""
        art = EvalArtifact(rows=chunk, task=self.task)
        chunk_timing: dict[str, float] = {}
        for stage in stages:
            t0 = time.monotonic()
            art = stage.run(art, session)
            chunk_timing[f"{stage.name}_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        spill = self.manifest is not None
        accs: dict[str, MetricAccumulator] = {}
        chunk_states: dict[str, Any] = {}
        for m in self.names:
            acc = MetricAccumulator()
            acc.update(art.scores[m])
            accs[m] = acc
            if spill:
                chunk_states.setdefault("metrics", {})[m] = acc.state()
        chunk_engine = None
        if self.engine is not None:
            chunk_engine = self.engine.spawn()
            chunk_engine.update(art.scores, start)
            if spill:
                chunk_states["boot"] = chunk_engine.state()
        chunk_timing["partials_s"] = time.monotonic() - t0
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
        if spill:
            # digest and serialized partials are only needed for the spill
            # commit: the no-spill path skips the O(chunk) hashing and the
            # B-length list conversions
            state["digest"] = _chunk_digest(chunk)
            state.update(chunk_states)
        return state, accs, chunk_engine

    def merge_live(
        self, state: dict, accs: dict[str, MetricAccumulator],
        engine: BootstrapEngine | None, names: list[str] | None = None,
    ) -> None:
        """Fold a live chunk in, once per name of ``names`` (default: once
        per metric).  The serial pipeline passes the task's metric names,
        as the reference's does, so a repeated metric config is folded once
        per config there and once on the concurrent and resumed paths."""
        for m in self.accs if names is None else names:
            self.accs[m].merge(accs[m])
        if self.engine is not None:
            self.engine.merge(engine)
        self._merge_stats(state)

    def merge_committed(self, row: dict) -> None:
        """Fold a committed manifest row in (a resumed chunk, or the row of
        a commit race's winner)."""
        for m, acc in self.accs.items():
            acc.merge(MetricAccumulator.from_state(row["metrics"][m]))
        if self.engine is not None:
            try:
                self.engine.merge_state(row["boot"])
            except ValueError as e:
                # designed refusal (partials of another weight stream, e.g.
                # the card's resumed on the CPU): the documented
                # non-reusable-spill error, with a way out
                raise ManifestMismatch(
                    f"committed bootstrap partials are not mergeable by "
                    f"this run's statistics engine ({e}) — resume on the "
                    f"platform that wrote the spill, or clear the spill "
                    f"dir to recompute"
                ) from e
        self._merge_stats(row)

    def _merge_stats(self, state: dict) -> None:
        failures = state.get("failures", [])
        self.n_failures += state.get("n_failures", len(failures))
        _merge_failures(self.failures, failures)
        _merge_engine_stats(self.engine_stats, state.get("engine_stats", {}))
        _merge_cache_stats(self.cache_stats, state.get("cache_stats", {}))
        for k, v in state.get("timing", {}).items():
            self.timing[k] = self.timing.get(k, 0.0) + v

    def finish(
        self, n_examples: int, n_chunks: int, max_examples: int,
    ) -> None:
        self.stopper.finish()
        capped = 0 < max_examples <= n_examples
        if self.completed and not self.stopper.stopped and not capped:
            # committed chunks beyond the end of the source: the data source
            # shrank by an exact chunk multiple — refuse rather than
            # silently under-count (after a certified stop, leftover rows
            # are the in-flight chunks a concurrent run committed past the
            # stop point; after reaching a declared max_examples cap, they
            # are a larger prior cap's chunks — both excluded, never merged)
            raise ManifestMismatch(
                f"manifest has {len(self.completed)} committed chunk(s) "
                f"({sorted(self.completed)}) beyond the end of the data source "
                f"({n_chunks} chunks observed) — was the data source changed?"
            )

    def result(self, chunk_size: int, n_examples: int, streaming_logs: dict) -> EvalResult:
        stats_cfg = self.task.statistics
        t0 = time.monotonic()
        metrics = _finalize_metrics(self.names, self.accs, self.engine, stats_cfg)
        self.timing["stats_s"] = time.monotonic() - t0
        cache_stats = self.cache_stats
        if cache_stats:
            h, mi = cache_stats.get("hits", 0), cache_stats.get("misses", 0)
            cache_stats["hit_rate"] = h / (h + mi) if h + mi else 0.0
        logs = {
            "streaming": {
                **streaming_logs,
                "n_failures": self.n_failures,
                "stats_backend": stats_cfg.backend if self.use_boot else "",
                "stats_stream": self.engine.stream_id() if self.use_boot else None,
            }
        }
        if self.stopper.info() is not None:
            logs["adaptive"] = self.stopper.info()
        return EvalResult(
            task_id=self.task.task_id,
            metrics=metrics,
            scores={},       # per-example scores are never materialized
            responses=[],    # raw responses were dropped per chunk
            failures=self.failures[:MAX_FAILURE_SAMPLE],
            cache_stats=cache_stats,
            engine_stats=self.engine_stats,
            timing=self.timing,
            logs=logs,
            stream_stats=StreamingStats(
                accs=self.accs, engine=self.engine, chunk_size=chunk_size,
                n_examples=n_examples,
            ),
        )


class StreamingPipeline:
    def __init__(
        self,
        *,
        chunk_size: int = 1024,
        spill_dir: str = "",
        resume: bool = True,
        max_examples: int = 0,
    ):
        self.chunk_size = chunk_size
        self.spill_dir = spill_dir
        self.resume = resume
        self.max_examples = max_examples

    @classmethod
    def from_task(cls, task: EvalTask) -> "StreamingPipeline":
        s = task.streaming
        return cls(
            chunk_size=s.max_memory_rows,
            spill_dir=s.spill_dir,
            resume=s.resume,
            max_examples=s.max_examples,
        )

    def run(self, source: Iterable[dict], task: EvalTask, session: Any) -> EvalResult:
        if self.max_examples > 0:
            source = itertools.islice(source, self.max_examples)
        stages = [PrepareStage(), InferStage(), ScoreStage()]
        run = _Run(task, session, self.spill_dir, self.resume)
        n_examples = n_chunks = n_resumed = max_resident = 0
        start = 0
        for ci, chunk in enumerate(iter_chunks(source, self.chunk_size)):
            n_chunks += 1
            n_examples += len(chunk)
            max_resident = max(max_resident, len(chunk))
            # pop: committed rows carry B-length bootstrap partials, so
            # keeping the whole manifest would be O(n_chunks x B) memory
            row = run.completed.pop(ci, None)
            if row is not None:
                _check_row(ci, row, start, chunk)
                run.merge_committed(row)
                n_resumed += 1
                start += len(chunk)
                # resumed chunks replay the identical decision sequence: a
                # recorded stop fires here again, and the source is never
                # advanced past it
                if run.stopper.after_chunk(ci, run.accs, n_examples):
                    break
                continue

            state, accs, chunk_engine = run.score_chunk(ci, start, chunk, session, stages)
            if run.manifest is not None:
                run.manifest.record(ci, state)
            run.merge_live(state, accs, chunk_engine, run.names)
            for mw in session.middleware:
                mw.on_chunk_end(ci, state, session)
            start += len(chunk)
            del chunk, accs, chunk_engine  # the chunk's per-example state dies here
            # the stop check sits after the manifest commit: the chunk that
            # satisfied the rule is durable before sampling closes, so a
            # crash here resumes straight to the same certified stop
            if run.stopper.after_chunk(ci, run.accs, n_examples):
                break

        run.finish(n_examples, n_chunks, self.max_examples)
        return run.result(self.chunk_size, n_examples, {
            "n_examples": n_examples,
            "n_chunks": n_chunks,
            "n_resumed_chunks": n_resumed,
            "chunk_size": self.chunk_size,
            "max_resident_rows": max_resident,
            "spill_dir": self.spill_dir,
        })


@dataclasses.dataclass
class ChunkOutcome:
    """One chunk's contribution, produced by a concurrent chunk worker.

    Exactly one outcome per chunk reaches the merge loop: speculative
    duplicates are discarded at the pool level (first finisher) and at the
    manifest level (first committer); ``state`` always carries the
    canonical chunk state — the one committed to the manifest when spill
    is configured.
    """

    index: int
    start: int
    n_rows: int
    state: dict
    resumed: bool = False        # merged from a prior run's manifest row
    deduped: bool = False        # this attempt lost the commit race
    #: live accumulator objects (None when merging a committed row)
    accs: dict[str, MetricAccumulator] | None = None
    engine: BootstrapEngine | None = None


class ConcurrentStreamingExecutor:
    """Whole chunks in flight on a bounded window, bit for bit the result
    of :class:`StreamingPipeline`.

    * **Scheduling**: chunks are pulled lazily from the source and run on
      :meth:`WorkerPool.imap_windowed`, so at most ``window`` chunks are
      materialized at once (peak memory window x chunk); chunk-level
      retries and speculative re-issue of straggler chunks come from the
      pool.
    * **Merging**: chunk states fold in chunk-index order (the pool's
      ordered mode; a slot frees only once its chunk is yielded), so the
      totals and bootstrap sums accumulate in the serial order.
    * **Spill**: each chunk worker commits its own manifest row; racing
      attempts resolve first-committer-wins (:meth:`ChunkManifest.
      try_record`) and a loser adopts the committed row, so no engine call
      or cache access is counted twice.
    * **Middleware**: ``on_chunk_end`` fires from the merge loop in chunk
      order (never for resumed chunks), as in the serial pipeline.

    Every chunk worker launches on its thread's current stream, the
    default one, so the kernels' per-(device, stream) workspaces see their
    calls in order.
    """

    def __init__(
        self,
        *,
        chunk_size: int = 1024,
        window: int = 2,
        spill_dir: str = "",
        resume: bool = True,
        max_examples: int = 0,
    ):
        self.chunk_size = chunk_size
        self.window = max(1, window)
        self.spill_dir = spill_dir
        self.resume = resume
        self.max_examples = max_examples

    @classmethod
    def from_task(cls, task: EvalTask) -> "ConcurrentStreamingExecutor":
        s = task.streaming
        return cls(
            chunk_size=s.max_memory_rows,
            window=s.max_inflight_chunks,
            spill_dir=s.spill_dir,
            resume=s.resume,
            max_examples=s.max_examples,
        )

    def run(self, source: Iterable[dict], task: EvalTask, session: Any) -> EvalResult:
        if self.max_examples > 0:
            source = itertools.islice(source, self.max_examples)
        stages = [PrepareStage(), InferStage(), ScoreStage()]
        run = _Run(task, session, self.spill_dir, self.resume)
        inf = task.inference
        chunk_pool = WorkerPool(
            n_workers=self.window,
            max_retries=inf.max_retries,
            straggler_factor=(
                inf.straggler_factor if inf.speculative_reissue else 0.0
            ),
        )
        n_examples = n_chunks = n_resumed = 0
        resident = {"rows": 0, "max": 0}

        def items() -> Iterator[tuple[int, int, list[dict]]]:
            # runs on the calling thread inside the pool's scheduling loop:
            # a chunk is materialized only when a window slot is free
            start = 0
            for ci, chunk in enumerate(iter_chunks(source, self.chunk_size)):
                resident["rows"] += len(chunk)
                resident["max"] = max(resident["max"], resident["rows"])
                yield (ci, start, chunk)
                start += len(chunk)

        def process(index: int, item: tuple, worker: int) -> ChunkOutcome:
            ci, start, chunk = item
            return self._process_chunk(run, ci, start, chunk, session, stages)

        # ordered=True folds chunk states in index order (the serial float
        # order, so the same bytes) and frees a window slot only at yield,
        # so in-flight plus finished-but-unmerged chunks never exceed it
        stream = chunk_pool.imap_windowed(
            process, items(), window=self.window, ordered=True
        )
        try:
            for res in stream:
                out: ChunkOutcome = res.value
                resident["rows"] -= out.n_rows
                if out.accs is None:
                    run.merge_committed(out.state)
                else:
                    run.merge_live(out.state, out.accs, out.engine)
                run.completed.pop(out.index, None)
                n_chunks += 1
                n_examples += out.n_rows
                if out.resumed:
                    n_resumed += 1
                else:
                    for mw in session.middleware:
                        mw.on_chunk_end(out.index, out.state, session)
                # chunk i folds only after 0..i-1, so the rule sees the
                # serial accumulator sequence and fires at the same chunk;
                # in-flight chunks past the stop drain (committing their
                # rows) but are never merged
                if run.stopper.after_chunk(out.index, run.accs, n_examples):
                    break
        finally:
            # a middleware abort (cost budget, crash injection) or a merge
            # error joins the chunk workers now, not at collection: chunks
            # in flight drain, completing their manifest commits, before
            # the exception propagates
            stream.close()

        run.finish(n_examples, n_chunks, self.max_examples)
        return run.result(self.chunk_size, n_examples, {
            "n_examples": n_examples,
            "n_chunks": n_chunks,
            "n_resumed_chunks": n_resumed,
            "chunk_size": self.chunk_size,
            "max_inflight_chunks": self.window,
            "max_resident_rows": resident["max"],
            "spill_dir": self.spill_dir,
            "chunk_pool": dataclasses.asdict(chunk_pool.stats),
        })

    @staticmethod
    def _process_chunk(
        run: _Run, ci: int, start: int, chunk: list[dict], session: Any,
        stages: list,
    ) -> ChunkOutcome:
        manifest = run.manifest
        row = run.completed.get(ci) if manifest is not None else None
        if row is not None:
            _check_row(ci, row, start, chunk)
            return ChunkOutcome(ci, start, len(chunk), state=row, resumed=True)
        state, accs, chunk_engine = run.score_chunk(ci, start, chunk, session, stages)
        if manifest is not None and not manifest.try_record(ci, state):
            # lost the commit race to a speculative twin: adopt the
            # committed row so this chunk's calls and cache traffic are
            # counted exactly once in the merged result
            committed = manifest.get(ci)
            if committed is None:  # pragma: no cover — a commit is durable
                raise RuntimeError(
                    f"chunk {ci}: lost the manifest race but no committed "
                    "row is visible"
                )
            return ChunkOutcome(ci, start, len(chunk), state=committed, deduped=True)
        return ChunkOutcome(
            ci, start, len(chunk), state=state, accs=accs, engine=chunk_engine,
        )


def _finalize_metrics(
    names: list[str],
    accs: dict[str, MetricAccumulator],
    engine: BootstrapEngine | None,
    stats_cfg: StatisticsConfig,
) -> dict[str, MetricValue]:
    """Final :class:`MetricValue`s from the merged state (one code path for
    the serial and the concurrent pipelines: the same floats, the same
    bytes)."""
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


def _run_key(task: EvalTask) -> str:
    """Resume key: only configuration that affects the results — model,
    data prep, metrics, statistics, and the chunk layout
    (``max_memory_rows`` keys the bootstrap offsets) — decides whether
    committed chunks are reusable.  ``StatisticsConfig.backend`` stays in
    the key: the engines draw different weight streams.  Execution knobs
    (the whole InferenceConfig, the spill location, ``resume``, the
    concurrency and the example cap) are normalized away, so a restart may
    retune them without orphaning committed work.  The stopping rule is
    popped too: the manifest's regime row pins it, and a changed rule is a
    :class:`ManifestMismatch`, never a silent fresh directory.  Equal task
    JSON gives the reference's key, so the two packages share manifests."""
    payload = json.loads(task.to_json())
    payload.pop("inference", None)
    payload.pop("stopping", None)
    payload["streaming"] = {"max_memory_rows": task.streaming.max_memory_rows}
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()[:16]


def _check_row(ci: int, row: dict, start: int, chunk: list[dict]) -> None:
    """A committed row must describe the chunk the source gives now."""
    digest = _chunk_digest(chunk)
    if (
        row["n_rows"] != len(chunk)
        or row["start"] != start
        or row.get("digest") != digest
    ):
        raise ManifestMismatch(
            f"chunk {ci}: manifest has start={row['start']} "
            f"n_rows={row['n_rows']} digest={row.get('digest')}, "
            f"observed start={start} n_rows={len(chunk)} "
            f"digest={digest} — was the data source changed?"
        )


def _chunk_digest(chunk: list[dict]) -> str:
    """Content fingerprint of a chunk's rows: a resumed run must be fed the
    same data, not merely the same chunk layout."""
    payload = json.dumps(chunk, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


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
