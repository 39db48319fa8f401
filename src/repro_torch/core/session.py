"""EvalSession: the port's entry point (``repro/core/session.py``), the
long-lived owner of the evaluation resources on one device:

* **engine registry**: one initialized engine per model and serving
  arguments (``session.engines``);
* **inference services**: one :class:`~repro_torch.core.service.
  InferenceService` per engine (``service_for``), the submit/gather front
  that coalesces identical in-flight requests and batches across every
  task, chunk and suite job using that engine;
* **response caches**: one :class:`~repro_torch.core.cache.ResponseCache`
  per ``(cache_dir, policy)`` (``cache_for``);
* **accounting**: the session's totals across every task
  (:class:`SessionAccounting`).

``run_task`` runs a task in memory by default and in chunks with
``streaming.enabled``; pass ``stages=`` to swap stages (for instance
``rescore_stages(texts)``).  ``run_suite`` runs an
:class:`~repro_torch.core.suite.EvalSuite` and builds the pairwise
significance matrix.  Replicas, rate limiters and worker pools of the
reference are not part of the port yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Iterable, Sequence

import torch

from repro_torch.core.cache import ResponseCache
from repro_torch.core.config import CachePolicy, EngineModelConfig, EvalTask, InferenceConfig
from repro_torch.core.engines import EngineRegistry, TorchLocalEngine
from repro_torch.core.service import InferenceService
from repro_torch.core.stages import (
    CostBudgetMiddleware,
    EvalArtifact,
    EvalResult,
    Middleware,
    Stage,
    default_stages,
)
from repro_torch.core.streaming import StreamingPipeline
from repro_torch.core.suite import EvalSuite, SuiteResult, build_comparisons
from repro_torch.device import resolve_device


def serving_kwargs(inf: InferenceConfig) -> dict:
    """The engine arguments a task's inference config sets, each only where
    it differs from its default, as the reference's ``_add_paging_kwargs``
    forwards them.  Like the reference, an int8 cache without a page size
    forwards nothing and the cache stays contiguous."""
    kw: dict = {}
    if inf.max_prefills_per_step:
        kw["max_prefills_per_step"] = inf.max_prefills_per_step
    if inf.kv_page_size:
        kw["kv_page_size"] = inf.kv_page_size
        if not inf.prefix_cache:
            kw["prefix_cache"] = False
        if inf.kv_cache_dtype != "bf16":
            kw["kv_cache_dtype"] = inf.kv_cache_dtype
    return kw


@dataclasses.dataclass
class SessionAccounting:
    """Cost and token totals across every task the session has run, updated
    under ``lock`` (suite jobs may run on several threads)."""

    tasks: int = 0
    engine_calls: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    cost_usd: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    #: submissions answered by an in-flight twin's engine call
    coalesced_requests: int = 0
    wall_s: float = 0.0

    def __post_init__(self) -> None:
        self.lock = threading.Lock()

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class EvalSession:
    """Runs on the card unless ``device="cpu"`` is passed.
    ``engine_kwargs`` go to every :class:`TorchLocalEngine` the session
    builds (``n_slots``, ``max_len``, ``page_pool``, ``params``, ...); a
    task's :class:`InferenceConfig` adds its serving knobs, which an
    argument of ``engine_kwargs`` overrides.  ``params`` are one model's
    weights, so they suit a session that serves one model; otherwise each
    engine makes its weights from its model's seed."""

    def __init__(
        self,
        *,
        device: torch.device | str | None = None,
        engine_kwargs: dict | None = None,
        middleware: Iterable[Middleware] = (),
        cost_budget_usd: float | None = None,
    ):
        self.device = resolve_device(device)
        self._engine_kwargs = dict(engine_kwargs or {})
        self.middleware: list[Middleware] = list(middleware)
        if cost_budget_usd is not None:
            self.middleware.append(CostBudgetMiddleware(cost_budget_usd))
        self.engines = EngineRegistry()
        self.accounting = SessionAccounting()
        self._caches: dict[tuple[str, CachePolicy], ResponseCache] = {}
        self._services: dict[int, InferenceService] = {}
        # get-or-create is atomic: concurrent jobs asking for the same
        # cache or service share one instance
        self._res_lock = threading.Lock()
        self._closed = False

    # -- shared resources ------------------------------------------------------

    def _engine_args(self, inf: InferenceConfig) -> dict:
        return {"device": self.device, **serving_kwargs(inf), **self._engine_kwargs}

    def engine_for(
        self, model: EngineModelConfig, inf: InferenceConfig = InferenceConfig()
    ) -> TorchLocalEngine:
        """The engine for ``model`` under ``inf``'s serving knobs, built and
        initialized on first use."""
        self._check_open()
        return self.engines.get(model, **self._engine_args(inf))

    def service_for(
        self, model: EngineModelConfig, inf: InferenceConfig
    ) -> InferenceService:
        """The shared service of :meth:`engine_for`'s engine; its queue
        depth, coalescing default and batch window come from the first
        inference config that touches the engine."""
        engine = self.engine_for(model, inf)
        with self._res_lock:
            key = id(engine)
            svc = self._services.get(key)
            if svc is None:
                svc = InferenceService(
                    engine,
                    queue_depth=inf.service_queue_depth,
                    coalesce=inf.coalesce,
                    max_batch_wait_ms=inf.max_batch_wait_ms,
                    name=f"{model.provider}:{model.model_name}",
                )
                self._services[key] = svc
        return svc

    def serving_stats(self) -> list[dict]:
        """Each service's snapshot (submission and coalescing counters, and
        the engine's batcher counters)."""
        with self._res_lock:
            services = list(self._services.values())
        return [s.snapshot() for s in services]

    def cache_for(self, inf: InferenceConfig) -> ResponseCache | None:
        if not inf.cache_dir or inf.cache_policy == CachePolicy.DISABLED:
            return None
        key = (inf.cache_dir, inf.cache_policy)
        with self._res_lock:
            cache = self._caches.get(key)
            if cache is None:
                cache = ResponseCache(inf.cache_dir, inf.cache_policy)
                self._caches[key] = cache
        return cache

    # -- pipeline execution -----------------------------------------------------

    def run_task(
        self,
        rows: Iterable[dict],
        task: EvalTask,
        *,
        stages: Sequence[Stage] | None = None,
    ) -> EvalResult:
        """With ``task.streaming.enabled``, stream ``rows`` through prepare
        -> infer -> score in chunks of ``max_memory_rows``: the result
        carries ``metrics`` and the mergeable ``stream_stats``.  Otherwise
        run ``stages`` (default: prepare -> infer -> score -> aggregate)
        over all of ``rows`` in memory, each stage's seconds in
        ``timing[f"{stage.name}_s"]``: the result carries ``metrics``, the
        per-example ``scores`` and the ``responses``."""
        self._check_open()
        if task.streaming.enabled:
            if stages is not None:
                raise ValueError(
                    "streaming tasks run a fixed per-chunk pipeline; "
                    "custom stages are not supported"
                )
            return self._run_streaming(rows, task)
        pipeline = list(stages) if stages is not None else default_stages()
        art = EvalArtifact(rows=list(rows), task=task)
        t_task = time.monotonic()
        for mw in self.middleware:
            mw.on_task_start(task, art.rows, self)
        for stage in pipeline:
            for mw in self.middleware:
                mw.on_stage_start(stage, art, self)
            t0 = time.monotonic()
            art = stage.run(art, self)
            art.timing[f"{stage.name}_s"] = time.monotonic() - t0
            for mw in self.middleware:
                mw.on_stage_end(stage, art, self)
        result = art.to_result()
        self._task_done(task, result, t_task)
        return result

    def _run_streaming(self, source: Iterable[dict], task: EvalTask) -> EvalResult:
        t_task = time.monotonic()
        for mw in self.middleware:
            mw.on_task_start(task, [], self)
        result = StreamingPipeline.from_task(task).run(source, task, self)
        self._task_done(task, result, t_task)
        return result

    def _task_done(self, task: EvalTask, result: EvalResult, t_task: float) -> None:
        with self.accounting.lock:
            self.accounting.tasks += 1
            self.accounting.wall_s += time.monotonic() - t_task
        for mw in self.middleware:
            mw.on_task_end(task, result, self)

    def run_suite(
        self,
        suite: EvalSuite,
        *,
        stages: Sequence[Stage] | None = None,
        parallel_jobs: int = 1,
    ) -> SuiteResult:
        """Run every (model, task) job of the suite, reusing the session's
        engines, services and caches, and build the pairwise significance
        matrix for every metric the models share.

        ``parallel_jobs > 1`` runs that many jobs at once on a thread pool;
        jobs on different engines then decode at the same time, each in its
        service's batcher thread.  Each job's result is the one a serial
        run gives."""
        self._check_open()
        results: dict[tuple[str, str], EvalResult] = {}
        jobs = suite.jobs()

        def _run_job(job):
            # a callable source yields a fresh iterator per job
            rows = job.rows() if callable(job.rows) else job.rows
            return (
                (job.model_label, job.task.task_id),
                self.run_task(rows, job.task, stages=stages),
            )

        if parallel_jobs <= 1:
            for job in jobs:
                k, v = _run_job(job)
                results[k] = v
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=parallel_jobs) as ex:
                for k, v in ex.map(_run_job, jobs):
                    results[k] = v
        comparisons = build_comparisons(suite, results, device=self.device)
        accounting = self.accounting.as_dict()
        serving = self.serving_stats()
        if serving:
            accounting["serving"] = serving
        return SuiteResult(
            name=suite.name,
            models=suite.model_labels(),
            tasks=suite.task_ids(),
            results=results,
            comparisons=comparisons,
            accounting=accounting,
        )

    # -- lifecycle ---------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("EvalSession is closed")

    def close(self) -> None:
        if self._closed:
            return
        # services drain (queued work finishes, batcher threads join)
        # before their engines go away
        for svc in self._services.values():
            svc.close()
        self._services.clear()
        self.engines.shutdown()
        self._caches.clear()
        self._closed = True

    def __enter__(self) -> "EvalSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
