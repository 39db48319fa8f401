"""EvalSession: the port's entry point (``repro/core/session.py``), the
long-lived owner of the evaluation resources on one device:

* **engine registry**: one initialized engine per model and serving
  arguments (``session.engines``);
* **inference services**: one :class:`~repro_torch.core.service.
  InferenceService` per engine (``service_for``), the submit/gather front
  that coalesces identical in-flight requests and batches across every
  task, chunk and suite job using that engine, fanned out over
  ``n_replicas`` engine replicas on the session's device with the
  configuration's routing, deadlines, restarts and health probe (on one
  card, replicas are for fault tolerance, not throughput: see
  :mod:`~repro_torch.core.service`);
* **response caches**: one :class:`~repro_torch.core.cache.ResponseCache`
  per ``(cache_dir, policy)`` (``cache_for``);
* **rate limiters and worker pools**: one per inference configuration
  (``limiter_for``, ``pool_for``), shared by the tasks that use it;
* **a judge engine** for the judge metrics (``judge_engine``; without one
  a judge metric grades with the task's own engine);
* **accounting**: the session's totals across every task
  (:class:`SessionAccounting`).

``run_task`` runs a task in memory by default and in chunks with
``streaming.enabled`` (spilled to a resumable manifest with a
``spill_dir``, several chunks at once with ``max_inflight_chunks > 1``,
stopped early by ``task.stopping``); pass ``stages=`` to swap stages (for
instance ``rescore_stages(texts)``).  ``run_suite`` runs an
:class:`~repro_torch.core.suite.EvalSuite` and builds the pairwise
significance matrix.  Rate limits sleep only with
``wall_clock_rate_limit=True`` (``sleep``); otherwise limiters, retry and
restart backoffs and the service's batch window keep accounts without
waiting.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Iterable, Sequence

import torch

from repro_torch.core.cache import ResponseCache
from repro_torch.core.config import CachePolicy, EngineModelConfig, EvalTask, InferenceConfig
from repro_torch.core.engines import PROVIDER, EngineRegistry, InferenceEngine
from repro_torch.core.ratelimit import AdaptiveLimiter, TokenBucket
from repro_torch.core.service import InferenceService, ReplicaRouter
from repro_torch.core.stages import (
    CostBudgetMiddleware,
    EvalArtifact,
    EvalResult,
    Middleware,
    Stage,
    default_stages,
)
from repro_torch.core.streaming import ConcurrentStreamingExecutor, StreamingPipeline
from repro_torch.core.suite import EvalSuite, SuiteResult, build_comparisons
from repro_torch.device import resolve_device
from repro_torch.ft.workers import WorkerPool


#: the providers whose engines take a task's serving arguments (slot engines)
SLOT_PROVIDERS = (PROVIDER, "slotsim")


def serving_kwargs(inf: InferenceConfig) -> dict:
    """The engine arguments a task's inference config sets, each only where
    it differs from its default, as the reference's ``_add_paging_kwargs``
    forwards them (``max_prefills_per_step`` at any replica count, where the
    reference forwards it to fleets of two or more only).  Like the
    reference, an int8 cache without a page size forwards nothing and the
    cache stays contiguous."""
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
    ``engine_kwargs`` go to every engine the session builds (for the local
    engine ``n_slots``, ``max_len``, ``page_pool``, ``params``,
    ``fault_plan``, ...); a slot engine (local or ``slotsim``) also gets a
    task's serving knobs from its :class:`InferenceConfig`, which an
    argument of ``engine_kwargs`` overrides, and a local engine the
    session's device.  ``params`` are one model's weights, so they suit a
    session that serves one model (its replicas then share them);
    otherwise each engine makes its weights from its model's seed."""

    def __init__(
        self,
        *,
        device: torch.device | str | None = None,
        judge_engine: InferenceEngine | None = None,
        wall_clock_rate_limit: bool = False,
        engine_kwargs: dict | None = None,
        middleware: Iterable[Middleware] = (),
        cost_budget_usd: float | None = None,
    ):
        self.device = resolve_device(device)
        self.judge_engine = judge_engine
        self.wall_clock = wall_clock_rate_limit
        self._engine_kwargs = dict(engine_kwargs or {})
        self.middleware: list[Middleware] = list(middleware)
        if cost_budget_usd is not None:
            self.middleware.append(CostBudgetMiddleware(cost_budget_usd))
        self.engines = EngineRegistry()
        self.accounting = SessionAccounting()
        self._caches: dict[tuple[str, CachePolicy], ResponseCache] = {}
        self._services: dict[int, InferenceService] = {}
        self._limiters: dict[tuple, Any] = {}
        self._pools: dict[tuple, WorkerPool] = {}
        # get-or-create is atomic: concurrent jobs asking for the same
        # cache, service, limiter or pool share one instance
        self._res_lock = threading.Lock()
        self._closed = False

    # -- shared resources ------------------------------------------------------

    @property
    def sleep(self):
        """What rate limiters and retry backoffs wait with: ``time.sleep``
        with ``wall_clock_rate_limit``, else a sleep that does nothing."""
        return time.sleep if self.wall_clock else (lambda s: None)

    def _engine_args(self, model: EngineModelConfig, inf: InferenceConfig) -> dict:
        if model.provider not in SLOT_PROVIDERS:
            return dict(self._engine_kwargs)
        kw = serving_kwargs(inf)
        if model.provider == PROVIDER:
            kw["device"] = self.device
        return {**kw, **self._engine_kwargs}

    def engine_for(
        self, model: EngineModelConfig, inf: InferenceConfig = InferenceConfig()
    ) -> InferenceEngine:
        """The engine for ``model`` under ``inf``'s serving knobs, built and
        initialized on first use.  Engines called directly (a judge, the
        lock-step path) are not serving replicas, so a ``fault_plan`` of
        ``engine_kwargs`` is not passed and they claim no replica index."""
        self._check_open()
        kw = self._engine_args(model, inf)
        kw.pop("fault_plan", None)
        return self.engines.get(model, **kw)

    def _replica_engines(
        self, model: EngineModelConfig, inf: InferenceConfig,
        first: InferenceEngine, kw: dict,
    ) -> list[InferenceEngine]:
        """One engine a data-parallel replica, built in replica order (so a
        fault plan's replica indices follow it), each with its own batcher
        and cache; replica 0 is ``first``.  Every replica sits on the
        session's one device, and local replicas share replica 0's
        tokenizer (see :class:`~repro_torch.core.engines.TorchLocalEngine`)."""
        if model.provider == PROVIDER:
            kw = {"tokenizer": first.tokenizer, **kw}
        return [first] + [self.engines.get(model, replica=i, **kw)
                          for i in range(1, max(1, inf.n_replicas))]

    def service_for(
        self, model: EngineModelConfig, inf: InferenceConfig
    ) -> InferenceService:
        """The shared service of ``model`` under ``inf``'s serving knobs,
        whose replica 0 is :meth:`engine_for`'s engine when no fault plan is
        given; its fan-out (``n_replicas``, ``routing``), fault tolerance,
        queue depth, coalescing default, batch window and least dispatcher
        count come from the first inference config that touches it."""
        self._check_open()
        kw = self._engine_args(model, inf)
        first = self.engines.get(model, **kw)
        with self._res_lock:
            svc = self._services.get(id(first))
            if svc is None:
                svc = InferenceService(
                    engines=self._replica_engines(model, inf, first, kw),
                    routing=ReplicaRouter(inf.routing,
                                          prefix_len=inf.routing_prefix_len),
                    queue_depth=inf.service_queue_depth,
                    coalesce=inf.coalesce,
                    max_batch_wait_ms=inf.max_batch_wait_ms,
                    n_dispatchers=inf.n_workers,
                    sleep=self.sleep,
                    name=f"{model.provider}:{model.model_name}",
                    max_replica_restarts=inf.max_replica_restarts,
                    restart_backoff_s=inf.restart_backoff_s,
                    health_probe_steps=inf.health_probe_steps,
                )
                self._services[id(first)] = svc
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

    def limiter_for(self, inf: InferenceConfig):
        """The rate limiter of ``inf``: an :class:`AdaptiveLimiter` with
        ``adaptive_rate``, else one :class:`TokenBucket` a worker."""
        key = (inf.adaptive_rate, inf.rate_limit_rpm, inf.rate_limit_tpm,
               inf.n_workers)
        with self._res_lock:
            limiter = self._limiters.get(key)
            if limiter is None:
                if inf.adaptive_rate:
                    limiter = AdaptiveLimiter(
                        inf.rate_limit_rpm, inf.rate_limit_tpm, inf.n_workers,
                        sleep=self.sleep,
                    )
                else:
                    limiter = [
                        TokenBucket(inf.rate_limit_rpm, inf.rate_limit_tpm,
                                    inf.n_workers, sleep=self.sleep)
                        for _ in range(inf.n_workers)
                    ]
                self._limiters[key] = limiter
        return limiter

    def pool_for(self, inf: InferenceConfig) -> WorkerPool:
        """The lock-step path's worker pool of ``inf``."""
        straggler = inf.straggler_factor if inf.speculative_reissue else 0.0
        key = (inf.n_workers, inf.max_retries, straggler)
        with self._res_lock:
            pool = self._pools.get(key)
            if pool is None:
                pool = WorkerPool(
                    n_workers=inf.n_workers,
                    max_retries=inf.max_retries,
                    straggler_factor=straggler,
                )
                self._pools[key] = pool
        return pool

    # -- pipeline execution -----------------------------------------------------

    def run_task(
        self,
        rows: Iterable[dict],
        task: EvalTask,
        *,
        stages: Sequence[Stage] | None = None,
    ) -> EvalResult:
        """With ``task.streaming.enabled``, stream ``rows`` through prepare
        -> infer -> score in chunks of ``max_memory_rows`` (with
        ``max_inflight_chunks > 1``, that many chunks at once, merged in
        chunk order): the result carries ``metrics`` and the mergeable
        ``stream_stats``.  Otherwise
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
        if task.streaming.max_inflight_chunks > 1:
            pipeline = ConcurrentStreamingExecutor.from_task(task)
        else:
            pipeline = StreamingPipeline.from_task(task)
        result = pipeline.run(source, task, self)
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
