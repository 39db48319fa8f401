"""EvalSession: the port's entry point (``repro/core/session.py``).  A
session holds one inference engine on one device and runs tasks through
it, in memory by default and in chunks with ``streaming.enabled``; the
inference service, response cache, middleware, replicas and suites of the
reference come in later slices."""

from __future__ import annotations

import time
from typing import Any, Iterable, Sequence

import torch

from repro_torch.core.config import EngineModelConfig, EvalTask, InferenceConfig
from repro_torch.core.engines import TorchLocalEngine
from repro_torch.core.stages import EvalArtifact, EvalResult, default_stages
from repro_torch.core.streaming import StreamingPipeline
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


class EvalSession:
    """Runs on the card unless ``device="cpu"`` is passed.
    ``engine_kwargs`` go to :class:`TorchLocalEngine` (``n_slots``,
    ``max_len``, ``page_pool``, ``params``, ...); a task's
    :class:`InferenceConfig` adds its serving knobs, which an argument of
    ``engine_kwargs`` overrides."""

    def __init__(
        self,
        *,
        device: torch.device | str | None = None,
        engine_kwargs: dict | None = None,
    ):
        self.device = resolve_device(device)
        self._engine_kwargs = dict(engine_kwargs or {})
        self.engine: TorchLocalEngine | None = None
        self._engine_key: tuple | None = None
        self._closed = False

    def engine_for(
        self, model: EngineModelConfig, inf: InferenceConfig = InferenceConfig()
    ) -> TorchLocalEngine:
        """The session's engine, built and initialized on first use; a task
        that needs another model or other serving knobs raises."""
        self._check_open()
        serving = serving_kwargs(inf)
        key = (model, sorted(serving.items()))
        if self.engine is None:
            self.engine = TorchLocalEngine(
                model, device=self.device, **{**serving, **self._engine_kwargs}
            )
            self.engine.initialize()
            self._engine_key = key
        elif self._engine_key != key:
            raise ValueError(
                f"this session serves {self._engine_key}, not {key}"
            )
        return self.engine

    def run_task(
        self,
        rows: Iterable[dict],
        task: EvalTask,
        *,
        stages: Sequence[Any] | None = None,
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
            return StreamingPipeline.from_task(task).run(rows, task, self)
        pipeline = list(stages) if stages is not None else default_stages()
        art = EvalArtifact(rows=list(rows), task=task)
        for stage in pipeline:
            t0 = time.monotonic()
            art = stage.run(art, self)
            art.timing[f"{stage.name}_s"] = time.monotonic() - t0
        engine_stats = self.engine.serving_stats() if self.engine is not None else {}
        return art.to_result(engine_stats)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("EvalSession is closed")

    def close(self) -> None:
        if self.engine is not None:
            self.engine.shutdown()
            self.engine = None
            self._engine_key = None
        self._closed = True

    def __enter__(self) -> "EvalSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
