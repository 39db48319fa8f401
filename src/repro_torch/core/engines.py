"""The port's local inference engine (counterpart of ``LocalJaxEngine`` in
``repro/core/engines.py``): serves a model through the continuous batcher
on one device, with the reference's request/response types and its
slot-streaming protocol; and :class:`EngineRegistry`, one initialized
engine per model and serving arguments."""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import EngineModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import build_model, init_params
from repro_torch.serve import steps as steps_lib
from repro_torch.serve.scheduler import (
    Completion,
    ContinuousBatcher,
    Request,
    check_kv_cache,
)

PROVIDER = "torch_local"


@dataclasses.dataclass
class InferenceRequest:
    prompt: str
    max_tokens: int = 64
    temperature: float = 0.0


@dataclasses.dataclass
class InferenceResponse:
    text: str
    input_tokens: int
    output_tokens: int
    latency_ms: float
    cost_usd: float = 0.0
    error: str | None = None


class TorchLocalEngine:
    """Serve an architecture of the port through :class:`ContinuousBatcher`.

    ``infer_batch`` submits a batch and drains the batcher; the streaming
    protocol (``stream_submit`` / ``stream_pump`` / ``stream_pending`` /
    ``stream_cancel``) admits prompts into decode slots as slots free.
    Greedy decode is batch-composition independent, so both give the same
    tokens for a prompt.  ``params`` may carry bridged weights
    (:func:`repro_torch.models.params_from_jax`); otherwise they are made on
    the device from ``model.seed``.

    ``kv_page_size`` > 0 serves from a paged KV cache with hash-chain
    prefix sharing (``prefix_cache``); ``page_pool`` or ``page_pool_bytes``
    pins the pool smaller than its never-exhausting default, so decode
    pressure preempts; ``kv_cache_dtype="int8"`` quantizes the pages.  Paging
    is for the attention families: a Mamba2 model raises ``ValueError`` at
    ``initialize``, as the reference's batcher does.

    One lock serializes every use of the batcher, so the service's batcher
    thread and a direct ``infer_batch`` caller may share the engine.
    """

    supports_streaming = True

    def __init__(
        self,
        model: EngineModelConfig,
        *,
        n_slots: int = 8,
        max_len: int = 256,
        max_prefills_per_step: int = 0,
        kv_page_size: int = 0,
        prefix_cache: bool = True,
        page_pool: int = 0,
        page_pool_bytes: int = 0,
        kv_cache_dtype: str = "bf16",
        device: torch.device | str | None = None,
        params: dict | None = None,
    ):
        if model.provider != PROVIDER:
            raise ValueError(f"provider must be {PROVIDER!r}, got {model.provider!r}")
        steps_lib.check_sampling(model.temperature)
        check_kv_cache(kv_page_size, kv_cache_dtype)
        self.model_cfg = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_prefills_per_step = max_prefills_per_step
        self.paging = {
            "page_size": kv_page_size, "prefix_cache": prefix_cache,
            "page_pool": page_pool, "page_pool_bytes": page_pool_bytes,
            "kv_cache_dtype": kv_cache_dtype,
        }
        self.device = resolve_device(device)
        self._params = params
        self.batcher: ContinuousBatcher | None = None
        self._tokenizer: HashTokenizer | None = None
        self._next_id = 0
        self._lock = threading.RLock()

    def initialize(self) -> None:
        with self._lock:
            if self.batcher is not None:
                return
            cfg = get_config(self.model_cfg.model_name)
            if self.model_cfg.reduced:
                cfg = cfg.reduced()
            self._tokenizer = HashTokenizer(cfg.vocab_size)
            params = self._params
            if params is None:
                params = init_params(cfg, self.model_cfg.seed, device=self.device)
            elif params["embed"].device != self.device:
                raise ValueError(
                    f"params are on {params['embed'].device}, the engine on {self.device}"
                )
            self.batcher = ContinuousBatcher(
                build_model(cfg), cfg, params,
                n_slots=self.n_slots, max_len=self.max_len,
                eos_id=self._tokenizer.eos_id,
                max_prefills_per_step=self.max_prefills_per_step,
                **self.paging,
            )

    def shutdown(self) -> None:
        with self._lock:
            self.batcher = None

    def _submit(self, request: InferenceRequest) -> int:
        steps_lib.check_sampling(request.temperature)
        self.initialize()
        rid = self._next_id
        self._next_id += 1
        toks = self._tokenizer.encode(request.prompt)[: self.max_len // 2]
        self.batcher.submit(
            Request(
                request_id=rid,
                prompt_tokens=toks or [self._tokenizer.bos_id],
                max_new_tokens=min(
                    request.max_tokens, self.max_len - len(toks) - 1
                ),
            )
        )
        return rid

    def _response(self, c: Completion) -> InferenceResponse:
        return InferenceResponse(
            text=self._tokenizer.decode(c.tokens),
            input_tokens=c.prompt_len,
            output_tokens=len(c.tokens),
            latency_ms=c.latency_s * 1000.0,
        )

    def infer_batch(
        self, requests: list[InferenceRequest]
    ) -> list[InferenceResponse]:
        with self._lock:
            return self._infer_batch_locked(requests)

    def _infer_batch_locked(
        self, requests: list[InferenceRequest]
    ) -> list[InferenceResponse]:
        t0 = time.monotonic()
        ids = {self._submit(r): i for i, r in enumerate(requests)}
        completions = self.batcher.run_to_completion()
        # streaming requests the drain carried along stay for stream_pump
        self.batcher.completions = [
            c for c in completions if c.request_id not in ids
        ]
        out: list[InferenceResponse | None] = [None] * len(requests)
        for c in completions:
            if c.request_id in ids:
                out[ids[c.request_id]] = self._response(c)
        dt_ms = (time.monotonic() - t0) * 1000.0
        return [
            r if r is not None else InferenceResponse(
                text="", input_tokens=0, output_tokens=0, latency_ms=dt_ms,
                error="lost",
            )
            for r in out
        ]

    # -- slot streaming --------------------------------------------------------

    def stream_submit(self, request: InferenceRequest) -> int:
        with self._lock:
            return self._submit(request)

    def stream_pump(self) -> list[tuple[int, InferenceResponse]]:
        """Advance decode by one step (admitting queued prompts into free
        slots first) and return the requests that finished."""
        with self._lock:
            b = self.batcher
            if b is None:
                return []
            if b.queue or b.slots_busy:
                b.step()
            return [(c.request_id, self._response(c)) for c in b.drain_completions()]

    def stream_pending(self) -> bool:
        with self._lock:
            b = self.batcher
            return bool(b and (b.queue or b.slots_busy or b.completions))

    def stream_cancel(self, rid: int) -> bool:
        with self._lock:
            return bool(self.batcher) and self.batcher.cancel(rid)

    def serving_stats(self) -> dict:
        with self._lock:
            return {} if self.batcher is None else self.batcher.stats.as_dict()


def _kwargs_key(kw: dict) -> str:
    """The registry's key for an engine's arguments: JSON of the plain
    values, and the identity of any other (a ``params`` dict of tensors is
    the same weights only if it is the same object)."""
    def plain(v: Any) -> Any:
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, torch.device):
            return str(v)
        return f"<id {id(v)}>"

    return json.dumps({k: plain(v) for k, v in kw.items()}, sort_keys=True)


class EngineRegistry:
    """One initialized engine per (:class:`EngineModelConfig`, engine
    arguments), the reference's ``EngineRegistry``: a session amortizes an
    engine's set-up across every task it runs.  Lookups from concurrent
    jobs initialize an engine once."""

    def __init__(self) -> None:
        self._engines: dict[tuple[EngineModelConfig, str], TorchLocalEngine] = {}
        self._lock = threading.Lock()

    def get(self, model: EngineModelConfig, **kw: Any) -> TorchLocalEngine:
        key = (model, _kwargs_key(kw))
        with self._lock:
            engine = self._engines.get(key)
            if engine is None:
                engine = TorchLocalEngine(model, **kw)
                engine.initialize()
                self._engines[key] = engine
        return engine

    def shutdown(self) -> None:
        for engine in self._engines.values():
            engine.shutdown()
        self._engines.clear()

    def __len__(self) -> int:
        return len(self._engines)
