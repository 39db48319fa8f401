"""The port's inference engines (``repro/core/engines.py``):

* :class:`TorchLocalEngine` (counterpart of ``LocalJaxEngine``) serves a
  model through the continuous batcher on one device, with the reference's
  request/response types and its slot-streaming protocol;
* :class:`SimulatedAPIEngine`, the reference's deterministic stand-in for
  the OpenAI / Anthropic / Google providers: a latency model, the price
  book and responses that are a pure function of (prompt, model), with
  recoverable failures injected on demand (``fail_every``);
* :class:`SimulatedSlotEngine`, the reference's host-only slot simulator
  (``provider="slotsim"``): decode slots, page accounting, preemption and
  scheduled serving faults, with the simulated API engine's texts;
* :func:`retry_with_backoff` and the recoverable-error taxonomy the
  lock-step path and the inference service retry on;
* :func:`create_engine` and :class:`EngineRegistry`, one initialized engine
  per model, replica index and engine arguments."""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import json
import math
import re
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import EngineModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import build_model, init_params
from repro_torch.ft.failure_sim import SimulatedCrash
from repro_torch.serve.paged_cache import (
    PagedCacheManager,
    PagePoolExhausted,
    kv_page_bytes,
    pages_for_budget,
)
from repro_torch.serve.scheduler import (
    BatcherStats,
    Completion,
    ContinuousBatcher,
    Request,
    check_kv_cache,
)

#: the provider name of the port's local engine
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


class RecoverableEngineError(RuntimeError):
    """A transient engine failure worth retrying, the exception form of the
    429/5xx error strings of :data:`RECOVERABLE_ERROR_CODES`.  The retry
    paths back off and re-attempt on this type only; any other exception
    fails the request at once with its own traceback."""


# -- price book (USD per million input / output tokens) ----------------------

PRICE_BOOK: dict[tuple[str, str], tuple[float, float]] = {
    ("openai", "gpt-4o"): (2.50, 15.00),
    ("openai", "gpt-4o-mini"): (0.15, 0.60),
    ("openai", "gpt-4-turbo"): (10.00, 30.00),
    ("openai", "gpt-3.5-turbo"): (0.50, 1.50),
    ("anthropic", "claude-3-5-sonnet"): (3.00, 15.00),
    ("anthropic", "claude-3-opus"): (15.00, 75.00),
    ("anthropic", "claude-3-sonnet"): (3.00, 15.00),
    ("anthropic", "claude-3-haiku"): (0.25, 1.25),
    ("google", "gemini-1.5-pro"): (1.25, 5.00),
    ("google", "gemini-1.5-flash"): (0.075, 0.30),
    ("google", "gemini-1.0-pro"): (0.50, 1.50),
}


def api_cost(provider: str, model: str, in_tok: int, out_tok: int) -> float:
    pin, pout = PRICE_BOOK.get((provider, model), (0.0, 0.0))
    return (in_tok * pin + out_tok * pout) / 1e6


#: simulated answer quality per model tier (drives model comparisons)
_MODEL_QUALITY: dict[str, float] = {
    "gpt-4o": 0.95, "gpt-4-turbo": 0.93, "gpt-4o-mini": 0.78,
    "gpt-3.5-turbo": 0.70, "claude-3-5-sonnet": 0.95, "claude-3-opus": 0.94,
    "claude-3-sonnet": 0.88, "claude-3-haiku": 0.75, "gemini-1.5-pro": 0.92,
    "gemini-1.5-flash": 0.80, "gemini-1.0-pro": 0.72,
}


class InferenceEngine(abc.ABC):
    """What the stages and the service need of an engine.  Slot engines
    (``supports_streaming``) also speak the slot-streaming protocol and are
    served by one batcher thread; the others are served by a pool of
    dispatcher threads, one ``infer`` a request."""

    supports_streaming: bool = False

    @abc.abstractmethod
    def initialize(self) -> None: ...

    @abc.abstractmethod
    def infer_batch(
        self, requests: list[InferenceRequest]
    ) -> list[InferenceResponse]: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    def infer(self, request: InferenceRequest) -> InferenceResponse:
        return self.infer_batch([request])[0]

    def reset(self) -> None:
        """The replica-restart hook: drop all in-flight serving state
        (queued and slotted requests, their cache) so that a fresh batcher
        loop starts clean; cumulative counters survive.  By default a full
        shutdown and initialize."""
        self.shutdown()
        self.initialize()

    def serving_stats(self) -> dict:
        """Batcher counters of a slot engine; ``{}`` otherwise."""
        return {}


# -- simulated API engine -------------------------------------------------------


def simulated_answer(prompt: str, max_tokens: int, model_name: str) -> str:
    """Deterministic response text, a pure function of (prompt, model).
    A ``[Judge]`` prompt gets a parseable verdict (``Score: n`` on the
    prompt's 1-n scale, lower for ``flub`` fillers in the graded response,
    or ``Winner: A|B``), except for a rare malformed one; any other prompt
    gets an echo of its salient words, each replaced by a ``flub`` filler
    with the model tier's error rate, and a hash suffix."""
    h = hashlib.sha256(prompt.encode()).hexdigest()
    hv = int(h[:8], 16)
    if prompt.startswith("[Judge]"):
        if hv % 797 == 0:
            return "I cannot assess this response."
        if "Winner:" in prompt or "Response A:" in prompt:
            return f"Winner: {'A' if hv % 2 == 0 else 'B'} — clearer answer."
        scale = 5
        m = re.search(r"1-(\d+) scale", prompt)
        if m:
            scale = int(m.group(1))
        m2 = re.search(r"Response: (.*)", prompt, re.DOTALL)
        resp = m2.group(1) if m2 else ""
        flubs = resp.count("flub")
        score = max(1, min(scale, scale - flubs + (hv % 2)))
        return f"Score: {score}. Concise and mostly accurate."
    words = prompt.split()
    quality = _MODEL_QUALITY.get(model_name, 0.8)
    salient = [w for w in words if len(w) > 3][: max(3, max_tokens // 4)]
    kept = []
    for i, w in enumerate(salient):
        wh = int(hashlib.sha256(f"{w}{i}{h[:4]}".encode()).hexdigest()[:4], 16)
        if (wh % 1000) / 1000.0 < quality:
            kept.append(w)
        else:
            kept.append(f"flub{wh % 97}")
    return " ".join(kept + [f"ans_{h[:8]}"])


class SimulatedAPIEngine(InferenceEngine):
    """Deterministic provider stand-in: latency = base + per-token x output
    tokens + a jitter from the prompt hash, cost from :data:`PRICE_BOOK`,
    text from :func:`simulated_answer`.  ``wall_clock=False`` accounts the
    latency without sleeping; ``fail_every=n`` answers every n-th call with
    a recoverable ``rate_limited_429`` error."""

    def __init__(
        self,
        model: EngineModelConfig,
        *,
        base_latency_ms: float = 250.0,
        per_token_ms: float = 0.6,
        wall_clock: bool = False,
        fail_every: int = 0,
    ):
        self.model = model
        self.base_latency_ms = base_latency_ms
        self.per_token_ms = per_token_ms
        self.wall_clock = wall_clock
        self.fail_every = fail_every
        self.calls = 0
        self.total_cost = 0.0
        self.initialized = False
        # dispatcher threads share one engine: counters update under a lock
        self._counter_lock = threading.Lock()

    def initialize(self) -> None:
        self.initialized = True

    def shutdown(self) -> None:
        self.initialized = False

    @staticmethod
    def _count_tokens(text: str) -> int:
        return max(1, len(text.split()))

    def infer(self, request: InferenceRequest) -> InferenceResponse:
        with self._counter_lock:
            self.calls += 1
            call_no = self.calls
        if self.fail_every and call_no % self.fail_every == 0:
            return InferenceResponse(
                text="", input_tokens=0, output_tokens=0,
                latency_ms=self.base_latency_ms, error="rate_limited_429",
            )
        text = simulated_answer(request.prompt, request.max_tokens, self.model.model_name)
        in_tok = self._count_tokens(request.prompt)
        out_tok = min(self._count_tokens(text), request.max_tokens)
        jitter = int(hashlib.sha256(request.prompt.encode()).hexdigest()[:4], 16)
        latency = self.base_latency_ms + self.per_token_ms * out_tok + jitter % 50
        if self.wall_clock:
            time.sleep(latency / 1000.0)
        cost = api_cost(self.model.provider, self.model.model_name, in_tok, out_tok)
        with self._counter_lock:
            self.total_cost += cost
        return InferenceResponse(
            text=text, input_tokens=in_tok, output_tokens=out_tok,
            latency_ms=latency, cost_usd=cost,
        )

    def infer_batch(self, requests: list[InferenceRequest]) -> list[InferenceResponse]:
        return [self.infer(r) for r in requests]


# -- simulated slot engine ------------------------------------------------------------

#: nominal KV geometry the slot simulator charges page bytes against (shaped
#: like the reduced qwen3 serving config), so simulated byte budgets track
#: the real batcher's page economics
SIM_KV_HEADS = 8
SIM_HEAD_DIM = 64
SIM_LAYERS = 4


@dataclasses.dataclass
class SlotSimStats(BatcherStats):
    """The slot simulator's counters, with the reference's keys: the
    batcher's, and ``prefill_recompiles`` (distinct prompt-length buckets
    admitted), without host-clock seconds."""

    prefill_recompiles: int = 0

    def as_dict(self) -> dict:
        out = super().as_dict()
        del out["prefill_s"], out["decode_s"]
        return out


class SimulatedSlotEngine(InferenceEngine):
    """Deterministic slot-multiplexed decode engine on the host (no tensor
    math), the reference's: ``n_slots`` decode slots advance one token per
    step at ``step_ms``, with the simulated API engine's texts and
    deterministic, long-tail skewed output lengths, so serving tests
    measure scheduling, not model math.

    ``infer_batch`` is the lock-step path: requests decode in gangs of
    ``n_slots`` and a gang drains at its slowest member's length.  The
    streaming interface refills slots as they free, which the
    :class:`~repro_torch.core.service.InferenceService` batcher loop
    drives.  ``kv_page_size`` > 0 charges prompt words to a
    :class:`~repro_torch.serve.paged_cache.PagedCacheManager` (prefix
    sharing, a low-watermark admission gate, preemption of the cheapest
    slot under pressure, and with ``decode_page_growth`` a page per decoded
    token); ``kv_cache_dtype`` changes page bytes, never text.
    ``fault_plan`` (a :class:`~repro_torch.ft.ServingFaultSchedule`) is
    polled every pump under the replica index the engine claimed at
    construction.
    """

    supports_streaming = True

    def __init__(
        self,
        model: EngineModelConfig,
        *,
        n_slots: int = 8,
        step_ms: float = 0.5,
        wall_clock: bool = False,
        min_out: int = 4,
        max_out: int = 48,
        max_prefills_per_step: int = 0,
        kv_page_size: int = 0,
        prefix_cache: bool = True,
        prefill_ms_per_token: float = 0.0,
        page_pool: int = 4096,
        page_pool_bytes: int = 0,
        kv_cache_dtype: str = "bf16",
        decode_page_growth: bool = False,
        fault_plan: Any = None,
    ):
        self.model = model
        self.n_slots = n_slots
        self.step_ms = step_ms
        self.wall_clock = wall_clock
        self.min_out = min_out
        self.max_out = max_out
        #: 0 = unlimited; otherwise at most this many queued prompts are
        #: prefilled into free slots per pump
        self.max_prefills_per_step = max_prefills_per_step
        #: wall time each uncached prompt word charges at admission
        self.prefill_ms_per_token = prefill_ms_per_token
        self.kv_page_size = kv_page_size
        self.kv_cache_dtype = kv_cache_dtype
        self.decode_page_growth = decode_page_growth
        if kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'bf16' or 'int8', got "
                f"{kv_cache_dtype!r}"
            )
        if kv_cache_dtype == "int8" and not kv_page_size:
            raise ValueError(
                "kv_cache_dtype='int8' requires a paged cache "
                "(kv_page_size > 0)"
            )
        page_bytes = 0
        self._pages: PagedCacheManager | None = None
        if kv_page_size:
            page_bytes = kv_page_bytes(
                kv_page_size, SIM_KV_HEADS, SIM_HEAD_DIM, SIM_LAYERS,
                kv_cache_dtype,
            )
            if page_pool_bytes:
                page_pool = pages_for_budget(page_pool_bytes, page_bytes)
            self._pages = PagedCacheManager(
                page_pool, kv_page_size, prefix_cache=prefix_cache,
                page_bytes=page_bytes,
            )
        self.calls = 0
        self.total_cost = 0.0
        self.initialized = False
        self.stats = SlotSimStats(n_slots=n_slots)
        if kv_page_size:
            self.stats.kv_bytes_per_token = page_bytes // kv_page_size
            self.stats.pool_pages = self._pages.n_pages
        self._lock = threading.Lock()
        self._next_id = 0
        #: streaming admission queue: (rid, request, out_len)
        self._queue: list[tuple[int, InferenceRequest, int]] = []
        self._slots: list[dict | None] = [None] * n_slots
        self._seen_len_buckets: set[int] = set()
        self._fault_plan = fault_plan
        self.fault_replica = fault_plan.attach() if fault_plan is not None else 0
        #: pump counter; survives reset() so that later faults on the same
        #: replica still fire at their scheduled step
        self._pumps = 0
        self._hang_until = 0

    def initialize(self) -> None:
        self.initialized = True

    def shutdown(self) -> None:
        self.initialized = False

    def _out_len(self, request: InferenceRequest) -> int:
        h = int(hashlib.sha256(request.prompt.encode()).hexdigest()[8:16], 16)
        span = max(1, self.max_out - self.min_out)
        if h % 6 == 0:  # long tail: ~1 in 6 answers runs near max_out
            n = self.max_out - h % (span // 4 + 1)
        else:
            n = self.min_out + h % (span // 3 + 1)
        return max(1, min(request.max_tokens, n))

    def _response(
        self, request: InferenceRequest, out_len: int, latency_ms: float
    ) -> InferenceResponse:
        text = simulated_answer(
            request.prompt, request.max_tokens, self.model.model_name
        )
        return InferenceResponse(
            text=text,
            input_tokens=max(1, len(request.prompt.split())),
            output_tokens=out_len,
            latency_ms=latency_ms,
        )

    def _account_admission(self, request: InferenceRequest) -> None:
        self.stats.admissions += 1
        b, n = 16, max(1, len(request.prompt.split()))
        while b < n:
            b <<= 1
        if b not in self._seen_len_buckets:
            self._seen_len_buckets.add(b)
            self.stats.prefill_recompiles += 1

    def _account_steps(self, steps: int, active_slot_steps: int) -> None:
        self.stats.steps += steps
        self.stats.active_slot_steps += active_slot_steps
        self.stats.tokens_generated += active_slot_steps

    # -- lock-step path --------------------------------------------------------

    def infer_batch(self, requests: list[InferenceRequest]) -> list[InferenceResponse]:
        out: list[InferenceResponse] = []
        with self._lock:
            self.initialize()
            for i in range(0, len(requests), self.n_slots):
                wave = requests[i : i + self.n_slots]
                lens = [self._out_len(r) for r in wave]
                wave_steps = max(lens)
                for r in wave:
                    self._account_admission(r)
                self._account_steps(wave_steps, sum(lens))
                self.stats.completions += len(wave)
                # a lock-step wave keeps no slots: every prompt prefills in full
                prefill_ms = self.prefill_ms_per_token * sum(
                    max(1, len(r.prompt.split())) for r in wave
                )
                if self.wall_clock:
                    time.sleep((wave_steps * self.step_ms + prefill_ms) / 1000.0)
                latency = wave_steps * self.step_ms + prefill_ms
                for r, n in zip(wave, lens):
                    self.calls += 1
                    out.append(self._response(r, n, latency))
        return out

    # -- streaming path --------------------------------------------------------

    def stream_submit(self, request: InferenceRequest) -> int:
        with self._lock:
            self.initialize()
            rid = self._next_id
            self._next_id += 1
            self._queue.append((rid, request, self._out_len(request)))
            return rid

    def stream_pending(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(s is not None for s in self._slots)

    def slots_busy(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots if s is not None) + len(self._queue)

    def _preempt_one_locked(self) -> bool:
        """Evict the victim slot (fewest decoded tokens, index tie-break),
        releasing its pages and requeueing its request at the queue front
        for a full recompute."""
        victims = [
            (s["out"] - s["left"], i)
            for i, s in enumerate(self._slots)
            if s is not None
        ]
        if not victims:
            return False
        decoded, i = min(victims)
        s = self._slots[i]
        if self._pages is not None:
            self._pages.release(s["rid"])
        self._queue.insert(0, (s["rid"], s["req"], s["out"]))
        self._slots[i] = None
        self.stats.preemptions += 1
        self.stats.preempted_tokens += decoded
        return True

    def _page_gate_locked(self) -> bool:
        """Admit the queue head only if the pool covers its page need while
        keeping one page per busy slot in reserve; a prompt larger than the
        whole pool is admitted so that ``acquire`` raises."""
        _, req, _ = self._queue[0]
        words = req.prompt.split() or ["<bos>"]
        need = -(-len(words) // self.kv_page_size)
        if need >= self._pages.n_pages:
            return True
        busy = sum(1 for s in self._slots if s is not None)
        return self._pages.pages_free + self._pages.pages_cached >= need + busy

    def _poll_fault_locked(self) -> float:
        """Apply the due scheduled fault, if any; returns extra latency ms
        (``slow_step``).  ``replica_crash`` raises out of the pump."""
        fault = self._fault_plan.poll(self.fault_replica, self._pumps)
        if fault is None:
            return 0.0
        if fault.kind == "replica_crash":
            raise SimulatedCrash(
                f"injected replica_crash replica={self.fault_replica} "
                f"pump={self._pumps}"
            )
        if fault.kind == "hang":
            self._hang_until = self._pumps + fault.duration
        elif fault.kind == "page_pressure":
            for _ in range(max(1, fault.duration)):
                if not self._preempt_one_locked():
                    break
        elif fault.kind == "slow_step":
            return fault.delay_s * 1000.0
        return 0.0

    def _grow_decode_pages_locked(self) -> None:
        """Charge each active slot the page holding this step's new token;
        pool exhaustion preempts the cheapest victim and retries (possibly
        the growing slot itself)."""
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            words = s["req"].prompt.split() or ["<bos>"]
            pos = len(words) + (s["out"] - s["left"])
            while self._slots[i] is not None:
                try:
                    pw = self._pages.ensure_position(s["rid"], pos)
                    if pw.cow_src is not None:
                        self.stats.cow_copies += 1
                    break
                except PagePoolExhausted:
                    if not self._preempt_one_locked():
                        break

    def stream_pump(self) -> list[tuple[int, InferenceResponse]]:
        slow_ms = 0.0
        with self._lock:
            self._pumps += 1
            if self._fault_plan is not None:
                slow_ms = self._poll_fault_locked()
            if self._pumps <= self._hang_until:
                return []  # hung: no admissions, no decode, no progress
            admitted = 0
            prefill_tokens = 0
            for i, s in enumerate(self._slots):
                if s is None and self._queue:
                    capped = (self.max_prefills_per_step
                              and admitted >= self.max_prefills_per_step)
                    if capped or (self._pages is not None
                                  and not self._page_gate_locked()):
                        # each still-queued request a free slot could have
                        # taken defers once per pump it actually waits
                        free_left = sum(
                            1 for s2 in self._slots[i:] if s2 is None
                        )
                        self.stats.prefills_deferred += min(
                            len(self._queue), free_left
                        )
                        break
                    rid, req, out_len = self._queue.pop(0)
                    self._account_admission(req)
                    admitted += 1
                    words = req.prompt.split() or ["<bos>"]
                    if self._pages is not None:
                        m = self._pages.acquire(rid, words)
                        self._pages.register(rid, words)
                        self.stats.prefix_pages_hit += m.n_shared_pages
                        self.stats.prefix_tokens_saved += m.n_shared_tokens
                        prefill_tokens += len(words) - m.n_shared_tokens
                    else:
                        prefill_tokens += len(words)
                    self._slots[i] = {
                        "rid": rid, "req": req, "left": out_len,
                        "out": out_len, "start_step": self.stats.steps,
                    }
            n_active = sum(1 for s in self._slots if s is not None)
            if not n_active:
                return []
        if self.wall_clock:
            # outside the lock: direct infer calls interleave between steps
            time.sleep(
                (self.step_ms + self.prefill_ms_per_token * prefill_tokens
                 + slow_ms) / 1000.0
            )
        done: list[tuple[int, InferenceResponse]] = []
        with self._lock:
            if self._pages is not None and self.decode_page_growth:
                self._grow_decode_pages_locked()
            self._account_steps(1, n_active)
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                s["left"] -= 1
                if s["left"] <= 0:
                    latency = (self.stats.steps - s["start_step"]) * self.step_ms
                    self.calls += 1
                    self.stats.completions += 1
                    if self._pages is not None:
                        self._pages.release(s["rid"])
                    done.append(
                        (s["rid"], self._response(s["req"], s["out"], latency))
                    )
                    self._slots[i] = None
        return done

    def stream_cancel(self, rid: int) -> bool:
        with self._lock:
            for i, (qid, _req, _out) in enumerate(self._queue):
                if qid == rid:
                    del self._queue[i]
                    return True
            for i, s in enumerate(self._slots):
                if s is not None and s["rid"] == rid:
                    if self._pages is not None:
                        self._pages.release(rid)
                    self._slots[i] = None
                    return True
        return False

    def reset(self) -> None:
        """Replica restart: drop queued and slotted requests and their
        pages; the counters and the pump clock survive (the fault schedule
        stays aligned to the engine's lifetime)."""
        with self._lock:
            if self._pages is not None:
                self._pages.release_all()
            self._queue.clear()
            self._slots = [None] * self.n_slots
            self._hang_until = 0
            self.initialized = True

    def serving_stats(self) -> dict:
        with self._lock:
            return self.stats.as_dict()


# -- local engine -----------------------------------------------------------------


class TorchLocalEngine(InferenceEngine):
    """Serve an architecture of the port through :class:`ContinuousBatcher`.

    ``infer_batch`` submits a batch and drains the batcher; the streaming
    protocol (``stream_submit`` / ``stream_pump`` / ``stream_pending`` /
    ``stream_cancel``) admits prompts into decode slots as slots free.
    Greedy decode is batch-composition independent, so both give the same
    tokens for a prompt.  At ``model.temperature`` > 0 every decode step
    samples under the batcher's key (a request's own ``temperature`` is not
    read, as in the reference), so tokens depend on the schedule.  ``params`` may carry bridged weights
    (:func:`repro_torch.models.params_from_jax`); otherwise they are made on
    the device from ``model.seed``.

    ``kv_page_size`` > 0 serves from a paged KV cache with hash-chain
    prefix sharing (``prefix_cache``); ``page_pool`` or ``page_pool_bytes``
    pins the pool smaller than its never-exhausting default, so decode
    pressure preempts; ``kv_cache_dtype="int8"`` quantizes the pages.  Paging
    is for the attention families: a Mamba2 model raises ``ValueError`` at
    ``initialize``, as the reference's batcher does.

    One lock serializes every use of the batcher, so the service's batcher
    thread and direct ``infer`` / ``infer_batch`` callers (lock-step
    workers, a judge) may share the engine.  A direct caller holds the lock
    for one batcher step at a time, not for its whole drain: concurrent
    callers' prompts decode in the same steps instead of queueing behind
    each other, and every caller takes only its own completions.

    ``fault_plan`` (a :class:`~repro_torch.ft.ServingFaultSchedule`) claims
    the engine's replica index at construction and hooks the batcher's
    steps (``ContinuousBatcher.fault_hook``); :meth:`reset`, the service's
    replica restart, rebuilds the batcher on the same weights and hooks it
    again.

    A text is the decode of the greedy tokens through the tokenizer's
    memory of the words it has encoded (an id never encoded renders as
    ``<id>``, and of two words with one id the first encoded wins).  The
    replicas of a model therefore share one ``tokenizer``, and a service
    of several replicas hands each request to :meth:`prepare` as it is
    submitted, so that the memory holds the words in submission order
    whichever replica serves a prompt: a text is then the one a single
    engine gives.
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
        fault_plan: Any = None,
        tokenizer: HashTokenizer | None = None,
    ):
        if model.provider != PROVIDER:
            raise ValueError(f"provider must be {PROVIDER!r}, got {model.provider!r}")
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
        self._fault_plan = fault_plan
        self.fault_replica = fault_plan.attach() if fault_plan is not None else 0
        self.batcher: ContinuousBatcher | None = None
        self._tokenizer: HashTokenizer | None = tokenizer
        self._next_id = 0
        self._lock = threading.RLock()
        #: stream ids of direct callers' requests still decoding, and the
        #: completions of theirs that a step has produced
        self._direct: set[int] = set()
        self._direct_done: dict[int, Completion] = {}

    def initialize(self) -> None:
        with self._lock:
            if self.batcher is not None:
                return
            cfg = get_config(self.model_cfg.model_name)
            if self.model_cfg.reduced:
                cfg = cfg.reduced()
            if cfg.family in ("encdec", "vlm"):
                # an InferenceRequest has no channel for encoder frames or
                # patch embeddings (nor has the reference's, whose prefill
                # then fails on the missing "frames" or "patches"): serve
                # these families through ContinuousBatcher
                what, key = (("encoder frames an enc-dec model", "frames")
                             if cfg.family == "encdec"
                             else ("patch embeddings a VLM", "patches"))
                raise ValueError(
                    f"{cfg.name}: the local engine cannot carry the {what} "
                    f"needs; submit Request(extras={{'{key}': ...}}) to a "
                    f"ContinuousBatcher instead")
            if self._tokenizer is None:
                self._tokenizer = HashTokenizer(cfg.vocab_size)
            elif self._tokenizer.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"tokenizer vocab {self._tokenizer.vocab_size}, "
                    f"model vocab {cfg.vocab_size}"
                )
            params = self._params
            if params is None:
                params = init_params(cfg, self.model_cfg.seed, device=self.device)
            elif params["embed"].device != self.device:
                raise ValueError(
                    f"params are on {params['embed'].device}, the engine on {self.device}"
                )
            self.batcher = self._new_batcher(cfg, params)

    def _new_batcher(self, cfg: Any, params: dict) -> ContinuousBatcher:
        b = ContinuousBatcher(
            build_model(cfg), cfg, params,
            n_slots=self.n_slots, max_len=self.max_len,
            eos_id=self._tokenizer.eos_id,
            max_prefills_per_step=self.max_prefills_per_step,
            temperature=self.model_cfg.temperature,
            **self.paging,
        )
        if self._fault_plan is not None:
            b.fault_hook = self._fault_plan.as_hook(self.fault_replica)
        return b

    def shutdown(self) -> None:
        with self._lock:
            self.batcher = None

    def reset(self) -> None:
        """Replica restart: drop every queued and slotted request and
        rebuild the batcher (fresh slots, a fresh cache or page pool) on
        the same weights and tokenizer.  The old cache is freed before the
        new one is allocated.  The counters and the step clock carry over,
        so later faults of the schedule fire at their steps of the
        engine's lifetime."""
        with self._lock:
            old = self.batcher
            if old is None:
                self.initialize()
                return
            cfg, params = old.cfg, old.params
            stats, steps_run = old.stats, old.steps_run
            self.batcher = None
            old.cache = None
            del old
            b = self._new_batcher(cfg, params)
            b.stats, b.steps_run = stats, steps_run
            self.batcher = b

    @property
    def tokenizer(self) -> HashTokenizer:
        self.initialize()
        return self._tokenizer

    def prepare(self, request: InferenceRequest) -> None:
        """Encode the request's prompt now (the submitter's thread, in
        submission order); ``stream_submit`` encodes it again later, so a
        service calls this only when it has several replicas.  The
        engine lock is not taken: the batcher thread holds it for a whole
        step, and a submitter waiting on it would feed the slots one prompt
        a step (the tokenizer's memory is a dict, whose updates are atomic)."""
        tok = self._tokenizer or self.tokenizer
        tok.encode(request.prompt)

    def _submit(self, request: InferenceRequest) -> int:
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

    def _take_direct(self) -> None:
        """Move the finished requests of direct callers out of the batcher's
        completions (caller holds the lock), so that ``stream_pump`` never
        hands them to the service."""
        b = self.batcher
        if not self._direct or not b.completions:
            return
        keep = []
        for c in b.completions:
            if c.request_id in self._direct:
                self._direct.discard(c.request_id)
                self._direct_done[c.request_id] = c
            else:
                keep.append(c)
        b.completions = keep

    def infer_batch(
        self, requests: list[InferenceRequest]
    ) -> list[InferenceResponse]:
        t0 = time.monotonic()
        with self._lock:
            ids = {self._submit(r): i for i, r in enumerate(requests)}
            self._direct.update(ids)
        out: list[InferenceResponse | None] = [None] * len(requests)
        waiting = set(ids)
        while waiting:
            with self._lock:
                b = self.batcher
                self._take_direct()
                for rid in [r for r in waiting if r in self._direct_done]:
                    out[ids[rid]] = self._response(self._direct_done.pop(rid))
                    waiting.discard(rid)
                if waiting and not (b.queue or b.slots_busy):
                    self._direct.difference_update(waiting)
                    break  # nothing left to step: the requests are lost
                if waiting:
                    b.step()
            # let a waiting caller in between steps: a thread that takes the
            # lock straight back would keep others' prompts out of the batch
            time.sleep(0)
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
            self._take_direct()
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


def create_engine(model: EngineModelConfig, **kw: Any) -> InferenceEngine:
    """The engine for ``model.provider``: the port's local engine for
    ``"torch_local"``, the slot simulator for ``"slotsim"``, the simulated
    API engine for any other provider, as in the reference."""
    if model.provider == PROVIDER:
        return TorchLocalEngine(model, **kw)
    if model.provider == "slotsim":
        return SimulatedSlotEngine(model, **kw)
    return SimulatedAPIEngine(model, **kw)


class EngineRegistry:
    """One initialized engine per (:class:`EngineModelConfig`, replica
    index, engine arguments), the reference's ``EngineRegistry``: a session
    amortizes an engine's set-up across every task it runs.  Lookups from
    concurrent jobs initialize an engine once."""

    def __init__(self) -> None:
        self._engines: dict[tuple[EngineModelConfig, int, str], InferenceEngine] = {}
        self.initializations = 0
        self._lock = threading.Lock()

    def get(
        self, model: EngineModelConfig, *, replica: int = 0, **kw: Any
    ) -> InferenceEngine:
        """``replica`` tells data-parallel instances apart: replica i of a
        model is its own engine (own batcher, own decode slots), and replica
        0 is the single-replica engine."""
        key = (model, replica, _kwargs_key(kw))
        with self._lock:
            engine = self._engines.get(key)
            if engine is None:
                engine = create_engine(model, **kw)
                engine.initialize()
                self.initializations += 1
                self._engines[key] = engine
        return engine

    def shutdown(self) -> None:
        for engine in self._engines.values():
            engine.shutdown()
        self._engines.clear()

    def __len__(self) -> int:
        return len(self._engines)

    def __contains__(self, model: EngineModelConfig) -> bool:
        return any(k[0] == model for k in self._engines)

    def engines(self) -> list[InferenceEngine]:
        return list(self._engines.values())


#: provider error codes worth retrying (429 and the 5xx family)
RECOVERABLE_ERROR_CODES = ("429", "500", "502", "503")


def is_recoverable(error: str | None) -> bool:
    return error is not None and any(
        code in error for code in RECOVERABLE_ERROR_CODES
    )


def retry_with_backoff(
    fn: Callable[[], InferenceResponse],
    *,
    max_retries: int = 3,
    base_delay: float = 1.0,
    sleep: Callable[[float], None] = time.sleep,
) -> InferenceResponse | None:
    """Call ``fn`` until it answers without a recoverable error, at most
    ``max_retries`` times more, sleeping ``base_delay * 2**attempt`` between
    attempts.  A :class:`RecoverableEngineError` is retried the same way and
    re-raised once the retries are spent; any other exception propagates at
    once.  Returns the last response (its error kept) when every attempt
    failed recoverably."""
    last: InferenceResponse | None = None
    for attempt in range(max_retries + 1):
        try:
            resp = fn()
        except RecoverableEngineError:
            if attempt >= max_retries:
                raise
            sleep(base_delay * math.pow(2.0, attempt))
            continue
        if resp.error is None or not is_recoverable(resp.error):
            return resp
        last = resp
        if attempt < max_retries:
            sleep(base_delay * math.pow(2.0, attempt))
    return last
