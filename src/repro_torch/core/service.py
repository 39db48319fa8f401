"""The inference service: one asynchronous submit/gather front per engine
(the single-replica ``InferenceService`` of ``repro/core/service.py``).

Stages **submit** :class:`~repro_torch.core.engines.InferenceRequest`
objects and get :class:`ServiceTicket` futures back.  A slot engine
(``supports_streaming``) is driven by one batcher thread through its
streaming protocol (``stream_submit`` / ``stream_pump``), admitting queued
prompts into decode slots as slots free, so batches form across shards,
chunks and the tasks of a suite.  Any other engine (the simulated API
engine) is served by a pool of dispatcher threads, one ``infer`` a
request, sized by the stages attached (``attach``).

* **Single-flight coalescing**: identical in-flight cache keys share one
  engine call.  The first submitter is the *primary* (its shard is charged
  the call and writes the cache); later submitters wait on the same flight
  and count as ``coalesced``.
* **Central admission**: a submission's rate limiter is acquired by the
  thread that calls the engine, right before the call.
* **Retries**: a recoverable error (a 429/5xx response or
  :class:`~repro_torch.core.engines.RecoverableEngineError`) is retried up
  to the submission's ``max_retries``.  A dispatcher thread backs off
  through ``retry_with_backoff`` with the injected sleep; the batcher loop
  does not sleep for a retry, it schedules it (``retry_at``) and goes on
  stepping, due at once when the injected sleep is not ``time.sleep``.
* **Errors**: ``ValueError`` / ``TypeError`` from ``stream_submit`` fail
  that one ticket; any other exception in the batcher fails every ticket
  it holds, has scheduled or has queued, and the service refuses further
  submissions.
* **Lifecycle**: the thread starts on first use; :meth:`close` lets queued
  work finish, then stops and joins the thread.

Responses are a pure function of the request (the simulated engine by
construction, greedy decode because it is batch-composition independent),
so coalescing and batching change how many engine calls paid for a
response, never its text.  Replicas, routing, hedging, deadlines, restarts
and health probes of the reference are not part of the port yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Callable

from repro_torch.core.engines import (
    InferenceRequest,
    InferenceResponse,
    RecoverableEngineError,
    is_recoverable,
    retry_with_backoff,
)
from repro_torch.core.ratelimit import AdaptiveLimiter

_SENTINEL = object()


class _Flight:
    """One engine call and its waiters (the single-flight unit)."""

    __slots__ = ("key", "event", "response", "exc", "attempts", "resolved")

    def __init__(self, key: str):
        self.key = key
        self.event = threading.Event()
        self.response: InferenceResponse | None = None
        self.exc: BaseException | None = None
        self.attempts = 0
        self.resolved = False


class ServiceTicket:
    """Future for one submitted request.  ``primary`` is True for the
    submission that owns the engine call; a coalesced follower shares the
    response but owns nothing."""

    __slots__ = ("_flight", "primary")

    def __init__(self, flight: _Flight, primary: bool):
        self._flight = flight
        self.primary = primary

    def done(self) -> bool:
        return self._flight.event.is_set()

    @property
    def attempts(self) -> int:
        """Engine calls the flight took (retries included)."""
        return self._flight.attempts

    def result(self, timeout: float | None = None) -> InferenceResponse:
        if not self._flight.event.wait(timeout):
            raise TimeoutError(f"inference ticket not resolved within {timeout}s")
        if self._flight.exc is not None:
            raise self._flight.exc
        assert self._flight.response is not None
        return self._flight.response


@dataclasses.dataclass
class _Submission:
    flight: _Flight
    request: InferenceRequest
    limiter: Any
    est_tokens: float
    max_retries: int
    retry_delay: float


@dataclasses.dataclass
class ServiceStats:
    submitted: int = 0
    coalesced: int = 0
    dispatched: int = 0   # engine-call attempts actually issued
    completed: int = 0
    retries: int = 0
    errors: int = 0

    @property
    def dedup_rate(self) -> float:
        return self.coalesced / self.submitted if self.submitted else 0.0

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "dispatched": self.dispatched,
            "coalesced": self.coalesced,
            "completed": self.completed,
            "retries": self.retries,
            "errors": self.errors,
            "dedup_rate": round(self.dedup_rate, 4),
        }


class InferenceService:
    """Session-owned dispatch front for one engine.

    ``submit`` never blocks on inference, only on a full queue
    (``queue_depth`` outstanding submissions); ``ServiceTicket.result``
    gathers.  Threads start on first use and are joined by :meth:`close`."""

    #: ceiling on dispatcher threads (the rate limiter, not the thread
    #: count, is the admission control)
    HARD_MAX_DISPATCHERS = 128

    def __init__(
        self,
        engine: Any,
        *,
        queue_depth: int = 256,
        coalesce: bool = True,
        max_batch_wait_ms: float = 2.0,
        n_dispatchers: int = 4,
        sleep: Callable[[float], None] = time.sleep,
        name: str = "",
    ):
        self.engine = engine
        self.coalesce = coalesce
        self.max_batch_wait_ms = max_batch_wait_ms
        self.name = name
        self.stats = ServiceStats()
        self._streaming = bool(getattr(engine, "supports_streaming", False))
        self._sleep = sleep
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
        self._wake = threading.Event()
        self._threads: list[threading.Thread] = []
        self._base_dispatchers = max(1, n_dispatchers)
        self._attached = 0
        self._inflight: dict[str, _Flight] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._broken: BaseException | None = None
        self._uniq = itertools.count()

    # -- capacity ---------------------------------------------------------------

    def attach(self, n_workers: int = 1) -> None:
        """A stage is about to submit with ``n_workers`` of parallelism.  A
        slot engine needs one batcher thread whatever the stages (decode
        slots are its parallelism); an API engine gets at least that many
        dispatcher threads."""
        with self._lock:
            self._check_open()
            self._attached += max(1, n_workers)
            self._ensure_threads()

    def detach(self, n_workers: int = 1) -> None:
        """The stage is done submitting; threads never shrink, idle ones
        wait on the queue."""
        with self._lock:
            self._attached = max(0, self._attached - max(1, n_workers))

    def _ensure_threads(self) -> None:  # caller holds self._lock
        if self._streaming:
            target = 1
        else:
            target = min(self.HARD_MAX_DISPATCHERS,
                         max(self._base_dispatchers, self._attached))
        while len(self._threads) < target:
            idx = len(self._threads)
            t = threading.Thread(
                target=self._batcher_loop if self._streaming else self._dispatch_loop,
                args=() if self._streaming else (idx,),
                name=f"infer-service-{self.name or 'engine'}-{idx}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    # -- submission --------------------------------------------------------------

    def submit(
        self,
        request: InferenceRequest,
        *,
        key: str | None = None,
        coalesce: bool | None = None,
        limiter: Any = None,
        est_tokens: float = 0.0,
        max_retries: int = 0,
        retry_delay: float = 1.0,
    ) -> ServiceTicket:
        """Enqueue a request; returns its ticket at once.  ``key`` is the
        request's content address (the response-cache key): identical
        in-flight keys coalesce into one engine call unless coalescing is
        off.  ``limiter`` (an :class:`AdaptiveLimiter` or a list of
        :class:`~repro_torch.core.ratelimit.TokenBucket`) is acquired for
        ``est_tokens`` right before each engine call; a recoverable error is
        retried ``max_retries`` times, backing off from ``retry_delay``."""
        do_coalesce = self.coalesce if coalesce is None else coalesce
        if key is None:
            do_coalesce = False
            key = f"~uniq-{next(self._uniq)}"
        with self._lock:
            self._check_open()
            self.stats.submitted += 1
            if do_coalesce:
                flight = self._inflight.get(key)
                if flight is not None:
                    self.stats.coalesced += 1
                    return ServiceTicket(flight, primary=False)
            flight = _Flight(key)
            if do_coalesce:
                self._inflight[key] = flight
            self._ensure_threads()
        # outside the lock: a full queue blocks the submitter, never the
        # threads that serve it
        self._queue.put(_Submission(flight, request, limiter, est_tokens,
                                    max_retries, retry_delay))
        self._wake.set()
        with self._lock:
            dead = self._broken
        if dead is not None:
            # the batcher died between the open check and the put: nobody
            # will read this submission, so fail it rather than strand it
            self._drain(dead)
        return ServiceTicket(flight, primary=True)

    def note_coalesced(self, n: int = 1) -> None:
        """Count submissions deduplicated before they reached the service
        (a stage reusing its own ticket for a repeated key)."""
        with self._lock:
            self.stats.submitted += n
            self.stats.coalesced += n

    # -- dispatch ---------------------------------------------------------------

    @staticmethod
    def _admit(sub: _Submission, widx: int) -> None:
        """Acquire the submission's rate limit for worker ``widx``."""
        lim = sub.limiter
        if lim is None:
            return
        if isinstance(lim, AdaptiveLimiter):
            lim.acquire(widx % lim.n, sub.est_tokens)
        elif isinstance(lim, (list, tuple)):
            lim[widx % len(lim)].acquire(sub.est_tokens)
        else:
            lim.acquire(sub.est_tokens)

    def _count_dispatch(self, flight: _Flight) -> None:
        flight.attempts += 1
        with self._lock:
            self.stats.dispatched += 1

    def _resolve(
        self,
        flight: _Flight,
        response: InferenceResponse | None = None,
        exc: BaseException | None = None,
    ) -> None:
        with self._lock:
            if flight.resolved:
                return
            flight.resolved = True
            self._inflight.pop(flight.key, None)
            self.stats.completed += 1
            self.stats.retries += max(0, flight.attempts - 1)
            if exc is not None or (response is not None and response.error is not None):
                self.stats.errors += 1
        flight.response = response
        flight.exc = exc
        flight.event.set()

    def _dispatch_loop(self, widx: int) -> None:
        """A dispatcher thread of an API engine: one ``infer`` a request,
        retried through :func:`retry_with_backoff` with the injected sleep;
        exits on the one stop sentinel it takes."""
        while True:
            sub = self._queue.get()
            if sub is _SENTINEL:
                return
            try:
                self._admit(sub, widx)

                def call(sub=sub) -> InferenceResponse:
                    self._count_dispatch(sub.flight)
                    return self.engine.infer(sub.request)

                resp = retry_with_backoff(
                    call, max_retries=sub.max_retries,
                    base_delay=sub.retry_delay, sleep=self._sleep,
                )
                self._resolve(sub.flight, resp)
            except BaseException as e:  # noqa: BLE001 — every waiter must wake
                self._resolve(sub.flight, exc=e)

    def _batcher_loop(self) -> None:
        """Run the batcher; if it raises, fail every submission it held,
        scheduled or that is still queued, and refuse further submissions."""
        held: dict[int, _Submission] = {}
        retry_at: list[tuple[float, _Submission]] = []
        try:
            self._batcher_run(held, retry_at)
        except BaseException as e:  # noqa: BLE001 — every waiter must wake
            with self._lock:
                self._broken = e
            for sub in [*held.values(), *(s for _, s in retry_at)]:
                self._resolve(sub.flight, exc=e)
            self._drain(e)

    def _batcher_run(
        self,
        pending: dict[int, _Submission],
        retry_at: list[tuple[float, _Submission]],
    ) -> None:
        """Admit queued prompts into the engine, step it, deliver what
        finished; a cold batcher waits ``max_batch_wait_ms`` for
        co-submitted prompts before it starts decoding.  ``pending`` maps
        the engine's stream id to the submission it serves; ``retry_at``
        holds (due time, submission) of recoverable failures, re-admitted
        once due.  The rate-limiter index goes round the workers, one
        admission each, so list-mode buckets grant their whole budget."""
        engine = self.engine
        wait_s = max(0.0, self.max_batch_wait_ms) / 1000.0
        real_sleep = self._sleep is time.sleep
        stop = False
        admit_rr = 0

        def backoff(sub: _Submission) -> float:
            delay = sub.retry_delay * 2.0 ** (sub.flight.attempts - 1)
            return time.monotonic() + (delay if real_sleep else 0.0)

        def dispatch(sub: _Submission) -> None:
            nonlocal admit_rr
            try:
                self._admit(sub, admit_rr)
                admit_rr += 1
                self._count_dispatch(sub.flight)
                pending[engine.stream_submit(sub.request)] = sub
            except RecoverableEngineError as e:
                if sub.flight.attempts <= sub.max_retries:
                    retry_at.append((backoff(sub), sub))
                else:
                    self._resolve(sub.flight, exc=e)
            except (ValueError, TypeError) as e:
                # a bad request fails its own ticket; the engine lives on
                self._resolve(sub.flight, exc=e)
            except BaseException as e:
                self._resolve(sub.flight, exc=e)
                raise

        while True:
            was_idle = not pending
            admitted = 0
            # due retries leave the list one at a time: if a dispatch raises,
            # the rest are still there for the failure path to resolve
            now = time.monotonic()
            i = 0
            while i < len(retry_at):
                if retry_at[i][0] <= now:
                    dispatch(retry_at.pop(i)[1])
                    admitted += 1
                else:
                    i += 1
            # cleared before the queue is read: a put after this point
            # sets it again, so the wait below cannot miss a submission
            self._wake.clear()
            while not stop:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _SENTINEL:
                    stop = True
                    break
                dispatch(item)
                admitted += 1
            if not pending:
                if stop and not retry_at:
                    return
                self._wake.wait(timeout=0.005 if retry_at else 0.05)
                continue
            if was_idle and admitted and wait_s and not stop:
                time.sleep(wait_s)
                continue
            done = engine.stream_pump()
            if not done and not engine.stream_pending():
                raise RuntimeError(f"engine lost {len(pending)} requests")
            for rid, resp in done:
                sub = pending.pop(rid, None)
                if sub is None:
                    continue
                if is_recoverable(resp.error) and sub.flight.attempts <= sub.max_retries:
                    retry_at.append((backoff(sub), sub))
                    continue
                self._resolve(sub.flight, resp)

    # -- lifecycle ---------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("InferenceService is closed")
        if self._broken is not None:
            raise RuntimeError(f"InferenceService dispatch failed: {self._broken!r}")

    def _drain(self, exc: BaseException) -> None:
        """Fail every submission still queued; stop sentinels are put back
        for the threads that have not taken theirs."""
        sentinels = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                sentinels += 1
            else:
                self._resolve(item.flight, exc=exc)
        for _ in range(sentinels):
            self._queue.put(_SENTINEL)

    def close(self, timeout: float = 30.0) -> None:
        """Drain and stop: queued work is served (one stop sentinel a thread
        sits behind it), in-flight decode and scheduled retries finish, then
        the threads exit and are joined."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = list(self._threads)
        for _ in threads:
            self._queue.put(_SENTINEL)
        self._wake.set()
        for t in threads:
            t.join(timeout=timeout)
        # a submit racing close may have queued behind the sentinels
        self._drain(RuntimeError("InferenceService closed"))

    def __enter__(self) -> "InferenceService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- introspection -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The service's counters, and the engine's batcher counters under
        ``"batcher"``."""
        with self._lock:
            d = {
                "engine": self.name,
                "mode": "batcher" if self._streaming else "threads",
                "replicas": 1,
                "dispatchers": len(self._threads),
                "inflight": len(self._inflight),
                **self.stats.as_dict(),
            }
        batcher = self.engine.serving_stats()
        if batcher:
            d["batcher"] = batcher
        return d
