"""The inference service: one asynchronous submit/gather front per engine
(the single-replica ``InferenceService`` of ``repro/core/service.py``).

Stages **submit** :class:`~repro_torch.core.engines.InferenceRequest`
objects and get :class:`ServiceTicket` futures back; one batcher thread per
engine drives the slot engine's streaming protocol (``stream_submit`` /
``stream_pump``), admitting queued prompts into decode slots as slots free,
so batches form across shards, chunks and the tasks of a suite.

* **Single-flight coalescing**: identical in-flight cache keys share one
  engine call.  The first submitter is the *primary* (its shard is charged
  the call and writes the cache); later submitters wait on the same flight
  and count as ``coalesced``.
* **Errors**: ``ValueError`` / ``TypeError`` from ``stream_submit`` fail
  that one ticket; any other exception in the batcher fails every ticket
  it holds or has queued, and the service refuses further submissions.
* **Lifecycle**: the thread starts on first use; :meth:`close` lets queued
  work finish, then stops and joins the thread.

Responses are a pure function of the request (greedy decode is
batch-composition independent), so coalescing and batching change how many
engine calls paid for a response, never its text.  Replicas, routing,
hedging, deadlines, restarts and health probes of the reference are not
part of the port yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from typing import Any

from repro_torch.core.engines import InferenceRequest, InferenceResponse

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
        """Engine calls the flight took."""
        return self._flight.attempts

    def result(self, timeout: float | None = None) -> InferenceResponse:
        if not self._flight.event.wait(timeout):
            raise TimeoutError(f"inference ticket not resolved within {timeout}s")
        if self._flight.exc is not None:
            raise self._flight.exc
        assert self._flight.response is not None
        return self._flight.response


@dataclasses.dataclass
class ServiceStats:
    submitted: int = 0
    coalesced: int = 0
    dispatched: int = 0   # engine calls actually issued
    completed: int = 0
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
            "errors": self.errors,
            "dedup_rate": round(self.dedup_rate, 4),
        }


class InferenceService:
    """Session-owned dispatch front for one slot-streaming engine.

    ``submit`` never blocks on inference, only on a full queue
    (``queue_depth`` outstanding submissions); ``ServiceTicket.result``
    gathers."""

    def __init__(
        self,
        engine: Any,
        *,
        queue_depth: int = 256,
        coalesce: bool = True,
        max_batch_wait_ms: float = 2.0,
        name: str = "",
    ):
        if not getattr(engine, "supports_streaming", False):
            raise ValueError("InferenceService needs a slot-streaming engine")
        self.engine = engine
        self.coalesce = coalesce
        self.max_batch_wait_ms = max_batch_wait_ms
        self.name = name
        self.stats = ServiceStats()
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_depth))
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._inflight: dict[str, _Flight] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._broken: BaseException | None = None
        self._uniq = itertools.count()

    # -- capacity ---------------------------------------------------------------

    def attach(self, n_workers: int = 1) -> None:
        """A stage is about to submit: start the batcher thread.  Decode
        slots are the parallelism, so one thread serves any number of
        stages and ``n_workers`` sizes nothing."""
        with self._lock:
            self._check_open()
            self._ensure_thread()

    def detach(self, n_workers: int = 1) -> None:
        """The stage is done submitting; the thread stays for the next."""

    def _ensure_thread(self) -> None:  # caller holds self._lock
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._batcher_loop,
                name=f"infer-service-{self.name or 'engine'}",
                daemon=True,
            )
            self._thread.start()

    # -- submission --------------------------------------------------------------

    def submit(
        self,
        request: InferenceRequest,
        *,
        key: str | None = None,
        coalesce: bool | None = None,
    ) -> ServiceTicket:
        """Enqueue a request; returns its ticket at once.  ``key`` is the
        request's content address (the response-cache key): identical
        in-flight keys coalesce into one engine call unless coalescing is
        off."""
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
            self._ensure_thread()
        # outside the lock: a full queue blocks the submitter, never the
        # batcher
        self._queue.put((flight, request))
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
            if exc is not None or (response is not None and response.error is not None):
                self.stats.errors += 1
        flight.response = response
        flight.exc = exc
        flight.event.set()

    def _batcher_loop(self) -> None:
        """Run the batcher; if it raises, fail every submission it held or
        that is still queued, and refuse further submissions."""
        held: dict[int, _Flight] = {}
        try:
            self._batcher_run(held)
        except BaseException as e:  # noqa: BLE001 — every waiter must wake
            with self._lock:
                self._broken = e
            for flight in held.values():
                self._resolve(flight, exc=e)
            self._drain(e)

    def _batcher_run(self, pending: dict[int, _Flight]) -> None:
        """Admit queued prompts into the engine, step it, deliver what
        finished; a cold batcher waits ``max_batch_wait_ms`` for
        co-submitted prompts before it starts decoding.  ``pending`` maps
        the engine's stream id to the flight it serves."""
        engine = self.engine
        wait_s = max(0.0, self.max_batch_wait_ms) / 1000.0
        stop = False
        while True:
            was_idle = not pending
            admitted = 0
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
                flight, request = item
                try:
                    flight.attempts += 1
                    with self._lock:
                        self.stats.dispatched += 1
                    pending[engine.stream_submit(request)] = flight
                except (ValueError, TypeError) as e:
                    # a bad request fails its own ticket; the engine lives on
                    self._resolve(flight, exc=e)
                except BaseException as e:
                    self._resolve(flight, exc=e)
                    raise
                admitted += 1
            if not pending:
                if stop:
                    return
                self._wake.wait(timeout=0.05)
                continue
            if was_idle and admitted and wait_s and not stop:
                time.sleep(wait_s)
                continue
            done = engine.stream_pump()
            if not done and not engine.stream_pending():
                raise RuntimeError(f"engine lost {len(pending)} requests")
            for rid, resp in done:
                flight = pending.pop(rid, None)
                if flight is not None:
                    self._resolve(flight, resp)

    # -- lifecycle ---------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("InferenceService is closed")
        if self._broken is not None:
            raise RuntimeError(f"InferenceService dispatch failed: {self._broken!r}")

    def _drain(self, exc: BaseException) -> None:
        """Fail every submission still queued."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not _SENTINEL:
                self._resolve(item[0], exc=exc)

    def close(self, timeout: float = 30.0) -> None:
        """Drain and stop: queued work is served (the stop sentinel sits
        behind it), in-flight decode finishes, then the batcher thread
        exits and is joined."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
        if thread is not None:
            self._queue.put(_SENTINEL)
            self._wake.set()
            thread.join(timeout=timeout)
        # a submit racing close may have queued behind the sentinel
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
                "mode": "batcher",
                "replicas": 1,
                "dispatchers": int(self._thread is not None),
                "inflight": len(self._inflight),
                **self.stats.as_dict(),
            }
        batcher = self.engine.serving_stats()
        if batcher:
            d["batcher"] = batcher
        return d
