"""The inference service (the port of ``repro/core/service.py``): one
asynchronous submit/gather front per engine, fanned out across N
data-parallel engine replicas.

Stages **submit** :class:`~repro_torch.core.engines.InferenceRequest`
objects and get :class:`ServiceTicket` futures back; dispatch happens
centrally:

* **Single-flight coalescing**: identical in-flight cache keys share one
  engine call.  The first submitter is the *primary* (its shard is charged
  the call and writes the cache); later submitters wait on the same flight
  and count as ``coalesced``.  The flight table is global across replicas:
  a duplicate coalesces onto the original flight whichever replica serves
  it.
* **Central admission**: a submission's rate limiter is acquired by the
  thread that calls the engine, right before the call.
* **Continuous batching**: a slot engine (``supports_streaming``: the local
  engine, the slot simulator) is driven by one batcher thread per replica
  through its streaming protocol (``stream_submit`` / ``stream_pump``),
  admitting queued prompts into decode slots as slots free, so batches
  form across shards, chunks and the tasks of a suite.  Any other engine
  (the simulated API engine) gets a pool of dispatcher threads per
  replica, one ``infer`` a request, sized by the stages attached.
* **Replica routing**: with several engines one submit queue fans out
  through a :class:`ReplicaRouter` (``least_loaded``, ``prefix_affinity``
  or ``round_robin``).  With several replicas, an engine with a
  ``prepare`` hook (the local engine, whose replicas share a tokenizer) is
  handed each request in the submitter's thread, so it sees requests in
  submission order whatever replica serves them.  On one card in one
  process, replicas buy fault tolerance and parity, not throughput: their
  batcher threads share one interpreter lock, and two full-width qwen3-4b
  replicas took 3.2-4.0x one engine's wall on the same 16 rows on an H100
  (``chip_smoke.py`` phase 9 (a)).
* **Fault tolerance** (DESIGN.md §9): a recoverable error is retried up to
  the submission's ``max_retries`` (a dispatcher thread backs off through
  ``retry_with_backoff``; the batcher loop schedules the retry in
  ``retry_at`` and goes on stepping).  ``ValueError`` / ``TypeError`` from
  ``stream_submit`` fail that one ticket.  Any other exception crashes the
  replica: with ``max_replica_restarts`` left, the engine is ``reset()``
  after a backoff through the injected sleep and its in-flight work is
  served again; otherwise that work fails and the replica is retired (the
  service refuses submissions once every replica is).  A health probe
  (``health_probe_steps``) declares a replica that makes no progress with
  work in flight hung (:class:`ReplicaHungError`) and takes the same path.
  A submission past its deadline (``deadline_s``) is hedged to another
  alive replica; the first completion wins and the loser's leg is
  cancelled by its own loop.

Responses are a pure function of the request (the simulated engines by
construction, greedy decode because it is batch-composition independent),
so coalescing, batching, routing, restarts and hedges change how many
engine calls paid for a response and which replica served it, never its
text.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import queue
import threading
import time
from typing import Any, Callable, Sequence

from repro_torch.core.engines import (
    InferenceEngine,
    InferenceRequest,
    InferenceResponse,
    RecoverableEngineError,
    is_recoverable,
    retry_with_backoff,
)
from repro_torch.core.ratelimit import AdaptiveLimiter

_SENTINEL = object()

#: how long a batcher loop waits for new work after a pump that made no
#: progress (a hung engine), rather than pumping again at once
STALL_WAIT_S = 0.005


class ReplicaHungError(RuntimeError):
    """Raised by the health probe inside a batcher loop: the replica has
    in-flight work but its engine made no progress (no decode steps, no
    completions) for ``health_probe_steps`` consecutive pumps.  Takes the
    same drain-and-restart path as a crash."""


class _Flight:
    """One engine call and its waiters (the single-flight unit)."""

    __slots__ = ("key", "event", "response", "exc", "attempts", "resolved")

    def __init__(self, key: str):
        self.key = key
        self.event = threading.Event()
        self.response: InferenceResponse | None = None
        self.exc: BaseException | None = None
        self.attempts = 0
        #: set under the service lock by the first resolution: a hedged
        #: flight can race two completions, and the loser only moves
        #: replica bookkeeping
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
        """Engine calls the flight took (retries and hedges included)."""
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
    replica: "_Replica | None" = None
    #: monotonic deadline (None = none), set at submit so queue wait counts
    deadline_at: float | None = None
    #: this submission is the hedge leg of an expired flight
    is_hedge: bool = False
    #: a hedge has been issued for this submission's flight
    hedged: bool = False
    #: the deadline expiry is counted (once a primary submission)
    expired: bool = False


class _BatcherState:
    """In-flight bookkeeping of one incarnation of a batcher loop.  On a
    crash the supervisor collects :meth:`survivors` and hands them to the
    next incarnation (restart) or fails them (retirement)."""

    __slots__ = ("pending", "retry_at", "carry", "stall", "last_steps")

    def __init__(self) -> None:
        #: engine stream id -> submission in decode
        self.pending: dict[int, _Submission] = {}
        #: (monotonic due time, submission) of scheduled retries
        self.retry_at: list[tuple[float, _Submission]] = []
        #: submissions the loop owns outside both (crashed mid-dispatch, or
        #: carried in from a prior incarnation)
        self.carry: list[_Submission] = []
        #: consecutive pumps without engine progress (health probe)
        self.stall = 0
        self.last_steps = -1

    def survivors(self) -> list[_Submission]:
        subs = (
            list(self.pending.values())
            + [s for _, s in self.retry_at]
            + list(self.carry)
        )
        self.pending.clear()
        self.retry_at.clear()
        self.carry.clear()
        return subs


@dataclasses.dataclass
class ServiceStats:
    submitted: int = 0
    coalesced: int = 0
    dispatched: int = 0   # engine-call attempts actually issued
    completed: int = 0
    retries: int = 0
    errors: int = 0
    #: broken replicas brought back by the restart path
    restarts: int = 0
    #: primary submissions that outlived their deadline
    deadline_expiries: int = 0
    #: hedge legs issued to another alive replica
    hedges_issued: int = 0
    #: flights won by the hedge leg
    hedges_won: int = 0

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
            "restarts": self.restarts,
            "deadline_expiries": self.deadline_expiries,
            "hedges_issued": self.hedges_issued,
            "hedges_won": self.hedges_won,
        }


# -- replicas -------------------------------------------------------------------


class _Replica:
    """One engine replica behind the shared submit front: its own queue,
    its own threads (one batcher loop for a slot engine, a pool for an API
    engine) and its own counters, guarded by the service's lock."""

    __slots__ = (
        "index", "engine", "queue", "wake", "threads",
        "routed", "outstanding", "dispatched", "completed", "errors",
        "broken", "retired", "first_failure", "last_progress", "restarts",
        "cancelled",
    )

    def __init__(self, index: int, engine: InferenceEngine, depth: int):
        self.index = index
        self.engine = engine
        self.queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self.wake = threading.Event()
        self.threads: list[threading.Thread] = []
        self.routed = 0        # submissions ever routed here
        self.outstanding = 0   # routed but not yet resolved
        self.dispatched = 0
        self.completed = 0
        self.errors = 0
        #: set from a failure until the restart brings the replica back
        self.broken: BaseException | None = None
        #: the restart budget is spent: the replica's loop has exited
        self.retired = False
        #: the cause of the replica's first failure, kept across restarts
        #: for the fleet-dead report
        self.first_failure: BaseException | None = None
        #: engine step count at the last observed progress (-1 = never)
        self.last_progress = -1
        self.restarts = 0
        #: hedge-loser legs cancelled on this replica
        self.cancelled = 0

    def stats_dict(self) -> dict:
        d = {
            "index": self.index,
            "routed": self.routed,
            "outstanding": self.outstanding,
            "dispatched": self.dispatched,
            "completed": self.completed,
            "errors": self.errors,
            "broken": self.broken is not None,
            "restarts": self.restarts,
            "cancelled": self.cancelled,
            "last_progress": self.last_progress,
        }
        batcher = self.engine.serving_stats()
        if batcher:
            d["batcher"] = batcher
        return d


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """The router's load snapshot of one alive replica."""

    index: int
    queued: int        # submissions waiting in the replica's service queue
    outstanding: int   # routed but unresolved (includes in-engine backlog)
    busy_slots: int = 0

    @property
    def load(self) -> int:
        return self.queued + self.outstanding


class ReplicaRouter:
    """Replica placement among the *alive* replicas; ties break on the
    lowest index, so placement is a function of the load snapshot.

    * ``least_loaded``: fewest queued plus outstanding requests.
    * ``prefix_affinity``: a stable hash of the prompt's first
      ``prefix_len`` characters, so prompts sharing a few-shot header land
      on the same batcher whatever the load.
    * ``round_robin``: strict rotation.
    """

    POLICIES = ("least_loaded", "prefix_affinity", "round_robin")

    def __init__(self, policy: str = "least_loaded", prefix_len: int = 64):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}; one of {self.POLICIES}"
            )
        self.policy = policy
        self.prefix_len = prefix_len
        self._rr = 0  # guarded by the owning service's lock

    def route(self, prompt: str, views: Sequence[ReplicaView]) -> int:
        """Replica index for ``prompt`` among the given (alive) views."""
        if not views:
            raise RuntimeError("no alive replicas to route to")
        if len(views) == 1:
            return views[0].index
        if self.policy == "least_loaded":
            return min(views, key=lambda v: (v.load, v.index)).index
        if self.policy == "prefix_affinity":
            h = hashlib.sha256(
                prompt[: self.prefix_len].encode("utf-8", "replace")
            ).digest()
            return views[int.from_bytes(h[:8], "big") % len(views)].index
        pick = views[self._rr % len(views)].index
        self._rr += 1
        return pick


def aggregate_batcher_stats(parts: Sequence[dict]) -> dict:
    """Fleet batcher counters: counters sum across replicas, occupancy is
    active slot-steps over slot-step capacity, tokens a step is per
    (replica, step)."""
    parts = [p for p in parts if p]
    if not parts:
        return {}
    agg = {
        k: sum(p.get(k, 0) for p in parts)
        for k in (
            "n_slots", "steps", "admissions", "completions",
            "tokens_generated", "active_slot_steps", "prefill_recompiles",
            "prefills_deferred", "prefix_pages_hit", "prefix_tokens_saved",
            "cow_copies", "preemptions", "preempted_tokens", "pool_pages",
        )
    }
    # a rate shared by replicas of one config, not a counter
    agg["kv_bytes_per_token"] = max(
        (p.get("kv_bytes_per_token", 0) for p in parts), default=0
    )
    cap = sum(p.get("steps", 0) * p.get("n_slots", 0) for p in parts)
    agg["slot_occupancy"] = round(
        agg["active_slot_steps"] / cap if cap else 0.0, 4
    )
    agg["tokens_per_step"] = round(
        agg["tokens_generated"] / agg["steps"] if agg["steps"] else 0.0, 3
    )
    return agg


class InferenceService:
    """Session-owned dispatch front for one engine (``engine``) or N
    data-parallel replicas of it (``engines``).

    ``submit`` never blocks on inference, only on a full replica queue
    (``queue_depth`` outstanding submissions); ``ServiceTicket.result``
    gathers.  Threads start on first use and are joined by :meth:`close`.
    ``max_replica_restarts`` (0: the first crash retires a replica),
    ``restart_backoff_s`` (doubled each restart, slept through ``sleep``)
    and ``health_probe_steps`` (0: no probe) set the fault tolerance."""

    #: ceiling on dispatcher threads a replica (the rate limiter, not the
    #: thread count, is the admission control)
    HARD_MAX_DISPATCHERS = 128

    def __init__(
        self,
        engine: InferenceEngine | None = None,
        *,
        engines: Sequence[InferenceEngine] | None = None,
        routing: "str | ReplicaRouter" = "least_loaded",
        queue_depth: int = 256,
        coalesce: bool = True,
        max_batch_wait_ms: float = 2.0,
        n_dispatchers: int = 4,
        sleep: Callable[[float], None] = time.sleep,
        name: str = "",
        max_replica_restarts: int = 0,
        restart_backoff_s: float = 0.05,
        health_probe_steps: int = 0,
    ):
        fleet = list(engines) if engines else []
        if engine is not None and not fleet:
            fleet = [engine]
        if not fleet:
            raise ValueError("InferenceService needs at least one engine")
        streaming = {bool(getattr(e, "supports_streaming", False)) for e in fleet}
        if len(streaming) != 1:
            raise ValueError(
                "replica fleet mixes streaming and non-streaming engines"
            )
        #: replica 0's engine
        self.engine = fleet[0]
        self.coalesce = coalesce
        self.max_batch_wait_ms = max_batch_wait_ms
        self.name = name
        self.max_replica_restarts = max(0, max_replica_restarts)
        self.restart_backoff_s = restart_backoff_s
        self.health_probe_steps = max(0, health_probe_steps)
        self.stats = ServiceStats()
        self.router = (
            routing if isinstance(routing, ReplicaRouter)
            else ReplicaRouter(routing)
        )
        self._sleep = sleep
        self.replicas = [
            _Replica(i, e, queue_depth) for i, e in enumerate(fleet)
        ]
        self._inflight: dict[str, _Flight] = {}
        self._lock = threading.Lock()
        self._base_dispatchers = max(1, n_dispatchers)
        self._attached = 0
        self._closed = False
        self._broken: BaseException | None = None
        self._streaming = streaming.pop()
        self._uniq = itertools.count()

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def _threads(self) -> list[threading.Thread]:
        """Every replica's threads."""
        return [t for rep in self.replicas for t in rep.threads]

    # -- capacity ---------------------------------------------------------------

    def attach(self, n_workers: int = 1) -> None:
        """A stage is about to submit with ``n_workers`` of parallelism.  A
        slot engine needs one batcher thread a replica whatever the stages
        (decode slots are its parallelism); an API engine gets at least
        that many dispatcher threads a replica."""
        with self._lock:
            self._check_open()
            self._attached += max(1, n_workers)
            self._ensure_dispatchers()

    def detach(self, n_workers: int = 1) -> None:
        """The stage is done submitting; threads never shrink, idle ones
        wait on their queue."""
        with self._lock:
            self._attached = max(0, self._attached - max(1, n_workers))

    def _threads_per_replica(self) -> int:
        if self._streaming:
            return 1
        return min(self.HARD_MAX_DISPATCHERS,
                   max(self._base_dispatchers, self._attached))

    def _ensure_dispatchers(self) -> None:  # caller holds self._lock
        target = self._threads_per_replica()
        for rep in self.replicas:
            while len(rep.threads) < target:
                idx = len(rep.threads)
                t = threading.Thread(
                    target=self._batcher_loop if self._streaming
                    else self._dispatch_loop,
                    args=(rep,) if self._streaming else (rep, idx),
                    name=(f"infer-service-{self.name or 'engine'}"
                          f"-r{rep.index}-{idx}"),
                    daemon=True,
                )
                rep.threads.append(t)
                t.start()

    # -- submission --------------------------------------------------------------

    def _alive_views(self, restarting: bool = False) -> list[ReplicaView]:
        """Load snapshots of the replicas that are not broken, or with
        ``restarting`` of those not retired (caller holds self._lock)."""
        return [
            ReplicaView(
                index=r.index,
                queued=r.queue.qsize(),
                outstanding=r.outstanding,
            )
            for r in self.replicas
            if (not r.retired if restarting else r.broken is None)
        ]

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
        deadline_s: float = 0.0,
    ) -> ServiceTicket:
        """Enqueue a request; returns its ticket at once.  ``key`` is the
        request's content address (the response-cache key): identical
        in-flight keys coalesce into one engine call unless coalescing is
        off, checked before routing, so across replicas.  ``limiter`` (an
        :class:`AdaptiveLimiter` or a list of
        :class:`~repro_torch.core.ratelimit.TokenBucket`) is acquired for
        ``est_tokens`` right before each engine call; a recoverable error is
        retried ``max_retries`` times, backing off from ``retry_delay``.
        ``deadline_s`` > 0 hedges the request to another replica once it
        has waited that long."""
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
            # with every replica restarting, a submission waits in the queue
            # of one that will come back
            views = self._alive_views() or self._alive_views(restarting=True)
            if not views:
                self.stats.submitted -= 1
                raise RuntimeError(
                    f"InferenceService {self.name!r}: all "
                    f"{self.n_replicas} replicas failed — "
                    + self._fleet_report()
                )
            flight = _Flight(key)
            if do_coalesce:
                self._inflight[key] = flight
            rep = self.replicas[self.router.route(request.prompt, views)]
            rep.routed += 1
            rep.outstanding += 1
            self._ensure_dispatchers()
        prepare = getattr(rep.engine, "prepare", None)
        if prepare is not None and self.n_replicas > 1:
            prepare(request)
        # outside the lock: a full replica queue blocks the submitter, never
        # the threads that serve it
        rep.queue.put(
            _Submission(
                flight, request, limiter, est_tokens, max_retries,
                retry_delay, replica=rep,
                deadline_at=(
                    time.monotonic() + deadline_s if deadline_s > 0 else None
                ),
            )
        )
        rep.wake.set()
        with self._lock:
            dead = self._closed or self._broken is not None or rep.retired
        if dead:
            # close() or the replica's retirement may have drained the queue
            # between the open check and the put: nobody will read this
            # submission, so fail it rather than strand its waiters (a
            # replica that is restarting reads its queue again)
            self._drain_replica(
                rep, exc=rep.broken or RuntimeError("InferenceService closed")
            )
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

    def _resolve(
        self,
        sub: _Submission,
        response: InferenceResponse | None = None,
        exc: BaseException | None = None,
    ) -> None:
        flight, rep = sub.flight, sub.replica
        with self._lock:
            if flight.resolved:
                # a hedge-race loser, or a drain reaching a resolved flight:
                # the first resolution owns the response and the counters
                if rep is not None:
                    rep.outstanding = max(0, rep.outstanding - 1)
                return
            flight.resolved = True
            self._inflight.pop(flight.key, None)
            self.stats.completed += 1
            self.stats.retries += max(0, flight.attempts - 1)
            if sub.is_hedge:
                self.stats.hedges_won += 1
            failed = exc is not None or (
                response is not None and response.error is not None
            )
            if failed:
                self.stats.errors += 1
            if rep is not None:
                rep.outstanding = max(0, rep.outstanding - 1)
                rep.completed += 1
                if failed:
                    rep.errors += 1
        flight.response = response
        flight.exc = exc
        flight.event.set()

    def _count_dispatch(self, sub: _Submission) -> None:
        sub.flight.attempts += 1
        with self._lock:
            self.stats.dispatched += 1
            sub.replica.dispatched += 1

    def _dispatch_loop(self, rep: _Replica, widx: int) -> None:
        """A dispatcher thread of an API-engine replica: one ``infer`` a
        request, retried through :func:`retry_with_backoff` with the
        injected sleep; after each call it serves further queued
        submissions without blocking again, and exits on the one stop
        sentinel it takes."""
        while True:
            item = rep.queue.get()
            while True:
                if item is _SENTINEL:
                    return
                sub: _Submission = item
                try:
                    self._admit(sub, widx)

                    def call(sub=sub) -> InferenceResponse:
                        self._count_dispatch(sub)
                        return rep.engine.infer(sub.request)

                    resp = retry_with_backoff(
                        call, max_retries=sub.max_retries,
                        base_delay=sub.retry_delay, sleep=self._sleep,
                    )
                    self._resolve(sub, resp)
                except BaseException as e:  # noqa: BLE001 — every waiter must wake
                    self._resolve(sub, exc=e)
                try:
                    item = rep.queue.get_nowait()
                except queue.Empty:
                    break

    def _batcher_loop(self, rep: _Replica) -> None:
        """Replica supervisor: run the batcher, and on a crash (or a
        health-probe hang verdict) either restart the replica, carrying its
        in-flight submissions into the fresh incarnation, or, with the
        restart budget spent, fail them and retire the replica."""
        used = 0
        carry: list[_Submission] = []
        while True:
            state = _BatcherState()
            # survivors of the previous incarnation dispatch first (not
            # through the bounded queue, whose only reader is this thread)
            state.carry = carry
            try:
                self._batcher_run(rep, state)
                return  # clean shutdown through the stop sentinel
            except BaseException as e:  # noqa: BLE001
                carry = state.survivors()
                used = self._handle_replica_failure(rep, e, carry, used)
                if used < 0:
                    return

    def _handle_replica_failure(
        self,
        rep: _Replica,
        exc: BaseException,
        carry: list[_Submission],
        used: int,
    ) -> int:
        """Recover or retire a crashed or hung replica.  Returns the
        restarts used so far, or -1 once the replica is retired (its
        survivors failed; the service broken if it was the last alive).  A
        failed ``engine.reset()`` uses a restart and tries again."""
        while True:
            with self._lock:
                rep.broken = exc
                if rep.first_failure is None:
                    rep.first_failure = exc
                closed = self._closed
            if closed or used >= self.max_replica_restarts:
                with self._lock:
                    rep.retired = True
                    if all(r.retired for r in self.replicas):
                        self._broken = exc
                for sub in carry:
                    self._resolve(sub, exc=exc)
                self._drain_replica(rep, exc=exc)
                return -1
            self._sleep(self.restart_backoff_s * (2.0 ** used))
            used += 1
            try:
                rep.engine.reset()
            except BaseException as e2:  # noqa: BLE001
                exc = e2
                continue
            with self._lock:
                rep.broken = None
                rep.restarts += 1
                self.stats.restarts += 1
            # the fresh incarnation dispatches `carry` again: the engine
            # issues new stream ids, and a response is a pure function of
            # its request, so the output is the one the crash lost
            rep.wake.set()
            return used

    def _issue_hedge(self, sub: _Submission, origin: _Replica) -> bool:
        """Issue an expired submission's flight to another alive replica.
        Both legs share the flight; the first resolution wins and the loser
        is cancelled by its own loop.  Returns True once there is nothing
        more to do (the leg is queued, or the flight resolved)."""
        with self._lock:
            if self._closed or sub.flight.resolved:
                return True
            views = [v for v in self._alive_views() if v.index != origin.index]
            if not views:
                return False  # try again on a later pump
            rep2 = self.replicas[self.router.route(sub.request.prompt, views)]
            hedge = _Submission(
                sub.flight, sub.request, sub.limiter, sub.est_tokens,
                sub.max_retries, sub.retry_delay, replica=rep2, is_hedge=True,
            )
            try:
                # a batcher thread never blocks on backpressure: a full
                # queue defers the hedge to the next pump
                rep2.queue.put_nowait(hedge)
            except queue.Full:
                return False
            rep2.routed += 1
            rep2.outstanding += 1
            self.stats.hedges_issued += 1
        rep2.wake.set()
        return True

    def _batcher_run(self, rep: _Replica, state: _BatcherState) -> None:
        """The continuous-batching loop of one slot-engine replica: admit
        queued prompts into the engine, step it, deliver what finished; a
        cold batcher waits ``max_batch_wait_ms`` (through the injected
        sleep) for co-submitted prompts before it starts decoding.

        Error taxonomy (DESIGN.md §9): ``RecoverableEngineError`` retries
        through ``retry_at`` (due at once unless the injected sleep is
        ``time.sleep``: the loop never sleeps a backoff, other slots are
        decoding); ``ValueError`` / ``TypeError`` fail the one ticket; any
        other exception propagates to the supervisor with the in-flight
        submissions in ``state``.  Each iteration also enforces deadlines
        (expiry hedges to another replica), cancels the legs whose flight
        another replica won, and runs the no-progress health probe; after a
        pump without progress the loop waits up to ``STALL_WAIT_S`` for new
        work (the reference pumps again at once).  The rate-limiter index
        goes round the workers, one admission each."""
        engine = rep.engine
        pending = state.pending
        retry_at = state.retry_at
        wait_s = max(0.0, self.max_batch_wait_ms) / 1000.0
        real_sleep = self._sleep is time.sleep
        stop = False
        admit_rr = 0

        def backoff(sub: _Submission) -> float:
            delay = sub.retry_delay * 2.0 ** (sub.flight.attempts - 1)
            return time.monotonic() + (delay if real_sleep else 0.0)

        def engine_steps() -> int:
            try:
                return int(engine.serving_stats().get("steps", 0) or 0)
            except Exception:  # noqa: BLE001 — the probe must not kill the loop
                return 0

        def dispatch(sub: _Submission) -> None:
            nonlocal admit_rr
            try:
                self._admit(sub, admit_rr)
                admit_rr += 1
                self._count_dispatch(sub)
                pending[engine.stream_submit(sub.request)] = sub
            except RecoverableEngineError as e:
                if sub.flight.attempts <= sub.max_retries:
                    retry_at.append((backoff(sub), sub))
                else:
                    self._resolve(sub, exc=e)
            except (ValueError, TypeError) as e:
                # a bad request fails its own ticket; the replica lives on
                self._resolve(sub, exc=e)
            except BaseException:
                # a crash: the submission in hand is in neither `pending`
                # nor the queue, so carry it into the restart path
                state.carry.append(sub)
                raise

        # survivors of a crashed incarnation dispatch first; a repeat crash
        # lands them back in state.carry or pending
        while state.carry:
            dispatch(state.carry.pop(0))

        while True:
            was_idle = not pending
            admitted = 0
            # due retries leave the list one at a time: if a dispatch raises,
            # the rest are still there for the supervisor
            now = time.monotonic()
            i = 0
            while i < len(retry_at):
                if retry_at[i][0] <= now:
                    dispatch(retry_at.pop(i)[1])
                    admitted += 1
                else:
                    i += 1
            # cleared before the queue is read: a put after this point sets
            # it again, so the wait below cannot miss a submission
            rep.wake.clear()
            while not stop:
                try:
                    item = rep.queue.get_nowait()
                except queue.Empty:
                    break
                if item is _SENTINEL:
                    stop = True
                    break
                dispatch(item)
                admitted += 1
            if pending:
                now = time.monotonic()
                for rid in list(pending):
                    sub = pending[rid]
                    if sub.flight.resolved:
                        # another replica won this flight: cancel the local
                        # leg, freeing its slot and pages
                        pending.pop(rid)
                        try:
                            engine.stream_cancel(rid)
                        except Exception:  # noqa: BLE001
                            pass
                        with self._lock:
                            rep.outstanding = max(0, rep.outstanding - 1)
                            rep.cancelled += 1
                        continue
                    if sub.deadline_at is not None and now >= sub.deadline_at:
                        if not sub.expired:
                            sub.expired = True
                            with self._lock:
                                self.stats.deadline_expiries += 1
                        if not sub.hedged:
                            sub.hedged = self._issue_hedge(sub, rep)
            if not pending:
                if stop and not retry_at:
                    return
                rep.wake.wait(timeout=0.005 if retry_at else 0.05)
                continue
            if was_idle and admitted and wait_s and not stop:
                self._sleep(wait_s)
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
                self._resolve(sub, resp)
            # health probe: progress is a completion or an engine step; a
            # replica with work in flight that shows neither for
            # health_probe_steps pumps in a row is hung (a wedged engine
            # raises nothing, only the probe sees it)
            steps_now = engine_steps()
            progressed = bool(done) or steps_now != state.last_steps
            state.last_steps = steps_now
            if progressed:
                state.stall = 0
                with self._lock:
                    rep.last_progress = steps_now
            elif pending:
                state.stall += 1
                if self.health_probe_steps and state.stall >= self.health_probe_steps:
                    raise ReplicaHungError(
                        f"replica {rep.index}: no engine progress in "
                        f"{state.stall} pumps with {len(pending)} "
                        f"request(s) in flight"
                    )
                # a stalled replica waits for new work a moment instead of
                # spinning: a spinning thread would hold the interpreter
                # lock from the replicas that decode
                rep.wake.wait(timeout=STALL_WAIT_S)

    # -- lifecycle ---------------------------------------------------------------

    def _fleet_report(self) -> str:
        """Every replica's first failure, last progress step and restarts,
        for the fleet-dead error."""
        parts = []
        for r in self.replicas:
            cause = r.first_failure or r.broken
            parts.append(
                f"replica {r.index}: "
                + (f"{cause!r}" if cause is not None else "alive")
                + f" (last progress step {r.last_progress}, "
                f"restarts {r.restarts})"
            )
        return "; ".join(parts)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("InferenceService is closed")
        if self._broken is not None:
            raise RuntimeError(
                f"InferenceService dispatch failed: {self._broken!r} — "
                + self._fleet_report()
            )

    def _drain_replica(self, rep: _Replica, exc: BaseException) -> None:
        """Fail every submission queued on one replica; stop sentinels are
        put back for the threads that have not taken theirs."""
        sentinels = 0
        while True:
            try:
                item = rep.queue.get_nowait()
            except queue.Empty:
                break
            if item is _SENTINEL:
                sentinels += 1
            else:
                self._resolve(item, exc=exc)
        for _ in range(sentinels):
            rep.queue.put(_SENTINEL)

    def close(self, timeout: float = 30.0) -> None:
        """Drain and stop: queued work is served (the stop sentinels sit
        behind it), in-flight decode and scheduled retries finish, then the
        threads exit and are joined."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            plan = [(rep, list(rep.threads)) for rep in self.replicas]
        for rep, threads in plan:
            for _ in threads:
                rep.queue.put(_SENTINEL)
            rep.wake.set()
        for rep, threads in plan:
            for t in threads:
                t.join(timeout=timeout)
        # a submit racing close may have queued behind the sentinels
        for rep in self.replicas:
            self._drain_replica(rep, exc=RuntimeError("InferenceService closed"))

    def __enter__(self) -> "InferenceService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- introspection -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The service's counters and, under ``"batcher"``, the engine's
        batcher counters (one replica) or the fleet's
        (:func:`aggregate_batcher_stats`); with several replicas each
        one's routing and batcher counters under ``"replica_stats"``."""
        with self._lock:
            d = {
                "engine": self.name,
                "mode": "batcher" if self._streaming else "threads",
                "replicas": self.n_replicas,
                "dispatchers": sum(len(r.threads) for r in self.replicas),
                "inflight": len(self._inflight),
                **self.stats.as_dict(),
            }
            per_replica = [rep.stats_dict() for rep in self.replicas]
        parts = [p.get("batcher", {}) for p in per_replica]
        batcher = parts[0] if self.n_replicas == 1 else aggregate_batcher_stats(parts)
        if batcher:
            d["batcher"] = batcher
        if self.n_replicas > 1:
            d["replica_stats"] = per_replica
        return d
