"""Token-bucket rate limiting (``repro/core/ratelimit.py``, the paper's
Algorithm 1).

Each worker holds two buckets, requests a minute and tokens a minute, each
refilled continuously at ``limit / 60`` a second; the global limits are
split evenly over ``n_workers``.  :class:`AdaptiveLimiter` re-grants the
global budget every window in proportion to each worker's demand.  On the
lock-step path a worker acquires before each engine call; through the
inference service the dispatcher acquires right before it calls the
engine, and the worker index is the dispatcher's.

The clock and the sleep are injected, so tests run without sleeping; a
session without ``wall_clock_rate_limit`` injects a sleep that does
nothing, and its limiters only keep accounts.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class TokenBucket:
    """``acquire(estimated_tokens)`` waits until one request and the tokens
    fit in this worker's buckets."""

    def __init__(
        self,
        rpm_limit: float,
        tpm_limit: float,
        n_workers: int = 1,
        *,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.r = rpm_limit / n_workers          # this worker's requests a minute
        self.t = tpm_limit / n_workers          # this worker's tokens a minute
        self.request_tokens = self.r
        self.token_tokens = self.t
        self.clock = clock
        self.sleep = sleep
        self.last_update = clock()
        self.total_wait = 0.0
        self.acquires = 0
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self.clock()
        elapsed = now - self.last_update
        self.request_tokens = min(self.r, self.request_tokens + elapsed * self.r / 60.0)
        self.token_tokens = min(self.t, self.token_tokens + elapsed * self.t / 60.0)
        self.last_update = now

    def acquire(self, estimated_tokens: float = 0.0) -> float:
        """Wait until one request and ``estimated_tokens`` fit, take them,
        and return the seconds waited."""
        with self._lock:
            self._refill()
            wait = 0.0
            if self.request_tokens < 1.0:
                wait = max(wait, (1.0 - self.request_tokens) * 60.0 / self.r)
            if self.token_tokens < estimated_tokens:
                wait = max(
                    wait, (estimated_tokens - self.token_tokens) * 60.0 / self.t
                )
            if wait > 0:
                self.sleep(wait)
                self.total_wait += wait
                self._refill()
            self.request_tokens -= 1.0
            self.token_tokens -= estimated_tokens
            self.acquires += 1
            return wait


class AdaptiveLimiter:
    """Per-worker buckets under one global limit, re-granted every
    ``window`` seconds: each worker's share becomes ``floor / n`` plus
    ``1 - floor`` times its fraction of the last window's acquires, so the
    shares sum to 1 and an idle worker keeps a floor to restart from."""

    def __init__(
        self,
        rpm_limit: float,
        tpm_limit: float,
        n_workers: int,
        *,
        window: float = 5.0,
        floor: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.rpm, self.tpm, self.n = rpm_limit, tpm_limit, n_workers
        self.window, self.floor = window, floor
        self.clock = clock
        self.buckets = [
            TokenBucket(rpm_limit, tpm_limit, n_workers, clock=clock, sleep=sleep)
            for _ in range(n_workers)
        ]
        self._last_counts = [0] * n_workers
        self._last_rebalance = clock()
        self._lock = threading.Lock()

    def acquire(self, worker: int, estimated_tokens: float = 0.0) -> float:
        self._maybe_rebalance()
        return self.buckets[worker].acquire(estimated_tokens)

    def shares(self) -> list[float]:
        """Each worker's fraction of the global budget (they sum to 1)."""
        return [b.r / self.rpm for b in self.buckets]

    def _maybe_rebalance(self) -> None:
        with self._lock:
            now = self.clock()
            if now - self._last_rebalance < self.window:
                return
            demand = [
                b.acquires - last
                for b, last in zip(self.buckets, self._last_counts)
            ]
            total = sum(demand)
            if total > 0:
                weights = [
                    self.floor / self.n + (1 - self.floor) * d / total
                    for d in demand
                ]
                for b, w in zip(self.buckets, weights):
                    # never block here: a worker may be sleeping in acquire
                    # with its bucket lock held while every other acquire
                    # waits on this limiter's lock.  A busy bucket keeps its
                    # old grant until the next window.
                    if b._lock.acquire(blocking=False):
                        try:
                            b.r = self.rpm * w
                            b.t = self.tpm * w
                        finally:
                            b._lock.release()
            self._last_counts = [b.acquires for b in self.buckets]
            self._last_rebalance = now
