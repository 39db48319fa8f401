"""The shard executor pool of ``repro/ft/workers.py``: shards run on a
thread pool; a shard whose attempt raises is retried up to
``max_retries`` times; with ``straggler_factor`` > 0 an in-flight shard
slower than that many times the median finished shard is re-issued on an
idle thread, the first finisher wins and the other result is dropped.

* :meth:`WorkerPool.map_shards` runs a fixed shard list and returns the
  results in shard order (the lock-step inference path);
* :meth:`WorkerPool.imap_windowed` runs an item iterator with at most
  ``window`` items in flight and yields results in completion order, or in
  item order with ``ordered=True`` (the chunk-level surface a concurrent
  streaming executor runs on).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Iterable, Iterator, Sequence


@dataclasses.dataclass
class ShardResult:
    index: int
    value: Any
    attempts: int
    worker: int
    duration_s: float
    speculative: bool = False


@dataclasses.dataclass
class PoolStats:
    shards: int = 0
    retries: int = 0
    speculative_launches: int = 0
    speculative_wins: int = 0
    failures: int = 0

    def merge(self, other: "PoolStats") -> "PoolStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self


#: a running attempt: (item index, attempt number, speculative, start time)
_Attempt = tuple[int, int, bool, float]


class WorkerPool:
    def __init__(
        self,
        n_workers: int = 4,
        *,
        max_retries: int = 3,
        straggler_factor: float = 0.0,  # 0 = speculative re-issue off
        straggler_min_s: float = 0.05,
        poll_s: float = 0.01,
    ):
        self.n_workers = n_workers
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.poll_s = poll_s
        self.stats = PoolStats()
        self.heartbeats: dict[int, float] = {}
        self._worker_ids = threading.local()
        self._next_worker = iter(range(10**9))
        self._lock = threading.Lock()

    def _worker_id(self) -> int:
        wid = getattr(self._worker_ids, "id", None)
        if wid is None:
            with self._lock:
                wid = next(self._next_worker)
            self._worker_ids.id = wid
        return wid

    def _run_shard(self, fn: Callable, index: int, shard: Any, attempt: int,
                   speculative: bool) -> ShardResult:
        wid = self._worker_id()
        t0 = time.monotonic()
        self.heartbeats[wid] = t0
        value = fn(index, shard, wid)
        dt = time.monotonic() - t0
        self.heartbeats[wid] = time.monotonic()
        return ShardResult(
            index=index, value=value, attempts=attempt, worker=wid,
            duration_s=dt, speculative=speculative,
        )

    def _fold_stats(self, local: PoolStats, stats_out: PoolStats | None) -> None:
        """Publish one call's stats: each call counts into its own
        :class:`PoolStats` and folds it into ``self.stats`` under the lock,
        so concurrent calls on one pool lose no increment and ``stats_out``
        gets exactly this call's counts."""
        with self._lock:
            self.stats.merge(local)
        if stats_out is not None:
            stats_out.merge(local)

    def _on_failure(self, local: PoolStats, fut: Future, attempt_: _Attempt,
                    finished: Any, running: dict[Future, _Attempt],
                    launch: Callable[[int, bool], None]) -> bool:
        """Handle a finished attempt: True if it succeeded.  A failed
        attempt is retried while attempts remain; once they are spent it
        re-raises, unless the item already finished or another attempt of
        it still runs."""
        i, attempt, speculative, _t0 = attempt_
        try:
            fut.result()
            return True
        except Exception:
            local.failures += 1
            if attempt <= self.max_retries and i not in finished:
                local.retries += 1
                launch(i, speculative)
            elif i not in finished and not any(
                ri == i for ri, *_ in running.values()
            ):
                raise
            return False

    def _reissue_stragglers(self, local: PoolStats, durations: list[float],
                            running: dict[Future, _Attempt], finished: Any,
                            speculated: set[int], capacity: int,
                            launch: Callable[[int, bool], None]) -> None:
        """Re-issue each first attempt that has run longer than
        ``straggler_factor`` x the median finished duration, once, while a
        thread is free."""
        median = sorted(durations)[len(durations) // 2]
        threshold = max(self.straggler_min_s, self.straggler_factor * median)
        now = time.monotonic()
        for i, _attempt, spec, t0 in list(running.values()):
            if (
                not spec
                and i not in speculated
                and i not in finished
                and now - t0 > threshold
                and len(running) < capacity
            ):
                speculated.add(i)
                local.speculative_launches += 1
                launch(i, True)

    def map_shards(
        self,
        fn: Callable[[int, Any, int], Any],
        shards: Sequence[Any],
        *,
        stats_out: PoolStats | None = None,
    ) -> list[ShardResult]:
        """Run ``fn(shard_index, shard, worker_id)`` over every shard and
        return the results in shard order.  ``stats_out`` receives this
        call's own retry and speculation counts."""
        results: dict[int, ShardResult] = {}
        durations: list[float] = []
        local = PoolStats(shards=len(shards))
        try:
            with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
                running: dict[Future, _Attempt] = {}
                pending = list(range(len(shards)))
                attempts = dict.fromkeys(range(len(shards)), 0)
                speculated: set[int] = set()

                def launch(i: int, speculative: bool = False) -> None:
                    attempts[i] += 1
                    fut = pool.submit(
                        self._run_shard, fn, i, shards[i], attempts[i], speculative
                    )
                    running[fut] = (i, attempts[i], speculative, time.monotonic())

                while running or pending:
                    while pending and len(running) < self.n_workers:
                        launch(pending.pop(0))
                    done, _ = wait(list(running), timeout=self.poll_s,
                                   return_when=FIRST_COMPLETED)
                    for fut in done:
                        att = running.pop(fut)
                        if not self._on_failure(local, fut, att, results,
                                                running, launch):
                            continue
                        res = fut.result()
                        if att[0] not in results:
                            results[att[0]] = res
                            durations.append(res.duration_s)
                            if res.speculative:
                                local.speculative_wins += 1
                    while pending and len(running) < self.n_workers:
                        launch(pending.pop(0))
                    if (self.straggler_factor and durations and not pending
                            and len(running) < self.n_workers):
                        self._reissue_stragglers(local, durations, running, results,
                                                 speculated, self.n_workers, launch)
        finally:
            self._fold_stats(local, stats_out)

        missing = [i for i in range(len(shards)) if i not in results]
        if missing:
            raise RuntimeError(f"shards never completed: {missing}")
        return [results[i] for i in range(len(shards))]

    def imap_windowed(
        self,
        fn: Callable[[int, Any, int], Any],
        items: Iterable[Any],
        *,
        window: int,
        ordered: bool = False,
        stats_out: PoolStats | None = None,
    ) -> Iterator[ShardResult]:
        """Run ``fn(index, item, worker_id)`` over an item iterator with at
        most ``window`` distinct items in flight (the next is pulled only as
        a slot frees), yielding one :class:`ShardResult` per item in
        completion order, or in item order with ``ordered=True``; there an
        item that finishes early holds its slot until it is yielded, so the
        window bounds in-flight and buffered items together.  Retries and
        straggler re-issue as in :meth:`map_shards`."""
        if window < 1:
            raise ValueError(f"window must be positive, got {window}")
        it = iter(items)
        local = PoolStats()
        try:
            with ThreadPoolExecutor(max_workers=window) as pool:
                running: dict[Future, _Attempt] = {}
                payloads: dict[int, Any] = {}
                attempts: dict[int, int] = {}
                done_idx: set[int] = set()
                speculated: set[int] = set()
                ready: dict[int, ShardResult] = {}  # ordered-mode buffer
                next_yield = 0
                durations: list[float] = []
                exhausted = False
                next_index = 0

                def launch(i: int, speculative: bool = False) -> None:
                    attempts[i] = attempts.get(i, 0) + 1
                    fut = pool.submit(
                        self._run_shard, fn, i, payloads[i], attempts[i],
                        speculative,
                    )
                    running[fut] = (i, attempts[i], speculative, time.monotonic())

                while True:
                    while not exhausted and len(payloads) < window:
                        try:
                            item = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        payloads[next_index] = item
                        local.shards += 1
                        launch(next_index)
                        next_index += 1
                    if not running:
                        if exhausted:
                            break
                        continue
                    done, _ = wait(list(running), timeout=self.poll_s,
                                   return_when=FIRST_COMPLETED)
                    for fut in done:
                        att = running.pop(fut)
                        if not self._on_failure(local, fut, att, done_idx,
                                                running, launch):
                            continue
                        res = fut.result()
                        i = att[0]
                        if i in done_idx:
                            continue  # the slower twin of a re-issued item
                        done_idx.add(i)
                        durations.append(res.duration_s)
                        if res.speculative:
                            local.speculative_wins += 1
                        if not ordered:
                            payloads.pop(i, None)  # frees a window slot
                            yield res
                            continue
                        ready[i] = res
                        while next_yield in ready:
                            out = ready.pop(next_yield)
                            payloads.pop(next_yield, None)
                            next_yield += 1
                            yield out
                    if (self.straggler_factor and durations
                            and len(running) < window):
                        self._reissue_stragglers(local, durations, running, done_idx,
                                                 speculated, window, launch)
        finally:
            self._fold_stats(local, stats_out)
