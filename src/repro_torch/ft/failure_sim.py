"""Deterministic failure injection (the streaming part of
``repro/ft/failure_sim.py``): :class:`FlakyFn` wraps a shard function with
faults scheduled by (shard index, attempt), and
:class:`ChunkCrashMiddleware` kills a streaming run after a chunk has
committed to its spill manifest, so tests reproduce a crash and its
resume exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable


@dataclasses.dataclass
class Fault:
    shard: int
    attempt: int            # 1-based: fail the Nth attempt of this shard
    kind: str = "raise"     # raise | delay
    delay_s: float = 0.0


class FlakyFn:
    """Wrap fn(idx, shard, worker) with deterministic fault injection."""

    def __init__(self, fn: Callable, faults: list[Fault]):
        self.fn = fn
        self.faults = {(f.shard, f.attempt): f for f in faults}
        self.attempt_counts: dict[int, int] = {}
        self.injected: list[tuple[int, int, str]] = []

    def __call__(self, idx: int, shard: Any, worker: int):
        attempt = self.attempt_counts.get(idx, 0) + 1
        self.attempt_counts[idx] = attempt
        fault = self.faults.get((idx, attempt))
        if fault is not None:
            self.injected.append((idx, attempt, fault.kind))
            if fault.kind == "raise":
                raise RuntimeError(f"injected failure shard={idx} attempt={attempt}")
            if fault.kind == "delay":
                time.sleep(fault.delay_s)
        return self.fn(idx, shard, worker)


class SimulatedCrash(RuntimeError):
    """Injected death of the evaluating process: it 'dies' mid-run, leaving any
    on-disk state (checkpoints, spill manifests) exactly as committed."""


class ChunkCrashMiddleware:
    """Deterministic crash injection for streaming evaluation runs.

    Reuses the :class:`Fault` schedule with ``shard`` = chunk index: a
    ``raise`` fault at ``(chunk, attempt)`` kills the run *after* that
    chunk committed to the spill manifest — the streaming analogue of
    node death between Spark task commits.  Attempts are counted per
    chunk across restarts of the same middleware instance, so a resumed
    run (which skips committed chunks and never re-fires their hooks)
    proceeds past the crash point.

    Duck-types :class:`repro_torch.core.stages.Middleware` (only the
    ``on_chunk_end`` hook does anything).
    """

    def __init__(self, faults: list[Fault]):
        self.faults = {(f.shard, f.attempt): f for f in faults}
        self.attempt_counts: dict[int, int] = {}
        self.injected: list[tuple[int, int, str]] = []

    def on_task_start(self, task, rows, session) -> None:
        pass

    def on_stage_start(self, stage, art, session) -> None:
        pass

    def on_stage_end(self, stage, art, session) -> None:
        pass

    def on_task_end(self, task, result, session) -> None:
        pass

    def on_chunk_end(self, chunk_index: int, state: dict, session) -> None:
        attempt = self.attempt_counts.get(chunk_index, 0) + 1
        self.attempt_counts[chunk_index] = attempt
        fault = self.faults.get((chunk_index, attempt))
        if fault is not None:
            self.injected.append((chunk_index, attempt, fault.kind))
            if fault.kind == "raise":
                raise SimulatedCrash(
                    f"injected driver death after chunk={chunk_index} "
                    f"attempt={attempt}"
                )
            if fault.kind == "delay":
                time.sleep(fault.delay_s)
