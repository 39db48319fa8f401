"""Deterministic failure injection (the port of ``repro/ft/failure_sim.py``):

* :class:`FlakyFn` wraps a shard function with faults scheduled by (shard
  index, attempt);
* :class:`ChunkCrashMiddleware` kills a streaming run after a chunk has
  committed to its spill manifest, so tests reproduce a crash and its
  resume exactly;
* :class:`ServingFaultSchedule` plans serving faults by (replica, engine
  step): a replica crash, a hang, page pressure or a slow step, polled by
  the simulated slot engine every pump and by the continuous batcher every
  step (``as_hook``);
* :func:`simulate_training` runs a training loop with checkpoints and can
  stop it at a step, as a crashed process would, to be resumed from the
  latest checkpoint.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Sequence


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


SERVING_FAULT_KINDS = ("replica_crash", "hang", "page_pressure", "slow_step")


@dataclasses.dataclass
class ServingFault:
    """One serving-layer fault, scheduled by (replica, engine step).

    Kinds (DESIGN.md §9):

    - ``replica_crash``: the engine raises :class:`SimulatedCrash` out of
      its pump; the service's restart path must recover the replica.
    - ``hang``: the engine makes no progress (no admissions, no decode
      steps, no completions) for ``duration`` pumps; only the service's
      health probe can see this.
    - ``page_pressure``: force-preempt ``duration`` victim slots (fewest
      decoded tokens, index tie-break) of the simulated slot engine, one
      of the batcher, simulating decode-time pool exhaustion.
    - ``slow_step``: a straggler step, ``delay_s`` of extra latency
      (wall-clock engines only; a no-op under the virtual clock).
    """

    replica: int
    step: int               # engine pump/step index the fault fires at
    kind: str = "replica_crash"
    duration: int = 1       # pumps hung / slots preempted
    delay_s: float = 0.0    # extra latency for slow_step

    def __post_init__(self) -> None:
        if self.kind not in SERVING_FAULT_KINDS:
            raise ValueError(
                f"unknown serving fault kind {self.kind!r}; "
                f"expected one of {SERVING_FAULT_KINDS}"
            )


class ServingFaultSchedule:
    """Deterministic serving-layer fault plan keyed by (replica, step).

    Engines claim replica indices via :meth:`attach` in creation order:
    ``EvalSession`` builds replica engines 0..n-1 in order, so a schedule
    passed through ``engine_kwargs={"fault_plan": plan}`` maps faults to
    replicas deterministically.  Each fault fires exactly once, at the
    first poll whose step is >= its scheduled step (the >= keeps a fault
    from being lost if an engine skips step numbers).

    Thread-safe: replicas poll concurrently from their batcher loops.
    """

    def __init__(self, faults: Sequence[ServingFault]):
        self.faults = sorted(faults, key=lambda f: (f.replica, f.step))
        self._by_replica: dict[int, list[ServingFault]] = {}
        for f in self.faults:
            self._by_replica.setdefault(f.replica, []).append(f)
        #: (replica, step fired at, kind) in firing order
        self.injected: list[tuple[int, int, str]] = []
        self._next_index = 0
        self._lock = threading.Lock()

    def attach(self) -> int:
        """Claim the next replica index (engine creation order)."""
        with self._lock:
            i = self._next_index
            self._next_index += 1
            return i

    def poll(self, replica: int, step: int) -> ServingFault | None:
        """Return the due fault for (replica, step), at most one per call."""
        with self._lock:
            due = self._by_replica.get(replica)
            if due and step >= due[0].step:
                fault = due.pop(0)
                self.injected.append((replica, step, fault.kind))
                return fault
        return None

    def as_hook(self, replica: int) -> Callable[[int], str | None]:
        """Adapt the schedule to ``ContinuousBatcher.fault_hook``: a
        callable(step) that raises for ``replica_crash``, sleeps for
        ``slow_step``, and returns the kind string for the batcher to act
        on (``page_pressure``: a forced preemption; ``hang``: skip the
        step).  A ``hang`` is returned for ``duration`` calls in a row, as
        the slot engine hangs for ``duration`` pumps (the reference's hook
        hangs a batcher for one step whatever the duration).  A new hook
        starts unhung: an engine reset ends a hang."""
        hang_left = 0

        def hook(step: int) -> str | None:
            nonlocal hang_left
            if hang_left > 0:
                hang_left -= 1
                return "hang"
            fault = self.poll(replica, step)
            if fault is None:
                return None
            if fault.kind == "replica_crash":
                raise SimulatedCrash(
                    f"injected replica_crash replica={replica} step={step}"
                )
            if fault.kind == "slow_step" and fault.delay_s:
                time.sleep(fault.delay_s)
            if fault.kind == "hang":
                hang_left = max(1, fault.duration) - 1
            return fault.kind

        return hook


def simulate_training(
    train_step: Callable,
    init_state: Any,
    batches: list[Any],
    *,
    ckpt_dir: str,
    crash_at_step: int | None = None,
    ckpt_every: int = 2,
    family: str | None = None,
) -> Any:
    """Run ``state = train_step(state, batch)`` over ``batches``, saving a
    checkpoint after every ``ckpt_every``-th step; with ``crash_at_step``
    return None once that many steps are done (a simulated node death,
    leaving the checkpoints as committed).  A call over a ``ckpt_dir``
    that holds checkpoints resumes from the latest, restored into
    ``init_state``'s structure, dtypes and devices.  ``family`` (the model
    config's) names a model's ``(params, AdamWState)`` state as the
    reference does (see :mod:`repro_torch.ckpt.checkpoint`), so either
    side resumes from the other's checkpoints.

    The port's ``train_step`` updates its state in place, so the state
    passed in is the run's working state: give each run a fresh one."""
    from repro_torch.ckpt.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    start = 0
    state = init_state
    last = latest_step(ckpt_dir)
    if last is not None:
        state, _ = restore_checkpoint(ckpt_dir, last, template=init_state, family=family)
        start = last
    for step in range(start, len(batches)):
        state = train_step(state, batches[step])
        done = step + 1
        if done % ckpt_every == 0:
            if latest_step(ckpt_dir) != done:
                save_checkpoint(ckpt_dir, done, state, family=family)
        if crash_at_step is not None and done >= crash_at_step:
            return None  # simulated node death
    return state
