"""Fault-tolerant shard execution and failure injection (the ported part of
``repro/ft/``)."""

from repro_torch.ft.failure_sim import (
    ChunkCrashMiddleware,
    Fault,
    FlakyFn,
    SimulatedCrash,
)
from repro_torch.ft.workers import PoolStats, ShardResult, WorkerPool

__all__ = [
    "ChunkCrashMiddleware",
    "Fault",
    "FlakyFn",
    "PoolStats",
    "ShardResult",
    "SimulatedCrash",
    "WorkerPool",
]
