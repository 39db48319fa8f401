"""Fault-tolerant shard execution and failure injection (the ported part of
``repro/ft/``; ``simulate_training`` waits for the training slice)."""

from repro_torch.ft.failure_sim import (
    SERVING_FAULT_KINDS,
    ChunkCrashMiddleware,
    Fault,
    FlakyFn,
    ServingFault,
    ServingFaultSchedule,
    SimulatedCrash,
)
from repro_torch.ft.workers import PoolStats, ShardResult, WorkerPool

__all__ = [
    "SERVING_FAULT_KINDS",
    "ChunkCrashMiddleware",
    "Fault",
    "FlakyFn",
    "PoolStats",
    "ServingFault",
    "ServingFaultSchedule",
    "ShardResult",
    "SimulatedCrash",
    "WorkerPool",
]
