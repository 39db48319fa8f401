"""Fault-tolerant shard execution and failure injection (the port of
``repro/ft/``)."""

from repro_torch.ft.failure_sim import (
    SERVING_FAULT_KINDS,
    ChunkCrashMiddleware,
    Fault,
    FlakyFn,
    ServingFault,
    ServingFaultSchedule,
    SimulatedCrash,
    simulate_training,
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
    "simulate_training",
]
