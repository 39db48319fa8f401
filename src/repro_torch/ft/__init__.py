"""Fault-tolerant shard execution (the ported part of ``repro/ft/``)."""

from repro_torch.ft.workers import PoolStats, ShardResult, WorkerPool

__all__ = ["PoolStats", "ShardResult", "WorkerPool"]
