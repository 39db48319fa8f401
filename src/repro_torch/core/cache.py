"""Content-addressable response cache on DeltaLite (the port's copy of
``repro/core/cache.py``, paper section 3.2): entries keyed by
:func:`~repro_torch.core.config.cache_key`, looked up and written under a
:class:`~repro_torch.core.config.CachePolicy`."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

from repro_torch.core.config import CachePolicy, cache_key
from repro_torch.storage.deltalite import DeltaLite


class CacheMiss(Exception):
    """Raised in REPLAY mode when a key is absent."""


@dataclasses.dataclass
class CacheEntry:
    prompt_hash: str
    model_name: str
    provider: str
    prompt_text: str
    response_text: str
    input_tokens: int
    output_tokens: int
    latency_ms: float
    created_at: float
    ttl_days: int | None = None

    def to_row(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_row(cls, row: dict) -> "CacheEntry":
        return cls(**{k: row.get(k) for k in cls.__dataclass_fields__})


class ResponseCache:
    """Five-policy cache; point lookups go through the DeltaLite CAS index.

    A warm in-memory key set makes the hot path O(1); it is rebuilt lazily
    from the log when the underlying table version moves (other writers).

    One handle is safely shared by concurrent chunk workers: the key set,
    version watermark and hit/miss/write counters are guarded by a single
    reentrant lock, so a ``_refresh`` racing a ``put`` can never publish a
    key set older than the version it is stamped with, and the counters
    never lose increments.  (DeltaLite appends themselves are already safe
    via optimistic concurrency — the lock covers the in-memory mirror.)
    """

    def __init__(self, path: str, policy: CachePolicy = CachePolicy.ENABLED):
        self.policy = policy
        self.table = DeltaLite(path, key_column="prompt_hash")
        self._known_version = -2
        self._keys: set[str] = set()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.writes = 0

    # -- key management --------------------------------------------------------

    def _refresh(self) -> None:
        v = self.table.latest_version()
        if v != self._known_version:
            self._keys = self.table.keys() if v >= 0 else set()
            self._known_version = v

    @staticmethod
    def key_for(
        prompt: str, model_name: str, provider: str,
        temperature: float, max_tokens: int,
    ) -> str:
        return cache_key(prompt, model_name, provider, temperature, max_tokens)

    # -- policy-aware operations -------------------------------------------------

    def lookup(self, key: str) -> CacheEntry | None:
        if self.policy in (CachePolicy.DISABLED, CachePolicy.WRITE_ONLY):
            return None
        with self._lock:
            self._refresh()
            if key not in self._keys:
                if self.policy == CachePolicy.REPLAY:
                    raise CacheMiss(
                        f"replay mode: {key[:12]}… not cached "
                        f"({len(self._keys)} entries present)"
                    )
                self.misses += 1
                return None
        # segment read happens outside the lock: concurrent lookups must
        # not serialize behind each other's (or a writer's) disk I/O
        row = self.table.lookup(key)
        if row is None:  # pragma: no cover — index said yes, table says no
            with self._lock:
                self.misses += 1
            return None
        entry = CacheEntry.from_row(row)
        if entry.ttl_days is not None and entry.created_at is not None:
            age_days = (time.time() - entry.created_at) / 86_400.0
            if age_days > entry.ttl_days:
                with self._lock:
                    self.misses += 1
                return None
        with self._lock:
            self.hits += 1
        return entry

    def put(self, entries: list[CacheEntry]) -> int:
        """Cache entries per policy; returns how many were recorded."""
        if self.policy in (CachePolicy.DISABLED, CachePolicy.READ_ONLY,
                           CachePolicy.REPLAY):
            return 0
        if not entries:
            return 0
        # the append itself is already safe under DeltaLite's optimistic
        # concurrency; only the in-memory mirror goes under the lock, so
        # readers are never blocked behind a writer's segment+commit I/O
        self.table.append([e.to_row() for e in entries])
        with self._lock:
            self._keys.update(e.prompt_hash for e in entries)
            self._known_version = self.table.latest_version()
            self.writes += len(entries)
        return len(entries)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "writes": self.writes,
                "hit_rate": self.hits / total if total else 0.0,
                "entries": len(self._keys),
                "version": self.table.latest_version(),
            }
