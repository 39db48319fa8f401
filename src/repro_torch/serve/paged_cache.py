"""Host-side bookkeeping of the paged KV cache with hash-chain prefix
sharing: the port's copy of ``repro/serve/paged_cache.py``.  Pure Python,
no tensors: the batcher moves the pages on the device, this module decides
which pages a request owns.

Sharing model
-------------
Each *full* page of a prompt is identified by a rolling hash chain

    h_0 = H(tokens[0:ps]),   h_i = H(h_{i-1} || tokens[i*ps:(i+1)*ps])

so two prompts share page *i* iff their first ``(i+1)*ps`` tokens are
identical.  ``acquire`` walks the chain against the prefix index and
ref-counts every resident match; the suffix gets fresh pages and a normal
prefill.

Sharing is capped at ``(len(tokens) - 1) // page_size`` pages: the page
holding the final prompt token is never shared, so every request prefills
at least one token and decode always writes into a private page.
Copy-on-write is therefore unreachable from the batcher;
``ensure_position`` keeps it as a defensive invariant (a page that is
shared or indexed is never written in place).

Page lifecycle: ``free`` -> ``active`` (ref > 0) -> on release either
``free`` (never indexed) or ``cached`` (ref == 0 but still indexed,
LRU-evicted on pool pressure).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Hashable, Sequence


class PagePoolExhausted(RuntimeError):
    """No free or evictable page in the pool.  The batcher catches it and
    preempts a decode slot instead of failing."""


def kv_page_bytes(
    page_size: int,
    kv_heads: int,
    head_dim: int,
    n_layers: int,
    kv_cache_dtype: str = "bf16",
) -> int:
    """Bytes one KV page costs at the nominal storage width, including the
    f32 scales of an int8 page (one per layer, KV head and K/V)."""
    elems = 2 * n_layers * kv_heads * page_size * head_dim  # K + V
    if kv_cache_dtype == "int8":
        return elems + 2 * n_layers * kv_heads * 4
    if kv_cache_dtype == "bf16":
        return elems * 2
    raise ValueError(
        f"kv_cache_dtype must be 'bf16' or 'int8', got {kv_cache_dtype!r}"
    )


def pages_for_budget(pool_bytes: int, page_bytes: int) -> int:
    """Pages a byte budget admits; raises if it cannot hold even one."""
    n = pool_bytes // page_bytes
    if n <= 0:
        raise ValueError(
            f"pool budget {pool_bytes} B below one page ({page_bytes} B)"
        )
    return n


def page_hash_chain(tokens: Sequence, page_size: int) -> list[bytes]:
    """One digest per *full* page; ``h_i`` commits to ``tokens[:(i+1)*ps]``."""
    chain: list[bytes] = []
    prev = b""
    for i in range(len(tokens) // page_size):
        page = tokens[i * page_size : (i + 1) * page_size]
        payload = prev + "\x1f".join(str(t) for t in page).encode()
        prev = hashlib.sha256(payload).digest()
        chain.append(prev)
    return chain


@dataclasses.dataclass
class PrefixMatch:
    """Result of :meth:`PagedCacheManager.acquire`."""

    page_ids: list[int]      #: full page table for the prompt, in order
    n_shared_pages: int      #: leading entries reused from the prefix index
    n_shared_tokens: int     #: ``n_shared_pages * page_size``


@dataclasses.dataclass
class PageWrite:
    """Result of :meth:`PagedCacheManager.ensure_position`."""

    page_id: int             #: pool page to write into
    page_index: int          #: index of that page in the owner's table
    offset: int              #: row within the page
    allocated: bool = False  #: page was appended to the table by this call
    cow_src: int | None = None  #: the device must copy this page into page_id


@dataclasses.dataclass
class PagedCacheStats:
    lookups: int = 0
    prefix_pages_hit: int = 0
    prefix_tokens_saved: int = 0
    pages_allocated: int = 0
    cow_copies: int = 0
    evictions: int = 0


class PagedCacheManager:
    """Refcounted page pool and prefix index, driven by one batcher loop."""

    def __init__(
        self,
        n_pages: int,
        page_size: int,
        *,
        prefix_cache: bool = True,
        page_bytes: int = 0,
    ):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        #: device bytes one page costs, scales included (0 = not accounted)
        self.page_bytes = page_bytes
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._ref = [0] * n_pages
        #: page id -> chain hash for indexed pages (and the reverse map)
        self._hash_of: dict[int, bytes] = {}
        self._index: dict[bytes, int] = {}
        #: ref == 0 but still indexed, in LRU order (oldest first)
        self._cached: OrderedDict[int, None] = OrderedDict()
        self._tables: dict[Hashable, list[int]] = {}
        self.stats = PagedCacheStats()

    # -- introspection ----------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        return len(self._cached)

    @property
    def pages_active(self) -> int:
        return self.n_pages - len(self._free) - len(self._cached)

    @property
    def kv_bytes_per_token(self) -> int:
        """Bytes one cached token costs, scales included."""
        return self.page_bytes // self.page_size

    def refcount(self, page_id: int) -> int:
        return self._ref[page_id]

    def table(self, owner: Hashable) -> list[int]:
        return list(self._tables[owner])

    # -- page state transitions ---------------------------------------------------

    def _alloc(self) -> int:
        if self._free:
            pid = self._free.pop()
        elif self._cached:
            pid, _ = self._cached.popitem(last=False)  # LRU eviction
            self._unindex(pid)
            self.stats.evictions += 1
        else:
            raise PagePoolExhausted(
                f"page pool exhausted: all {self.n_pages} pages are active"
            )
        self._ref[pid] = 1
        self.stats.pages_allocated += 1
        return pid

    def _retain(self, pid: int) -> None:
        if self._ref[pid] == 0:
            del self._cached[pid]
        self._ref[pid] += 1

    def _release_page(self, pid: int) -> None:
        assert self._ref[pid] > 0, f"double release of page {pid}"
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            if pid in self._hash_of:
                self._cached[pid] = None  # keep the content for later matches
            else:
                self._free.append(pid)

    def _unindex(self, pid: int) -> None:
        h = self._hash_of.pop(pid, None)
        if h is not None and self._index.get(h) == pid:
            del self._index[h]

    # -- public API ---------------------------------------------------------------

    def acquire(self, owner: Hashable, tokens: Sequence) -> PrefixMatch:
        """Build ``owner``'s page table for ``tokens``: match the leading
        hash chain against resident pages (never the final token's page),
        then allocate fresh pages for the suffix."""
        if owner in self._tables:
            raise ValueError(f"owner {owner!r} already holds a page table")
        if not tokens:
            raise ValueError("cannot acquire pages for an empty prompt")
        ps = self.page_size
        n_total = -(-len(tokens) // ps)
        shared: list[int] = []
        if self.prefix_cache:
            self.stats.lookups += 1
            max_share = (len(tokens) - 1) // ps
            for h in page_hash_chain(tokens[: max_share * ps], ps):
                pid = self._index.get(h)
                if pid is None:
                    break
                # retain at once, so a later _alloc of this same walk cannot
                # evict a page it already matched
                self._retain(pid)
                shared.append(pid)
        fresh: list[int] = []
        try:
            for _ in range(n_total - len(shared)):
                fresh.append(self._alloc())
        except PagePoolExhausted:
            # a partial acquire must not leak what it retained or allocated
            for pid in shared + fresh:
                self._release_page(pid)
            raise
        self._tables[owner] = shared + fresh
        self.stats.prefix_pages_hit += len(shared)
        self.stats.prefix_tokens_saved += len(shared) * ps
        return PrefixMatch(
            page_ids=shared + fresh,
            n_shared_pages=len(shared),
            n_shared_tokens=len(shared) * ps,
        )

    def register(self, owner: Hashable, tokens: Sequence) -> int:
        """Index every full page of ``tokens`` once its prefill has filled
        the owner's pages; returns the number of pages newly indexed.  The
        first registration of a hash wins."""
        if not self.prefix_cache:
            return 0
        table = self._tables[owner]
        newly = 0
        for i, h in enumerate(page_hash_chain(tokens, self.page_size)):
            pid = table[i]
            if h in self._index or pid in self._hash_of:
                continue
            self._index[h] = pid
            self._hash_of[pid] = h
            newly += 1
        return newly

    def ensure_position(self, owner: Hashable, pos: int) -> PageWrite:
        """A privately writable page for token position ``pos``: extend the
        owner's table, or copy-on-write a shared or indexed page."""
        table = self._tables[owner]
        page_index, offset = divmod(pos, self.page_size)
        if page_index > len(table):
            raise ValueError(
                f"non-contiguous write: pos {pos} needs page {page_index} "
                f"but owner {owner!r} holds {len(table)} pages"
            )
        if page_index == len(table):
            pid = self._alloc()
            table.append(pid)
            return PageWrite(pid, page_index, offset, allocated=True)
        pid = table[page_index]
        if self._ref[pid] == 1 and pid not in self._hash_of:
            return PageWrite(pid, page_index, offset)
        new = self._alloc()
        self._release_page(pid)
        table[page_index] = new
        self.stats.cow_copies += 1
        return PageWrite(new, page_index, offset, cow_src=pid)

    def release(self, owner: Hashable) -> None:
        """Drop the owner's table; each page frees, or parks in the LRU
        prefix cache if it is indexed."""
        for pid in self._tables.pop(owner):
            self._release_page(pid)

    def release_all(self) -> int:
        """Drop every outstanding owner table (the replica-restart reset);
        returns the number of owners released."""
        owners = list(self._tables)
        for owner in owners:
            self.release(owner)
        return len(owners)

    def check_no_leaks(self) -> None:
        """Raise unless, with no owner outstanding, every page is free or
        cached."""
        if self._tables:
            raise AssertionError(f"outstanding owners: {list(self._tables)}")
        if self.pages_active != 0:
            held = [p for p in range(self.n_pages) if self._ref[p] > 0]
            raise AssertionError(f"leaked pages with nonzero refcount: {held}")
        if len(self._free) + len(self._cached) != self.n_pages:
            raise AssertionError("free + cached does not cover the pool")
