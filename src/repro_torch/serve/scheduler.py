"""Continuous-batching scheduler over a model's per-slot cache: a contiguous
or a paged KV cache for the dense family, the SSM state for Mamba2 (the
``ContinuousBatcher`` of ``repro/serve/scheduler.py``).

A fixed pool of ``n_slots`` decode slots steps in lock-step.  Each step:

1. slots whose last token finished them (EOS or ``max_new_tokens``) emit
   their completion and free up (reap),
2. free slots are refilled from the queue, each prompt prefilled at its
   exact length straight into its slot's cache rows (refill),
3. slots whose first token already finished them are reaped again,
4. one decode step advances every slot.

Decode always runs the full ``n_slots`` batch, as the reference does, free
slots included: every row of the projection GEMMs then has one fixed shape
whatever the other slots hold, and a request's greedy tokens do not depend
on the batch around it.  Free slots keep their stale position and decode
garbage that no one reads; a stale position equal to ``max_len`` writes no
cache row.

With ``page_size`` > 0 the cache is a pool of pages (DESIGN.md section 8):
each slot holds a page table, and a host-side
:class:`~repro_torch.serve.paged_cache.PagedCacheManager` shares prompt
prefix pages across requests by hash chain, so a prompt whose leading pages
are resident prefills only its suffix.  The "bf16" pool holds f32, as the
reference's does; ``kv_cache_dtype="int8"`` stores absmax-quantized pages
with a scale per (page, KV head) (DESIGN.md section 10).  Admission waits
while the pool cannot cover a prompt plus one page of growth per busy slot,
and a decode step that finds no free page preempts the slot with the
fewest decoded tokens and requeues its request for a full recompute: greedy
tokens are reproducible, so preemption costs work, never the output.  Free
slots read an all-zero table and write their row to a trash page past the
pool.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import PageTables
from repro_torch.serve import steps as steps_lib
from repro_torch.serve.paged_cache import (
    PagedCacheManager,
    PagePoolExhausted,
    kv_page_bytes,
    pages_for_budget,
)


#: model families whose caches are pure attention KV, so that they page (the
#: reference's ``_PAGEABLE_FAMILIES``)
PAGEABLE_FAMILIES = ("dense", "moe")


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_tokens: list[int]
    max_new_tokens: int = 32


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: list[int]
    prompt_len: int
    finished_reason: str  # "eos" | "length" | "truncated"
    latency_s: float = 0.0


@dataclasses.dataclass
class BatcherStats:
    """Occupancy and throughput counters of the batcher (the reference
    keeps them in ``repro/core/engines.py``), surfaced by the engine's
    ``serving_stats``.  ``prefill_s`` and ``decode_s`` are host-clock
    seconds around prefills and decode steps, each ending in the host read
    of the sampled tokens, so they include the device time."""

    n_slots: int = 0
    steps: int = 0
    #: sum of active slots over all steps (occupancy numerator)
    active_slot_steps: int = 0
    tokens_generated: int = 0
    admissions: int = 0
    completions: int = 0
    #: admissions pushed past the current step by ``max_prefills_per_step``
    prefills_deferred: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    #: prompt-prefix pages reused from the prefix index (paged cache only)
    prefix_pages_hit: int = 0
    #: prompt tokens whose prefill the shared prefix pages skipped
    prefix_tokens_saved: int = 0
    #: copy-on-write page copies (unreachable while sharing stops short of
    #: the final prompt token)
    cow_copies: int = 0
    #: decode slots evicted under page-pool pressure, and the decoded
    #: tokens they discarded (the recompute cost)
    preemptions: int = 0
    preempted_tokens: int = 0
    #: device bytes one cached token costs, scales included (0 = contiguous)
    kv_bytes_per_token: int = 0
    #: page-pool size in pages (0 = contiguous)
    pool_pages: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.tokens_generated / self.steps if self.steps else 0.0

    @property
    def occupancy(self) -> float:
        cap = self.steps * self.n_slots
        return self.active_slot_steps / cap if cap else 0.0

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["tokens_per_step"] = round(self.tokens_per_step, 3)
        out["slot_occupancy"] = round(self.occupancy, 4)
        return out


def check_kv_cache(page_size: int, kv_cache_dtype: str) -> None:
    """Refuse a cache dtype other than "bf16" (the f32 pool) and "int8",
    and int8 without paging."""
    if kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(
            f"kv_cache_dtype must be 'bf16' or 'int8', got {kv_cache_dtype!r}"
        )
    if kv_cache_dtype == "int8" and not page_size:
        raise ValueError(
            "kv_cache_dtype='int8' requires a paged cache (page_size > 0)"
        )


def paged_page_bytes(cfg: ModelConfig, page_size: int, kv_cache_dtype: str) -> int:
    """Device bytes one pool page costs in every layer, as the reference's
    batcher charges it (its ``paged_page_bytes``): the "bf16" pool stores
    f32, 4 bytes an element; an int8 page stores a byte an element plus its
    f32 scales (:func:`kv_page_bytes`)."""
    if kv_cache_dtype == "int8":
        return kv_page_bytes(
            page_size, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers, "int8"
        )
    return 2 * cfg.n_layers * cfg.n_kv_heads * page_size * cfg.head_dim * 4


class ContinuousBatcher:
    """Slot-multiplexed greedy decode loop around the model's prefill and
    decode step, on the device that holds ``params``."""

    def __init__(
        self,
        model: Any,
        cfg: ModelConfig,
        params: dict,
        *,
        n_slots: int = 8,
        max_len: int = 512,
        eos_id: int = 1,
        max_prefills_per_step: int = 0,
        page_size: int = 0,
        prefix_cache: bool = True,
        page_pool: int = 0,
        page_pool_bytes: int = 0,
        kv_cache_dtype: str = "bf16",
    ):
        check_kv_cache(page_size, kv_cache_dtype)
        if page_size and cfg.family not in PAGEABLE_FAMILIES:
            raise ValueError(
                f"paged KV cache supports GQA attention families "
                f"{PAGEABLE_FAMILIES}, not {cfg.family}"
            )
        self.model, self.cfg, self.params = model, cfg, params
        self.n_slots, self.max_len, self.eos_id = n_slots, max_len, eos_id
        #: 0 = unlimited; otherwise at most this many prompts are prefilled
        #: per step(), so a backlog of prompts waits for prefill slots
        #: instead of stalling every decode step behind it
        self.max_prefills_per_step = max_prefills_per_step
        self.device = params["embed"].device
        self.stats = BatcherStats(n_slots=n_slots)
        #: 0 = contiguous per-slot cache; > 0 = page pool of this page size
        self.page_size = page_size
        if page_size:
            if max_len % page_size:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of page_size {page_size}"
                )
            self.pages_per_slot = max_len // page_size
            page_bytes = paged_page_bytes(cfg, page_size, kv_cache_dtype)
            if page_pool and page_pool_bytes:
                raise ValueError("page_pool and page_pool_bytes are mutually exclusive")
            if page_pool_bytes:
                n_pool = pages_for_budget(page_pool_bytes, page_bytes)
            else:
                # the default never exhausts: every slot full plus one
                # copy-on-write page each
                n_pool = page_pool or n_slots * self.pages_per_slot + n_slots
            self._trash_page = n_pool
            self.manager = PagedCacheManager(
                n_pool, page_size, prefix_cache=prefix_cache, page_bytes=page_bytes
            )
            self.cache = model.init_paged_cache(
                n_pool + 1, page_size, self.device,
                quantized=kv_cache_dtype == "int8",
            )
            self.stats.kv_bytes_per_token = self.manager.kv_bytes_per_token
            self.stats.pool_pages = n_pool
        else:
            self.cache = model.init_cache(n_slots, max_len, self.device)

        # slot state (host side)
        self.slot_free = [True] * n_slots
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_tokens: list[list[int]] = [[] for _ in range(n_slots)]
        self.slot_pos = np.zeros((n_slots,), np.int64)  # next position to write
        self.slot_started = np.zeros((n_slots,), np.float64)
        self.cur_tokens = np.zeros((n_slots, 1), np.int64)
        self.queue: list[Request] = []
        self.completions: list[Completion] = []

    # -- public API ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @property
    def slots_busy(self) -> int:
        return sum(1 for f in self.slot_free if not f)

    def drain_completions(self) -> list[Completion]:
        out = self.completions
        self.completions = []
        return out

    def cancel(self, request_id: int) -> bool:
        """Abandon a request without a completion: dequeue it or free its
        slot.  Returns True if found."""
        for i, req in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[i]
                return True
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is not None and req.request_id == request_id:
                self._release_slot(slot)
                return True
        return False

    # -- slot lifecycle ----------------------------------------------------------

    def _prefill(self, slot: int, req: Request) -> int:
        """Prefill the prompt into the slot's cache rows, or, when paged,
        acquire its pages (reusing a resident shared prefix), prefill only
        the suffix and index the prompt's full pages for later sharers.
        Returns the first sampled token."""
        t0 = time.perf_counter()
        ptoks = req.prompt_tokens
        if self.page_size:
            match = self.manager.acquire(slot, ptoks)
            start = match.n_shared_tokens
            self.stats.prefix_pages_hit += match.n_shared_pages
            self.stats.prefix_tokens_saved += start
            tokens = torch.tensor([ptoks[start:]], device=self.device)
            pages = torch.tensor(match.page_ids, device=self.device)
            logits = self.model.prefill(
                self.params, tokens, self.cache, pages, start=start
            )
        else:
            tokens = torch.tensor([ptoks], device=self.device)
            logits = self.model.prefill(self.params, tokens, self.cache, slot)
        first = int(steps_lib.greedy_sample(logits, self.cfg.vocab_size)[0])
        if self.page_size:
            self.manager.register(slot, ptoks)
        self.stats.prefill_s += time.perf_counter() - t0
        return first

    def _page_gate(self) -> bool:
        """Admit the queue head only if the pool covers its prompt pages
        while keeping one page per busy slot for decode growth.  A prompt
        larger than the whole pool is admitted, so that ``acquire`` raises
        instead of the request waiting forever."""
        need = -(-len(self.queue[0].prompt_tokens) // self.page_size)
        if need >= self.manager.n_pages:
            return True
        reserve = self.slots_busy
        avail = self.manager.pages_free + self.manager.pages_cached
        return avail >= need + reserve

    def _refill(self) -> None:
        admitted = 0
        for slot in range(self.n_slots):
            if not self.slot_free[slot] or not self.queue:
                continue
            capped = (self.max_prefills_per_step
                      and admitted >= self.max_prefills_per_step)
            if capped or (self.page_size and not self._page_gate()):
                # each still-queued request that a free slot could have taken
                # this step is deferred once per step it actually waits
                free_left = sum(
                    1 for s in range(slot, self.n_slots) if self.slot_free[s]
                )
                self.stats.prefills_deferred += min(len(self.queue), free_left)
                break
            req = self.queue.pop(0)
            self.stats.admissions += 1
            first_tok = self._prefill(slot, req)
            admitted += 1
            self.slot_free[slot] = False
            self.slot_req[slot] = req
            self.slot_tokens[slot] = [first_tok]
            self.slot_pos[slot] = len(req.prompt_tokens)
            self.slot_started[slot] = time.monotonic()
            self.cur_tokens[slot, 0] = first_tok

    def _finish(self, slot: int, reason: str) -> None:
        req = self.slot_req[slot]
        self.completions.append(
            Completion(
                request_id=req.request_id,
                tokens=list(self.slot_tokens[slot]),
                prompt_len=len(req.prompt_tokens),
                finished_reason=reason,
                latency_s=time.monotonic() - self.slot_started[slot],
            )
        )
        self._release_slot(slot)
        self.stats.completions += 1

    def _release_slot(self, slot: int) -> None:
        """Free a slot and its pages; its position stays stale (see the
        module docstring)."""
        self.slot_free[slot] = True
        self.slot_req[slot] = None
        self.slot_tokens[slot] = []
        if self.page_size:
            self.manager.release(slot)

    def _preempt_victim(self, active: list[int]) -> None:
        """Preempt the busy slot with the fewest decoded tokens (lowest slot
        on a tie): release its pages and put its request back at the head
        of the queue, for a full recompute."""
        victim = min(active, key=lambda s: (len(self.slot_tokens[s]), s))
        self.stats.preemptions += 1
        self.stats.preempted_tokens += len(self.slot_tokens[victim])
        self.queue.insert(0, self.slot_req[victim])
        self._release_slot(victim)

    def _reap(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_free[slot]:
                continue
            toks = self.slot_tokens[slot]
            if toks and toks[-1] == self.eos_id:
                self._finish(slot, "eos")
            elif len(toks) >= self.slot_req[slot].max_new_tokens:
                self._finish(slot, "length")

    # -- the loop ------------------------------------------------------------------

    def _paged_step_tables(self, active: list[int]) -> PageTables:
        """The step's page tables and write targets: extends, or copies on
        write, the page holding each active slot's next position.  Free
        slots read an all-zero table and write to the trash page."""
        tables = np.zeros((self.n_slots, self.pages_per_slot), np.int32)
        write_pages = np.full((self.n_slots,), self._trash_page, np.int64)
        write_offsets = np.zeros((self.n_slots,), np.int64)
        for slot in active:
            pos = int(self.slot_pos[slot])
            if pos < self.max_len:
                pw = self.manager.ensure_position(slot, pos)
                if pw.cow_src is not None:
                    self.cache.copy_page(pw.cow_src, pw.page_id)
                    self.stats.cow_copies += 1
                write_pages[slot] = pw.page_id
                write_offsets[slot] = pw.offset
            table = self.manager.table(slot)
            tables[slot, : len(table)] = table
        return PageTables(
            *(torch.from_numpy(a).to(self.device)
              for a in (tables, write_pages, write_offsets))
        )

    def step(self) -> int:
        """One scheduler iteration; returns the number of active slots."""
        self._reap()
        self._refill()
        self._reap()
        active = [s for s in range(self.n_slots) if not self.slot_free[s]]
        if not active:
            return 0
        t0 = time.perf_counter()
        pages = None
        while self.page_size:
            # pool pressure preempts the cheapest victim and retries;
            # ensure_position is idempotent, so rebuilding is safe
            try:
                pages = self._paged_step_tables(active)
                break
            except PagePoolExhausted:
                self._preempt_victim(active)
                active = [s for s in range(self.n_slots) if not self.slot_free[s]]
                if not active:
                    return 0
        self.stats.steps += 1
        self.stats.active_slot_steps += len(active)
        self.stats.tokens_generated += len(active)
        tokens = torch.from_numpy(self.cur_tokens).to(self.device)
        positions = torch.from_numpy(self.slot_pos).to(self.device)
        logits = self.model.decode_step(
            self.params, tokens, self.cache, positions, pages
        )
        nxt = steps_lib.greedy_sample(logits, self.cfg.vocab_size).cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0
        for slot in active:
            self.slot_tokens[slot].append(int(nxt[slot]))
            self.slot_pos[slot] += 1
            self.cur_tokens[slot, 0] = int(nxt[slot])
        return len(active)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Completion]:
        for _ in range(max_steps):
            if not self.slots_busy and not self.queue:
                break
            self.step()
        # a slot still generating when max_steps runs out emits a
        # "truncated" completion rather than silently dropping its request
        self._reap()
        for slot in range(self.n_slots):
            if not self.slot_free[slot]:
                self._finish(slot, "truncated")
        return self.completions

