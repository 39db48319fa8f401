"""The port's storage, response cache and inference service against the JAX
package's:

* DeltaLite tables read both ways: each package reads (and appends to) a
  table the other wrote, rows, keys, versions and time travel equal;
* ``ResponseCache`` under each ``CachePolicy``: the same lookups, writes,
  ``CacheMiss`` refusals and stats as the reference's cache on the same
  table, and ``cache_key`` equal to the reference's;
* ``InferenceService`` on a stub slot engine: single-flight by key, a bad
  request failing only its own ticket, an engine crash reaching every
  waiting ticket, ``close`` joining the batcher thread;
* ``run_task`` through the service with repeated prompts, on the reduced
  qwen3-4b in both packages: the same engine calls and coalesced counts
  (stage-local single-flight), per task and in the service's counters;
* the response cache through ``run_task``: a second run replays every
  response with no engine call, ``REPLAY`` raises ``CacheMiss`` on a new
  prompt, and the port's ``"torch_local"`` entries never replay for the
  JAX engine.
"""

import threading

import pytest

from repro.core import EngineModelConfig as JaxModelConfig
from repro.core import EvalSession as JaxSession
from repro.core import EvalTask as JaxTask
from repro.core import InferenceConfig as JaxInference
from repro.core.cache import CacheEntry as JaxEntry
from repro.core.cache import CacheMiss as JaxCacheMiss
from repro.core.cache import ResponseCache as JaxCache
from repro.core.config import CachePolicy as JaxPolicy
from repro.core.config import cache_key as jax_cache_key
from repro.storage.deltalite import DeltaLite as JaxDeltaLite
from repro_torch.core import (
    CacheEntry,
    CacheMiss,
    CachePolicy,
    EngineModelConfig,
    EvalSession,
    EvalTask,
    InferenceConfig,
    InferenceRequest,
    InferenceResponse,
    InferenceService,
    ResponseCache,
    cache_key,
)
from repro_torch.storage import DeltaLite

# -- DeltaLite -----------------------------------------------------------------------


def _rows(lo, hi):
    return [{"prompt_hash": f"k{i:03d}", "v": i, "text": f"row {i}"} for i in range(lo, hi)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_deltalite_tables_read_both_ways(tmp_path, writer):
    mine, theirs = (DeltaLite, JaxDeltaLite) if writer == "port" else (JaxDeltaLite, DeltaLite)
    w = mine(str(tmp_path), key_column="prompt_hash")
    assert w.append(_rows(0, 5)) == 0
    assert w.append(_rows(5, 9)) == 1
    assert w.append_if_absent(_rows(3, 4)) is None
    r = theirs(str(tmp_path), key_column="prompt_hash")
    assert r.latest_version() == 1
    assert sorted(r.read(), key=lambda x: x["v"]) == _rows(0, 9)
    assert r.read(version=0) == _rows(0, 5)          # time travel
    assert r.keys() == {f"k{i:03d}" for i in range(9)}
    assert r.lookup("k007") == _rows(7, 8)[0] and r.lookup("nope") is None
    # the reader appends and compacts; the writer sees it
    assert r.append(_rows(9, 11)) == 2
    assert r.compact() == 3
    assert sorted(w.read(), key=lambda x: x["v"]) == _rows(0, 11)
    assert [h["version"] for h in w.history()] == [0, 1, 2, 3]


# -- ResponseCache --------------------------------------------------------------------


def test_cache_key_equals_the_reference():
    for args in (("q", "qwen3-4b", "torch_local", 0.0, 64),
                 ("a\x1fb", "m", "local", 0.7, 1), ("", "", "", 1e-9, 0)):
        assert cache_key(*args) == jax_cache_key(*args)
    assert cache_key("q", "m", "torch_local", 0.0, 8) != cache_key("q", "m", "local", 0.0, 8)


def _entries(cls, keys):
    return [cls(prompt_hash=k, model_name="m", provider="torch_local",
                prompt_text=f"p {k}", response_text=f"r {k}", input_tokens=3,
                output_tokens=5, latency_ms=1.5, created_at=1.0e9 + i)
            for i, k in enumerate(keys)]


def _exercise(cache_cls, entry_cls, miss_cls, path, policy):
    """Put two entries, look up both and a third; return what happened."""
    cache = cache_cls(path, policy)
    out = {"writes": cache.put(_entries(entry_cls, ["a", "b"]))}
    looked = []
    for key in ("a", "b", "c"):
        try:
            hit = cache.lookup(key)
            looked.append(None if hit is None else hit.to_row())
        except miss_cls:
            looked.append("miss")
    out["lookups"] = looked
    out["stats"] = cache.stats()
    return out


@pytest.mark.parametrize("policy", [p.value for p in CachePolicy])
def test_cache_policies_equal_the_reference(tmp_path, policy):
    """Each policy on a fresh table, then on a table that holds ``a``."""
    for seeded in (False, True):
        dirs = tmp_path / f"port-{seeded}", tmp_path / f"ref-{seeded}"
        if seeded:
            for d in dirs:
                JaxCache(str(d), JaxPolicy.ENABLED).put(_entries(JaxEntry, ["a"]))
        got = _exercise(ResponseCache, CacheEntry, CacheMiss, str(dirs[0]),
                        CachePolicy(policy))
        want = _exercise(JaxCache, JaxEntry, JaxCacheMiss, str(dirs[1]),
                         JaxPolicy(policy))
        assert got == want, (policy, seeded)


def test_cache_entries_written_by_either_package_replay(tmp_path):
    ResponseCache(str(tmp_path), CachePolicy.ENABLED).put(_entries(CacheEntry, ["x"]))
    hit = JaxCache(str(tmp_path), JaxPolicy.REPLAY).lookup("x")
    assert hit.to_row() == _entries(CacheEntry, ["x"])[0].to_row()
    JaxCache(str(tmp_path), JaxPolicy.ENABLED).put(_entries(JaxEntry, ["y"]))
    assert ResponseCache(str(tmp_path), CachePolicy.REPLAY).lookup("y").response_text == "r y"
    with pytest.raises(CacheMiss, match="replay mode"):
        ResponseCache(str(tmp_path), CachePolicy.REPLAY).lookup("z")


# -- InferenceService on a stub slot engine ------------------------------------------


class _StubEngine:
    """A slot engine that answers each prompt upper-cased after ``steps``
    pumps; ``bad`` prompts raise ValueError at submit, ``crash`` raises
    RuntimeError at the next pump."""

    supports_streaming = True

    def __init__(self, steps=2):
        self.steps, self.next_id, self.live, self.submits = steps, 0, {}, 0
        self.lock = threading.Lock()

    def stream_submit(self, req):
        if req.prompt == "bad":
            raise ValueError("bad request")
        with self.lock:
            self.submits += 1
            rid, self.next_id = self.next_id, self.next_id + 1
            self.live[rid] = [req.prompt, self.steps]
        return rid

    def stream_pump(self):
        done = []
        with self.lock:
            for rid, item in list(self.live.items()):
                if item[0] == "crash":
                    raise RuntimeError("engine crashed")
                item[1] -= 1
                if item[1] <= 0:
                    del self.live[rid]
                    done.append((rid, InferenceResponse(item[0].upper(), 1, 1, 0.0)))
        return done

    def stream_pending(self):
        return bool(self.live)

    def serving_stats(self):
        return {"steps": 0}


def test_service_coalesces_identical_keys_and_serves_each_ticket():
    engine = _StubEngine()
    with InferenceService(engine, max_batch_wait_ms=0.0, name="stub") as svc:
        svc.attach()
        tickets = [svc.submit(InferenceRequest(p), key=p) for p in "abcab"]
        lone = svc.submit(InferenceRequest("a"))  # no key: never coalesced
        got = [t.result(5.0).text for t in tickets]
        assert got == ["A", "B", "C", "A", "B"] and lone.result(5.0).text == "A"
        assert [t.primary for t in tickets] == [True, True, True, False, False]
        svc.note_coalesced(2)
        snap = svc.snapshot()
        svc.detach()
    assert (snap["submitted"], snap["coalesced"], snap["dispatched"]) == (8, 4, 4)
    assert engine.submits == 4 and snap["batcher"] == {"steps": 0}


def test_bad_request_fails_only_its_ticket_and_a_crash_reaches_every_ticket():
    engine = _StubEngine(steps=10**9)  # nothing finishes before the crash
    svc = InferenceService(engine, max_batch_wait_ms=0.0)
    bad = svc.submit(InferenceRequest("bad"), key="bad")
    ok = svc.submit(InferenceRequest("fine"), key="fine")
    with pytest.raises(ValueError, match="bad request"):
        bad.result(5.0)
    held = [svc.submit(InferenceRequest(p), key=p) for p in ("x", "y")]
    crash = svc.submit(InferenceRequest("crash"), key="crash")
    for t in (ok, *held, crash):
        with pytest.raises(RuntimeError, match="engine crashed"):
            t.result(5.0)
    with pytest.raises(RuntimeError, match="dispatch failed"):
        svc.submit(InferenceRequest("later"))
    svc.close()
    assert not svc._thread.is_alive()


def test_close_serves_queued_work_then_joins():
    engine = _StubEngine(steps=3)
    svc = InferenceService(engine, max_batch_wait_ms=1.0)
    tickets = [svc.submit(InferenceRequest(str(i)), key=str(i)) for i in range(20)]
    svc.close()
    assert [t.result(0.0).text for t in tickets] == [str(i) for i in range(20)]
    assert not svc._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(InferenceRequest("late"))


# -- run_task through the service and the cache, on the reduced qwen3-4b ------------

MAX_TOKENS, N_SLOTS, MAX_LEN = 6, 4, 64


def _dup_rows(n_rows, n_distinct):
    """``n_rows`` QA rows cycling over ``n_distinct`` questions."""
    from repro_torch.data import iter_qa_examples

    base = list(iter_qa_examples(n_distinct, seed=3))
    return [dict(base[i % n_distinct]) for i in range(n_rows)]


def _port_task(**inference):
    return EvalTask(
        task_id="dups",
        model=EngineModelConfig(model_name="qwen3-4b", reduced=True, seed=0,
                                max_tokens=MAX_TOKENS),
        inference=InferenceConfig(**inference),
    )


def _jax_task(**inference):
    return JaxTask(
        task_id="dups",
        model=JaxModelConfig(provider="local", model_name="qwen3-4b", reduced=True,
                             seed=0, max_tokens=MAX_TOKENS),
        inference=JaxInference(n_workers=2, **inference),
    )


def _port_session():
    return EvalSession(device="cpu",
                       engine_kwargs={"n_slots": N_SLOTS, "max_len": MAX_LEN})


@pytest.mark.parametrize("n_rows,n_distinct,batch_size", [(32, 8, 16), (20, 7, 3)])
def test_single_flight_counts_equal_the_reference(n_rows, n_distinct, batch_size):
    rows = _dup_rows(n_rows, n_distinct)
    with JaxSession(engine_kwargs={"n_slots": N_SLOTS, "max_len": MAX_LEN}) as s:
        jres = s.run_task(rows, _jax_task(batch_size=batch_size))
        (jsvc,) = s.serving_stats()
        jacct = s.accounting.as_dict()
    with _port_session() as s:
        pres = s.run_task(rows, _port_task(batch_size=batch_size))
        (psvc,) = s.serving_stats()
        pacct = s.accounting.as_dict()
    want = {"calls": n_distinct, "total_cost": 0.0,
            "coalesced": n_rows - n_distinct, "pool": {}}
    assert pres.engine_stats == jres.engine_stats == want
    for key in ("submitted", "dispatched", "coalesced", "completed", "errors"):
        assert psvc[key] == jsvc[key], key
    for key in ("tasks", "engine_calls", "coalesced_requests", "cache_hits",
                "cache_misses"):
        assert pacct[key] == jacct[key], key
    assert pres.cache_stats == jres.cache_stats == {}
    assert len(set(pres.responses)) <= n_distinct
    assert pres.failures == jres.failures == []


def test_cache_replays_responses_with_no_engine_call(tmp_path):
    rows = _dup_rows(12, 12)
    cache_dir = str(tmp_path / "cache")
    with _port_session() as s:
        first = s.run_task(rows, _port_task(cache_dir=cache_dir))
        second = s.run_task(rows, _port_task(cache_dir=cache_dir))
        replay = s.run_task(rows, _port_task(cache_dir=cache_dir,
                                             cache_policy=CachePolicy.REPLAY))
        with pytest.raises(CacheMiss):
            s.run_task(rows + [{"question": "a new question?", "reference": "x"}],
                       _port_task(cache_dir=cache_dir, cache_policy=CachePolicy.REPLAY))
        (svc,) = s.serving_stats()
    assert first.engine_stats["calls"] == 12 and first.cache_stats["writes"] == 12
    assert first.cache_stats["misses"] == 12 and first.cache_stats["hits"] == 0
    for res in (second, replay):
        assert res.engine_stats["calls"] == 0
        assert (res.cache_stats["hits"], res.cache_stats["misses"]) == (12, 0)
        assert res.responses == first.responses
        for name, mv in first.metrics.items():
            assert (res.metrics[name].value, res.metrics[name].ci) == (mv.value, mv.ci)
    assert svc["dispatched"] == 12
    # the port's entries carry provider "torch_local": the JAX engine's
    # "local" keys never find them
    with JaxSession() as s, pytest.raises(JaxCacheMiss):
        s.run_task(rows, _jax_task(cache_dir=cache_dir, cache_policy=JaxPolicy.REPLAY))


def test_streaming_cache_stats_sum_the_chunks(tmp_path):
    rows = _dup_rows(10, 10)
    task = _port_task(cache_dir=str(tmp_path)).with_streaming(max_memory_rows=4)
    with _port_session() as s:
        a = s.run_task(rows, task)
        b = s.run_task(rows, task)
    assert a.engine_stats["calls"] == 10 and b.engine_stats["calls"] == 0
    assert (a.cache_stats["misses"], a.cache_stats["writes"]) == (10, 10)
    assert (b.cache_stats["hits"], b.cache_stats["hit_rate"]) == (10, 1.0)
    assert a.cache_stats["entries"] == b.cache_stats["entries"] == 10
    assert a.metrics["exact_match"].value == b.metrics["exact_match"].value
