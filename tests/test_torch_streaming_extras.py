"""The port's streaming extras against the JAX package's, on the CPU, over
the simulated API engine (deterministic per prompt in both packages):

* the configuration: ``with_streaming(concurrency=...)`` (a fault of the
  port's suite, repaired here), ``with_stopping``, the task JSON equal to
  the reference's for a shared provider, and the replica fields accepted
  as the reference accepts them;
* the serialized state of the accumulators and bootstrap engines, bit for
  bit the reference's, with the merge laws driven by hypothesis;
* spill, crash and resume: the resumed run equals an uninterrupted port
  run and the JAX run, and runs only the chunks that had not run; a
  manifest written by either package resumes in the other; the refusals
  (changed or shrunk source, changed rule, mixed regimes, partials of
  another weight stream) raise the reference's ``ManifestMismatch``;
* concurrent chunks: windows 2 and 3 equal the serial run (and the JAX
  executor) in metrics, streaming state, failures, engine and cache stats;
  the resident rows stay under window x chunk; racing commits resolve
  first-committer-wins; a concurrent crash resumes bit for bit;
* the kernel wrappers' launch counts lose no increment under threads.

``backend="pallas"`` runs the port's device engine on its ``device-ref``
stream against the JAX engine's ``pallas-ref``: the same weights, f32
partials summed in another order, so the values are equal and the
intervals agree to 1e-5 (``tests/test_torch_suite.py``)."""

import dataclasses
import hashlib
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.core as R
import repro.core.streaming as RJ
import repro.ft as RF
import repro.stats as RS
import repro_torch.core as P
import repro_torch.core.streaming as PJ
import repro_torch.ft as PF
import repro_torch.stats as PS
from repro.data import iter_qa_examples as jax_rows
from repro_torch.data import iter_qa_examples as port_rows
from repro_torch.data import qa_examples
from repro_torch.ft.workers import WorkerPool
from repro_torch.storage.spill import ChunkManifest

ROOT = Path(__file__).resolve().parents[1]
N, CHUNK = 200, 50  # four chunks


def _model(mod, name="gpt-4o-mini"):
    return mod.EngineModelConfig(provider="openai", model_name=name)


def _task(mod, task_id="stream", backend="numpy", ci_method="percentile",
          cache_dir="", **stream_kw):
    return mod.EvalTask(
        task_id, model=_model(mod),
        inference=mod.InferenceConfig(batch_size=16, n_workers=3, cache_dir=cache_dir),
        metrics=(mod.MetricConfig("exact_match"), mod.MetricConfig("token_f1")),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200,
                                        ci_method=ci_method, backend=backend),
    ).with_streaming(**stream_kw)


def _session(mod, **kw):
    return mod.EvalSession(**({"device": "cpu"} if mod is P else {}), **kw)


def _rows(mod, n=N, seed=8):
    return (port_rows if mod is P else jax_rows)(n, seed=seed)


def _ft(mod):
    return PF if mod is P else RF


def _state(res):
    """A result's metrics and streaming state, for bit-for-bit equality."""
    ss = res.stream_stats
    eng = ss.engine
    return (
        {k: (v.value, v.ci, v.ci_method, v.n, v.n_unscored) for k, v in res.metrics.items()},
        {k: (a.n, a.total, a.total_sq, a.n_nan) for k, a in ss.accs.items()},
        None if eng is None else (eng.sum_wx.tobytes(), eng.sum_w.tobytes()),
        ss.chunk_size, ss.n_examples,
    )


def _stats(res):
    """Failures, engine stats and the cache's counters (its ``entries`` and
    ``version`` are the table's at the last chunk's commit, which in a
    concurrent run depends on which chunk wrote last)."""
    counters = {k: v for k, v in res.cache_stats.items()
                if k in ("hits", "misses", "writes", "hit_rate")}
    return res.failures, res.engine_stats, counters


def _close(port, jax, backend):
    """The port's result against the JAX package's: bit for bit on the
    host stream, the device-ref stream's tolerance otherwise."""
    if backend == "numpy":
        assert _state(port) == _state(jax)
        return
    np.testing.assert_array_equal(port.stream_stats.engine.sum_w,
                                  jax.stream_stats.engine.sum_w)
    for name, j in jax.metrics.items():
        p = port.metrics[name]
        assert (p.value, p.n) == (j.value, j.n)
        np.testing.assert_allclose(p.ci, j.ci, rtol=0, atol=1e-5)


@pytest.fixture
def prompts_seen(monkeypatch):
    """The prompts each package's simulated engine answered."""
    seen = {P: [], R: []}
    for mod in (P, R):
        infer = mod.SimulatedAPIEngine.infer

        def wrapped(self, request, _infer=infer, _log=seen[mod]):
            _log.append(request.prompt)
            return _infer(self, request)

        monkeypatch.setattr(mod.SimulatedAPIEngine, "infer", wrapped)
    return seen


@pytest.fixture
def bad_prompts(monkeypatch):
    """Every prompt whose hash is 1 mod 7 comes back as an engine error
    in both packages."""
    for mod in (P, R):
        infer = mod.SimulatedAPIEngine.infer

        def wrapped(self, request, _infer=infer):
            resp = _infer(self, request)
            if int(hashlib.sha256(request.prompt.encode()).hexdigest()[:6], 16) % 7 == 1:
                return dataclasses.replace(resp, text="", error="provider error: bad row")
            return resp

        monkeypatch.setattr(mod.SimulatedAPIEngine, "infer", wrapped)


# -- configuration ------------------------------------------------------------------


def test_suite_with_streaming_concurrency_alias():
    """``EvalSuite.with_streaming(concurrency=2)`` as its docstring says:
    every task runs two chunks in flight, with the reference's task JSON."""
    tasks = []
    for mod in (P, R):
        suite = (mod.EvalSuite("alias")
                 .add_task(mod.EvalTask("t", model=_model(mod)), lambda: iter([]))
                 .with_streaming(concurrency=2))
        tasks.append(suite._tasks[0][0])
    port, jax = tasks
    assert port.streaming.enabled and port.streaming.max_inflight_chunks == 2
    assert port.to_json() == jax.to_json()
    assert _task(P).with_streaming(concurrency=3).streaming == \
        _task(P).with_streaming(max_inflight_chunks=3).streaming


@pytest.mark.parametrize("build", [
    lambda mod: mod.EvalTask("t", model=_model(mod)),
    lambda mod: _task(mod, max_memory_rows=64, spill_dir="/spill", concurrency=4,
                      max_examples=512, resume=False),
    lambda mod: _task(mod).with_stopping(target_half_width=0.02, min_examples=64,
                                         metric="token_f1", method="mixture"),
    lambda mod: mod.EvalTask("t", model=_model(mod, "claude-3-haiku"), data=mod.DataConfig(
        prompt_template="Q: {question}\nA:", input_columns=("question", "context"),
        reference_column="answer")),
    lambda mod: _task(mod, backend="pallas", cache_dir="/cache").with_stopping(),
], ids=["default", "streaming", "stopping", "data", "pallas"])
def test_task_json_equals_the_reference(build):
    port, jax = build(P), build(R)
    assert port.to_json() == jax.to_json()
    assert port.fingerprint() == jax.fingerprint()
    assert PJ._run_key(port) == RJ._run_key(jax)
    assert port.stopping.fingerprint() == jax.stopping.fingerprint()


def test_default_task_differs_from_the_reference_only_in_provider():
    port = json.loads(P.EvalTask("t").to_json())
    jax = json.loads(R.EvalTask("t").to_json())
    assert (port["model"].pop("provider"), jax["model"].pop("provider")) == \
        ("torch_local", "local")
    assert port == jax


@pytest.mark.parametrize("name,value", [
    ("n_replicas", 2), ("routing", "prefix_affinity"), ("routing_prefix_len", 32),
    ("request_deadline_s", 1.5), ("max_replica_restarts", 0),
    ("restart_backoff_s", 0.5), ("health_probe_steps", 4),
])
def test_non_default_replica_field_raises(name, value):
    """A non-default replica field is accepted as the reference accepts it:
    ``dataclasses.replace`` keeps it, and the task's JSON carries it and
    equals the reference's.  The name is kept so that the test ids of the
    tree that refused these values still pass."""
    default = getattr(P.InferenceConfig(), name)
    assert default == getattr(R.InferenceConfig(), name)
    assert P.InferenceConfig(**{name: default}) == P.InferenceConfig()
    port = P.InferenceConfig(**{name: value})
    assert getattr(port, name) == value and port != P.InferenceConfig()
    assert dataclasses.replace(P.InferenceConfig(), **{name: value}) == port
    tasks = [mod.EvalTask("t", model=_model(mod),
                          inference=mod.InferenceConfig(**{name: value}))
             for mod in (P, R)]
    assert json.loads(tasks[0].to_json())["inference"][name] == value
    assert tasks[0].to_json() == tasks[1].to_json()


# -- serialized state ------------------------------------------------------------------


def test_accumulator_and_bootstrap_state_equal_the_reference():
    rng = np.random.default_rng(0)
    scores = rng.random(300)
    scores[::17] = np.nan
    out = {}
    for mod in (PS, RS):
        acc, boot = mod.MetricAccumulator(), mod.PoissonBootstrap(100, seed=7)
        for lo in range(0, 300, 64):
            part = mod.MetricAccumulator()
            part.update(scores[lo:lo + 64])
            acc.merge(mod.MetricAccumulator.from_state(json.loads(json.dumps(part.state()))))
            b = mod.PoissonBootstrap(100, seed=7)
            b.update(scores[lo:lo + 64], lo)
            boot.merge(mod.PoissonBootstrap.from_state(json.loads(json.dumps(b.state()))))
        out[mod] = (acc.state(), boot.state())
        with pytest.raises(ValueError, match="cannot merge"):
            boot.merge(mod.PoissonBootstrap(100, seed=8))
    assert out[PS] == out[RS]


def _engine_case(mod, backend, **kw):
    rng = np.random.default_rng(2)
    eng = mod.make_bootstrap_engine(backend, 64, 1, ("a", "b"), **kw)
    for lo in (0, 40, 80):
        part = eng.spawn()
        part.update({"a": rng.random(40), "b": (rng.random(40) < 0.5).astype(float)}, lo)
        eng.merge_state(json.loads(json.dumps(part.state())))
    return eng


def test_engine_state_round_trip_and_guards_equal_the_reference():
    port, jax = _engine_case(PS, "numpy"), _engine_case(RS, "numpy")
    assert port.state() == jax.state()
    clone = PS.bootstrap_engine_from_state(jax.state())
    np.testing.assert_array_equal(clone.sum_wx, jax.sum_wx)
    np.testing.assert_array_equal(clone.sum_w, jax.sum_w)
    for other in (PS.make_bootstrap_engine("numpy", 64, 2, ("a", "b")),
                  PS.make_bootstrap_engine("numpy", 64, 1, ("a",)),
                  PS.make_bootstrap_engine("device", 64, 1, ("a", "b"), device="cpu")):
        with pytest.raises(ValueError, match="cannot merge"):
            port.merge(other)
        with pytest.raises(ValueError, match="cannot merge"):
            port.merge_state(other.state())


def test_device_engine_state_carries_its_stream_and_refuses_another():
    eng = _engine_case(PS, "device", device="cpu")
    state = eng.state()
    assert (state["backend"], state["stream"]) == ("device", "device-ref")
    clone = PS.bootstrap_engine_from_state(state, device="cpu")
    np.testing.assert_array_equal(clone.sum_wx, eng.sum_wx)
    state["stream"] = "device-kernel"  # as if written on the card
    with pytest.raises(ValueError, match="cannot merge"):
        eng.merge_state(state)
    # the device engine's partials are f32 sums kept in f64: exact in JSON
    assert json.loads(json.dumps(eng.state()))["sum_wx"] == eng.sum_wx.tolist()


_SCORE = st.one_of(st.floats(min_value=0.0, max_value=1.0, allow_nan=False),
                   st.just(float("nan")))
_PARTS = st.lists(st.lists(_SCORE, min_size=0, max_size=30), min_size=1, max_size=6)


def _merge_in(mod, parts, order):
    """Per-part accumulator and bootstrap states through JSON, merged in
    ``order``."""
    starts = np.cumsum([0] + [len(p) for p in parts])
    acc = mod.MetricAccumulator()
    eng = mod.make_bootstrap_engine("numpy", 32, 3, ("m",))
    for j in order:
        x = np.asarray(parts[j], np.float64)
        a = mod.MetricAccumulator()
        a.update(x)
        acc.merge(mod.MetricAccumulator.from_state(json.loads(json.dumps(a.state()))))
        e = eng.spawn()
        e.update({"m": x}, int(starts[j]))
        eng.merge_state(json.loads(json.dumps(e.state())))
    return acc, eng


@settings(max_examples=30, deadline=None)
@given(parts=_PARTS, perm_seed=st.integers(0, 2**31 - 1))
def test_prop_state_round_trip_merge_laws(parts, perm_seed):
    order = list(np.random.default_rng(perm_seed).permutation(len(parts)))
    acc, eng = _merge_in(PS, parts, order)
    jacc, jeng = _merge_in(RS, parts, order)
    # the same merge order: the reference's state bit for bit
    assert acc.state() == jacc.state()
    np.testing.assert_array_equal(eng.sum_wx, jeng.sum_wx)
    np.testing.assert_array_equal(eng.sum_w, jeng.sum_w)
    # any order: the single pass, up to float re-association
    one, one_eng = _merge_in(PS, parts, range(len(parts)))
    assert (acc.n, acc.n_nan) == (one.n, one.n_nan)
    assert acc.total == pytest.approx(one.total, rel=1e-9, abs=1e-9)
    assert acc.total_sq == pytest.approx(one.total_sq, rel=1e-9, abs=1e-9)
    np.testing.assert_allclose(eng.sum_wx, one_eng.sum_wx, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(eng.sum_w, one_eng.sum_w)  # integer weights


# -- spill, crash and resume -----------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_crash_resume_equals_an_uninterrupted_run_and_the_reference(
        tmp_path, prompts_seen, backend):
    out = {}
    for mod in (P, R):
        ft = _ft(mod)
        task = _task(mod, backend=backend, max_memory_rows=CHUNK,
                     spill_dir=str(tmp_path / mod.__name__ / "spill"))
        ref_task = task.with_streaming(spill_dir=str(tmp_path / mod.__name__ / "ref"))
        with _session(mod) as s:
            ref = s.run_task(_rows(mod), ref_task)
        crash = ft.ChunkCrashMiddleware([ft.Fault(shard=1, attempt=1)])
        with _session(mod, middleware=[crash]) as s:
            with pytest.raises(ft.SimulatedCrash):
                s.run_task(_rows(mod), task)
            assert s.accounting.engine_calls == 2 * CHUNK
        assert crash.injected == [(1, 1, "raise")]
        prompts_seen[mod].clear()
        with _session(mod) as s:
            res = s.run_task(_rows(mod), task)
            assert s.accounting.engine_calls == N - 2 * CHUNK
        log = res.logs["streaming"]
        assert (log["n_resumed_chunks"], log["n_chunks"], log["n_examples"]) == (2, 4, N)
        assert _state(res) == _state(ref) and _stats(res) == _stats(ref)
        # only the chunks that had not run reached the engine
        want = [r["question"] for r in list(_rows(mod))[2 * CHUNK:]]
        assert sorted(prompts_seen[mod]) == sorted(want)
        with _session(mod) as s:
            again = s.run_task(_rows(mod), task)
            assert s.accounting.engine_calls == 0
        assert again.logs["streaming"]["n_resumed_chunks"] == 4
        assert _state(again) == _state(ref)
        out[mod] = res
    _close(out[P], out[R], backend)
    assert out[P].engine_stats == out[R].engine_stats
    stream = out[P].logs["streaming"]
    assert stream["stats_stream"] == ("numpy" if backend == "numpy" else "device-ref")
    assert stream["spill_dir"].endswith("spill") and stream["n_failures"] == 0


@pytest.mark.parametrize("writer", [R, P], ids=["jax-writes", "port-writes"])
def test_a_manifest_of_one_package_resumes_in_the_other(tmp_path, writer):
    reader = P if writer is R else R
    spill = str(tmp_path / "shared")
    tasks = {mod: _task(mod, max_memory_rows=CHUNK, spill_dir=spill) for mod in (P, R)}
    assert PJ._run_key(tasks[P]) == RJ._run_key(tasks[R])
    with _session(writer) as s:
        ref = s.run_task(_rows(writer), tasks[writer].with_streaming(
            spill_dir=str(tmp_path / "ref")))
    ft = _ft(writer)
    with _session(writer, middleware=[ft.ChunkCrashMiddleware([ft.Fault(1, 1)])]) as s:
        with pytest.raises(ft.SimulatedCrash):
            s.run_task(_rows(writer), tasks[writer])
    with _session(reader) as s:
        res = s.run_task(_rows(reader), tasks[reader])
        assert s.accounting.engine_calls == N - 2 * CHUNK
    assert res.logs["streaming"]["n_resumed_chunks"] == 2
    assert _state(res) == _state(ref)
    assert res.engine_stats == ref.engine_stats and res.failures == ref.failures
    # and the run finished by the reader replays in the writer for free
    with _session(writer) as s:
        again = s.run_task(_rows(writer), tasks[writer])
        assert s.accounting.engine_calls == 0
    assert _state(again) == _state(ref)


RULE = dict(min_examples=100, max_examples=150)


@pytest.mark.parametrize("case,first,second,second_task,match", [
    ("digest", (N, 8), (N, 99), None, "was the data source changed"),
    ("layout", (N, 8), (180, 8), None, "observed start=150 n_rows=30"),
    ("shrunk", (N, 8), (150, 8), None, "beyond the end"),
    ("rule", (400, 5), (400, 5), "retune", "clear the spill dir"),
    ("adaptive-over-exhaustive", (N, 6), (N, 6), "adaptive", "without adaptive"),
    ("exhaustive-over-adaptive", (400, 6), (400, 6), "plain", "mix stopping regimes"),
])
def test_refusals_raise_the_references_manifest_mismatch(
        tmp_path, case, first, second, second_task, match):
    change = {
        None: None,
        "retune": lambda t: t.with_stopping(max_examples=250),
        "adaptive": lambda t: t.with_stopping(**RULE),
        "plain": lambda t: dataclasses.replace(t, stopping=type(t.stopping)()),
    }[second_task]
    msgs = {}
    for mod in (P, R):
        first_task = (lambda t: t.with_stopping(**RULE)) if case in (
            "rule", "exhaustive-over-adaptive") else None
        task = _task(mod, max_memory_rows=CHUNK, spill_dir=str(tmp_path / mod.__name__))
        if first_task:
            task = first_task(task)
        with _session(mod) as s:
            s.run_task(_rows(mod, *first), task)
        with _session(mod) as s:
            with pytest.raises(mod.ManifestMismatch, match=match) as e:
                s.run_task(_rows(mod, *second), change(task) if change else task)
        msgs[mod] = str(e.value)
    assert msgs[P] == msgs[R]


def test_partials_of_another_stream_refuse_to_resume(tmp_path):
    """A manifest whose bootstrap rows were written on the card
    (``device-kernel``) refuses to resume on the CPU (``device-ref``)."""
    task = _task(P, backend="device", max_memory_rows=CHUNK,
                 spill_dir=str(tmp_path / "written"))
    with _session(P) as s:
        s.run_task(_rows(P), task)
    key = PJ._run_key(task)
    rows = ChunkManifest(str(tmp_path / "written"), key).completed()
    crafted = ChunkManifest(str(tmp_path / "crafted"), key)
    for ci, row in sorted(rows.items()):
        state = {k: v for k, v in row.items() if k not in ("chunk_id", "run_key")}
        state["boot"] = {**state["boot"], "stream": "device-kernel"}
        crafted.record(ci, state)
    with _session(P) as s:
        with pytest.raises(P.ManifestMismatch, match="not mergeable") as e:
            s.run_task(_rows(P), task.with_streaming(spill_dir=str(tmp_path / "crafted")))
        assert s.accounting.engine_calls == 0
    assert "device-kernel" in str(e.value) and "device-ref" in str(e.value)


def test_resume_disabled_reruns_and_knobs_stay_out_of_the_key(tmp_path):
    task = _task(P, max_memory_rows=100, spill_dir=str(tmp_path / "s"), resume=False)
    with _session(P) as s:
        s.run_task(_rows(P), task)
    with _session(P) as s:
        res = s.run_task(_rows(P), task)
        assert s.accounting.engine_calls == N
    assert res.logs["streaming"]["n_resumed_chunks"] == 0
    retuned = dataclasses.replace(
        task.with_streaming(resume=True, concurrency=3, max_examples=10**6),
        inference=P.InferenceConfig(batch_size=8, n_workers=2, cache_dir=""))
    with _session(P) as s:
        res = s.run_task(_rows(P), retuned)
        assert s.accounting.engine_calls == 0
    assert res.logs["streaming"]["n_resumed_chunks"] == 2


# -- concurrent chunks -------------------------------------------------------------------


@pytest.mark.parametrize("window", [2, 3])
def test_concurrent_windows_equal_serial_and_the_reference(tmp_path, bad_prompts, window):
    rows = qa_examples(240, seed=21)
    results = {}
    for mod in (P, R):
        for label, kw in (("serial", {}), ("conc", {"concurrency": window})):
            task = _task(mod, max_memory_rows=48,
                         cache_dir=str(tmp_path / f"{mod.__name__}-{label}"), **kw)
            with _session(mod) as s:
                results[mod, label] = s.run_task(iter([dict(r) for r in rows]), task)
    serial, conc = results[P, "serial"], results[P, "conc"]
    assert _state(conc) == _state(serial) == _state(results[R, "conc"])
    assert _stats(conc) == _stats(serial) == _stats(results[R, "conc"])
    assert conc.failures and conc.cache_stats["misses"] == 240
    log = conc.logs["streaming"]
    jlog = results[R, "conc"].logs["streaming"]
    assert log["max_inflight_chunks"] == window and log["n_chunks"] == 5
    assert log["max_resident_rows"] <= window * 48
    assert log["chunk_pool"] == jlog["chunk_pool"]
    assert log["chunk_pool"]["shards"] == 5 and log["chunk_pool"]["failures"] == 0
    assert log["n_failures"] == serial.logs["streaming"]["n_failures"] == len(conc.failures)
    assert conc.responses == [] and conc.scores == {}


def test_concurrency_knob_stays_out_of_the_resume_key():
    task = _task(P, max_memory_rows=64)
    assert PJ._run_key(task) == PJ._run_key(task.with_streaming(concurrency=8))
    assert PJ._run_key(task) != PJ._run_key(task.with_streaming(max_memory_rows=32))


def test_window_bounds_resident_rows():
    with _session(P) as s:
        res = s.run_task(_rows(P, 200, seed=4), _task(P, max_memory_rows=20, concurrency=3))
    log = res.logs["streaming"]
    assert log["n_examples"] == 200 and log["max_resident_rows"] <= 3 * 20


def test_manifest_concurrent_commit_stress(tmp_path):
    """Threads racing ``try_record`` over interleaved chunk ids: each chunk
    is committed exactly once and losers leave no segment behind."""
    man = ChunkManifest(str(tmp_path / "spill"), "stress-run")
    n_threads, n_chunks = 6, 30
    barrier = threading.Barrier(n_threads)
    wins = [0] * n_threads
    errors = []

    def worker(t: int) -> None:
        barrier.wait()
        try:
            for k in range(n_chunks):
                ci = (k + t * 5) % n_chunks
                if man.try_record(ci, {"start": ci, "n_rows": 1, "by": t}):
                    wins[t] += 1
        except Exception as e:  # pragma: no cover — the assertion target
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert errors == [] and sum(wins) == n_chunks
    rows = man.table.read()
    assert sorted(int(r["chunk_id"]) for r in rows) == list(range(n_chunks))
    assert set(man.completed()) == set(range(n_chunks))
    committed = {s["file"] for s in man.table._live_segments()}
    assert set(os.listdir(os.path.join(man.path, "data"))) == committed


def test_speculative_chunk_reissue_first_committer_wins(tmp_path):
    man = ChunkManifest(str(tmp_path / "spill"), "spec-run")
    pool = WorkerPool(n_workers=4, straggler_factor=2.0, straggler_min_s=0.05,
                      poll_s=0.005)
    attempts: dict[int, int] = {}
    lock = threading.Lock()

    def fn(i: int, item: int, worker: int):
        with lock:
            attempts[i] = attempts.get(i, 0) + 1
            attempt = attempts[i]
        if i == 2 and attempt == 1:
            time.sleep(0.4)  # a straggler on its first attempt only
        return man.try_record(i, {"start": item, "n_rows": 1, "attempt": attempt}), attempt

    results = list(pool.imap_windowed(fn, iter(range(6)), window=4))
    assert sorted(r.index for r in results) == list(range(6))
    assert pool.stats.speculative_launches >= 1 and attempts[2] == 2
    assert len(man.table.read()) == 6
    assert all(r.value[0] for r in results)  # every yielded result committed


def test_concurrent_crash_resume_is_bit_identical(tmp_path):
    n, chunk = 300, 50
    task = _task(P, max_memory_rows=chunk, concurrency=2, spill_dir=str(tmp_path / "s"))
    with _session(P) as s:
        ref = s.run_task(_rows(P, n), task.with_streaming(spill_dir=str(tmp_path / "ref")))
    with _session(P) as s:
        serial = s.run_task(_rows(P, n), task.with_streaming(
            concurrency=1, spill_dir=str(tmp_path / "serial")))
    with R.EvalSession() as s:
        jax = s.run_task(_rows(R, n), _task(R, max_memory_rows=chunk, concurrency=2))
    crash = PF.ChunkCrashMiddleware([PF.Fault(shard=2, attempt=1)])
    with _session(P, middleware=[crash]) as s:
        with pytest.raises(PF.SimulatedCrash):
            s.run_task(_rows(P, n), task)
        first = s.accounting.engine_calls
    with _session(P) as s:
        res = s.run_task(_rows(P, n), task)
        resumed = s.accounting.engine_calls
    # chunks in flight at the crash drained their commits: every chunk ran once
    assert first + resumed == n
    assert res.logs["streaming"]["n_resumed_chunks"] >= 3
    assert _state(res) == _state(ref) == _state(serial) == _state(jax)


def test_suite_with_streaming_concurrency_runs_concurrently():
    suite = (P.EvalSuite("conc-suite")
             .add_task(_task(P, "s1"), lambda: port_rows(120, seed=12))
             .with_streaming(max_memory_rows=30, concurrency=3))
    with _session(P) as s:
        res = s.run_suite(suite)
    log = res.result("gpt-4o-mini", "s1").logs["streaming"]
    assert (log["n_examples"], log["max_inflight_chunks"], log["n_chunks"]) == (120, 3, 4)


# -- the launch counts under threads ----------------------------------------------------


def test_launch_counts_lose_no_increment_under_threads():
    from repro_torch.kernels import _cuda

    def fake_wrapper():
        pass

    fake_wrapper.launches = 0
    n_threads, n_each = 8, 5000
    barrier = threading.Barrier(n_threads)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        def bump():
            barrier.wait()
            for _ in range(n_each):
                _cuda.count_launch(fake_wrapper)

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fake_wrapper.launches == n_threads * n_each
    # every kernel wrapper counts through the lock
    sources = sorted((ROOT / "src" / "repro_torch" / "kernels").rglob("*.py"))
    counted = [f.name for f in sources if "_cuda.count_launch(" in f.read_text()]
    assert len(counted) == 7
    for f in sources:
        assert ".launches += 1" not in f.read_text() or f.name == "_cuda.py", f
