"""The port's lock-step path, rate limiters, worker pool and retries against
the JAX package's, on the CPU (no test sleeps: clocks and sleeps are fakes,
and a session without ``wall_clock_rate_limit`` waits for nothing):

* ``TokenBucket`` and ``AdaptiveLimiter`` give the same sleeps, capacity
  and shares under one fake clock;
* ``WorkerPool`` gives the same results and ``PoolStats`` with retries and
  speculative re-issue, for ``map_shards`` and ``imap_windowed``;
* ``retry_with_backoff`` and the service's retries over
  ``SimulatedAPIEngine(fail_every=3)`` give the same responses, attempts
  and accounting;
* ``run_task`` with ``use_service=False`` gives the reference's
  ``EvalResult`` (texts, metrics, ``cache_stats``, ``engine_stats`` with
  the pool's counts) over the simulated engine and over the reduced
  ``"torch_local"`` engine (the JAX engine's seed-0 weights bridged, both
  in f32), and the service path's own results.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.models.model as jax_model_mod
import repro_torch.core as P
import repro_torch.core.engines as port_engines
from repro.configs import get_config as jax_get_config
from repro.core import ratelimit as jax_ratelimit
from repro.data import qa_examples as jax_qa
from repro.ft import workers as jax_workers
from repro.models import params as jax_pm
from repro_torch.configs import get_config
from repro_torch.core import ratelimit
from repro_torch.ft import workers
from repro_torch.models import TransformerLM, params_from_jax

N_ROWS, MAX_TOKENS, N_SLOTS, MAX_LEN = 12, 6, 4, 64


class FakeClock:
    """A clock that only moves when slept on (or told to)."""

    def __init__(self):
        self.t = 100.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


# -- rate limiters ----------------------------------------------------------------


def _drive_bucket(mod, clock, estimates, advance):
    bucket = mod.TokenBucket(120.0, 600.0, 2, clock=clock, sleep=clock.sleep)
    waits = []
    for est, dt in zip(estimates, advance):
        clock.t += dt
        waits.append(bucket.acquire(est))
    return waits, bucket.total_wait, bucket.acquires, bucket.request_tokens, bucket.token_tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_waits_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    estimates = rng.integers(0, 200, 40).astype(float).tolist()
    advance = rng.choice([0.0, 0.1, 1.5, 7.0], 40).tolist()
    jc, pc = FakeClock(), FakeClock()
    want = _drive_bucket(jax_ratelimit, jc, estimates, advance)
    got = _drive_bucket(ratelimit, pc, estimates, advance)
    assert got == want and pc.sleeps == jc.sleeps
    assert any(w > 0 for w in got[0])  # the buckets ran dry and waited


def _drive_adaptive(mod, clock, plan):
    lim = mod.AdaptiveLimiter(60.0, 10_000.0, 3, window=5.0, floor=0.1,
                              clock=clock, sleep=clock.sleep)
    out = []
    for worker, est, dt in plan:
        clock.t += dt
        out.append((lim.acquire(worker, est), tuple(lim.shares())))
    return out


def test_adaptive_limiter_rebalances_as_the_reference():
    rng = np.random.default_rng(7)
    # worker 0 takes most of the traffic, worker 2 none: its share falls
    plan = [(int(rng.choice(3, p=[0.7, 0.3, 0.0])), float(rng.integers(1, 50)),
             float(rng.choice([0.0, 0.5, 2.0]))) for _ in range(60)]
    jc, pc = FakeClock(), FakeClock()
    want = _drive_adaptive(jax_ratelimit, jc, plan)
    got = _drive_adaptive(ratelimit, pc, plan)
    assert got == want and pc.sleeps == jc.sleeps
    shares = got[-1][1]
    assert shares[0] > shares[1] > shares[2] and abs(sum(shares) - 1.0) < 1e-12


# -- worker pool -------------------------------------------------------------------


def _flaky(fail_first: set[int]):
    """fn(index, shard, worker): the first attempt of each shard in
    ``fail_first`` raises; the value is a pure function of the shard."""
    lock = threading.Lock()
    calls: dict[int, int] = {}

    def fn(i, shard, wid):
        with lock:
            calls[i] = calls.get(i, 0) + 1
            n = calls[i]
        if i in fail_first and n == 1:
            raise RuntimeError(f"shard {i} attempt 1")
        return sum(shard) * 10 + i

    return fn


@pytest.mark.parametrize("n_workers", [1, 3])
def test_pool_map_shards_retries_as_the_reference(n_workers):
    shards = [list(range(i, i + 4)) for i in range(0, 40, 4)]
    out = {}
    for mod in (jax_workers, workers):
        pool = mod.WorkerPool(n_workers, max_retries=2, poll_s=0.001)
        stats = mod.PoolStats()
        res = pool.map_shards(_flaky({0, 3, 7}), shards, stats_out=stats)
        out[mod] = ([(r.index, r.value, r.attempts, r.speculative) for r in res],
                    dataclasses.asdict(stats), dataclasses.asdict(pool.stats))
    assert out[workers] == out[jax_workers]
    assert out[workers][1] == {"shards": 10, "retries": 3, "speculative_launches": 0,
                               "speculative_wins": 0, "failures": 3}


def test_pool_exhausted_retries_raise_as_the_reference():
    for mod in (jax_workers, workers):
        pool = mod.WorkerPool(2, max_retries=0, poll_s=0.001)
        with pytest.raises(RuntimeError, match="shard 1 attempt 1"):
            pool.map_shards(_flaky({1}), [[1], [2], [3]])
        assert pool.stats.failures == 1 and pool.stats.retries == 0


def _straggler():
    """Shard 0's first attempt waits for its speculative twin, then raises;
    the twin answers.  So the twin wins whatever order the pool sees the two
    finish in, and the first attempt counts as one failure."""
    lock = threading.Lock()
    calls: dict[int, int] = {}
    twin_done = threading.Event()

    def fn(i, shard, wid):
        with lock:
            calls[i] = calls.get(i, 0) + 1
            n = calls[i]
        if i == 0 and n == 1:
            assert twin_done.wait(timeout=30.0)
            raise RuntimeError("straggler gave up")
        if i == 0:
            twin_done.set()
        return i * 100 + len(shard)

    return fn


def test_pool_speculative_reissue_as_the_reference():
    shards = [[0, 1], [2], [3, 4, 5]]
    out = {}
    for mod in (jax_workers, workers):
        pool = mod.WorkerPool(3, max_retries=0, straggler_factor=1.0,
                              straggler_min_s=0.0, poll_s=0.001)
        stats = mod.PoolStats()
        res = pool.map_shards(_straggler(), shards, stats_out=stats)
        out[mod] = ([(r.index, r.value, r.speculative) for r in res],
                    dataclasses.asdict(stats))
    assert out[workers] == out[jax_workers]
    assert out[workers] == ([(0, 2, True), (1, 101, False), (2, 203, False)],
                            {"shards": 3, "retries": 0, "speculative_launches": 1,
                             "speculative_wins": 1, "failures": 1})


@pytest.mark.parametrize("ordered", [False, True])
def test_pool_imap_windowed_as_the_reference(ordered):
    items = [list(range(i % 5 + 1)) for i in range(17)]
    out = {}
    for mod in (jax_workers, workers):
        pool = mod.WorkerPool(4, max_retries=1, poll_s=0.001)
        stats = mod.PoolStats()
        res = list(pool.imap_windowed(_flaky({2, 9}), iter(items), window=3,
                                      ordered=ordered, stats_out=stats))
        order = [r.index for r in res]
        out[mod] = (sorted((r.index, r.value, r.attempts) for r in res),
                    dataclasses.asdict(stats), order if ordered else None)
    assert out[workers] == out[jax_workers]
    assert out[workers][1]["retries"] == 2 and out[workers][1]["shards"] == 17
    with pytest.raises(ValueError):
        next(workers.WorkerPool().imap_windowed(lambda *a: 0, [1], window=0))


# -- retries ---------------------------------------------------------------------------


def _api(mod, model="gpt-4o-mini"):
    return mod.EngineModelConfig(provider="openai", model_name=model, max_tokens=MAX_TOKENS)


def test_retry_with_backoff_over_failing_engine_as_the_reference():
    prompts = [f"question number {i} about volcanoes" for i in range(20)]
    out = {}
    for mod in (R.engines, port_engines):
        engine = mod.SimulatedAPIEngine(_api(mod), fail_every=3)
        sleeps = []
        resps = [mod.retry_with_backoff(
            lambda p=p: engine.infer(mod.InferenceRequest(p, MAX_TOKENS)),
            max_retries=2, base_delay=0.5, sleep=sleeps.append) for p in prompts]
        out[mod] = ([dataclasses.asdict(r) for r in resps], sleeps, engine.calls,
                    engine.total_cost)
    assert out[port_engines] == out[R.engines]
    assert out[port_engines][1] and all(r["error"] is None for r in out[port_engines][0])


@pytest.mark.parametrize("case", ["exhausted", "exception", "fatal"])
def test_retry_with_backoff_edges_as_the_reference(case):
    for mod in (R.engines, port_engines):
        sleeps, calls = [], []

        def fn():
            calls.append(1)
            if case == "exception":
                raise mod.RecoverableEngineError("busy")
            if case == "fatal":
                raise TypeError("bug")
            return mod.InferenceResponse("", 0, 0, 1.0, error="http 503")

        if case == "exhausted":
            assert mod.retry_with_backoff(fn, max_retries=2, base_delay=1.0,
                                          sleep=sleeps.append).error == "http 503"
        else:
            with pytest.raises(mod.RecoverableEngineError if case == "exception"
                               else TypeError):
                mod.retry_with_backoff(fn, max_retries=2, base_delay=1.0,
                                       sleep=sleeps.append)
        assert (len(calls), sleeps) == ((1, []) if case == "fatal" else (3, [1.0, 2.0]))
    assert port_engines.is_recoverable("rate_limited_429")
    assert not port_engines.is_recoverable("bad request") and not port_engines.is_recoverable(None)


def test_service_retries_over_failing_engine_as_the_reference():
    prompts = [f"tell me about glaciers {i}" for i in range(15)]
    out = {}
    for mod, svc_mod in ((R.engines, R.service), (port_engines, P.service)):
        engine = mod.SimulatedAPIEngine(_api(mod), fail_every=3)
        sleeps = []
        svc = svc_mod.InferenceService(engine, n_dispatchers=1, sleep=sleeps.append)
        try:
            svc.attach(1)
            tickets = [svc.submit(mod.InferenceRequest(p, MAX_TOKENS), key=p,
                                  max_retries=3, retry_delay=0.25) for p in prompts]
            got = [(t.result(30.0).text, t.result(30.0).error, t.attempts) for t in tickets]
            svc.detach(1)
        finally:
            svc.close()
        snap = svc.snapshot()
        out[mod] = (got, sleeps, engine.calls,
                    {k: snap[k] for k in ("submitted", "dispatched", "completed",
                                          "retries", "errors", "mode", "dispatchers")})
    assert out[port_engines] == out[R.engines]
    assert out[port_engines][3]["retries"] == 7 and out[port_engines][3]["mode"] == "threads"


# -- the lock-step path through run_task --------------------------------------------


def _task(mod, model, *, streaming=False, **inference):
    task = mod.EvalTask(
        "lockstep", model=model, inference=mod.InferenceConfig(**inference),
        metrics=(mod.MetricConfig("exact_match"), mod.MetricConfig("token_f1"),
                 mod.MetricConfig("llm_judge", type="llm_judge")),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200),
    )
    return task.with_streaming(max_memory_rows=5) if streaming else task


def _assert_results_equal(p, j, *, exact_ci=("exact_match", "llm_judge")):
    """Equal results; a metric's value and interval bit for bit (NaN equal
    to NaN), but for the in-memory interval of non-dyadic scores."""
    assert p.responses == j.responses and p.failures == j.failures
    assert p.engine_stats == j.engine_stats and p.cache_stats == j.cache_stats
    assert sorted(p.metrics) == sorted(j.metrics)
    for name, jm in j.metrics.items():
        pm = p.metrics[name]
        assert (pm.n, pm.n_unscored, pm.ci_method) == (jm.n, jm.n_unscored, jm.ci_method)
        np.testing.assert_array_equal(pm.value, jm.value)
        if name in exact_ci or p.stream_stats is not None or jm.n == 0:
            np.testing.assert_array_equal(pm.ci, jm.ci, err_msg=name)
        else:  # compute_ci on non-dyadic scores: 1e-6 (test_torch_inmemory.py)
            np.testing.assert_allclose(pm.ci, jm.ci, rtol=0, atol=1e-6)
    for name, s in j.scores.items():
        np.testing.assert_array_equal(p.scores[name], s)


def _run(mod, task, rows, **session_kw):
    kw = {} if mod is R else {"device": "cpu"}
    with mod.EvalSession(**kw, **session_kw) as s:
        res = s.run_task(rows, task)
        return res, s.accounting.as_dict()


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("inference", [
    {"use_service": False, "n_workers": 2, "batch_size": 4},
    {"use_service": False, "n_workers": 1, "adaptive_rate": True, "rate_limit_rpm": 30.0},
    {"use_service": False, "n_workers": 1, "speculative_reissue": True},
    {"use_service": True, "n_workers": 3, "rate_limit_tpm": 500.0},
], ids=["two-workers", "adaptive-rpm", "speculative", "service"])
def test_run_task_over_the_api_engine_equals_the_reference(tmp_path, streaming, inference):
    rows = jax_qa(N_ROWS)
    out = {}
    for mod in (R, P):
        cache = str(tmp_path / ("jax" if mod is R else "port"))
        task = _task(mod, _api(mod), streaming=streaming, cache_dir=cache, **inference)
        out[mod] = _run(mod, task, rows)
    (p, pacct), (j, jacct) = out[P], out[R]
    _assert_results_equal(p, j)
    assert {k: v for k, v in pacct.items() if k != "wall_s"} == {
        k: v for k, v in jacct.items() if k != "wall_s"}
    assert p.engine_stats["calls"] == N_ROWS and p.cache_stats["writes"] == N_ROWS
    assert bool(p.engine_stats["pool"]) == (not inference["use_service"])


def test_failing_engine_through_both_paths_equals_the_reference():
    """``fail_every=3`` through the lock-step path (one worker, so the
    failing calls fall on the same prompts) and through the service (one
    dispatcher): the same texts, and every retry counted as an engine
    call of the task, as the reference counts them."""
    rows = jax_qa(N_ROWS)
    for use_service in (False, True):
        out = {}
        for mod in (R, P):
            task = _task(mod, _api(mod), use_service=use_service, n_workers=1,
                         max_retries=2)
            out[mod] = _run(mod, task, rows, engine_kwargs={"fail_every": 3})
        (p, pacct), (j, jacct) = out[P], out[R]
        _assert_results_equal(p, j)
        assert p.engine_stats["calls"] == j.engine_stats["calls"] > N_ROWS
        assert pacct["engine_calls"] == jacct["engine_calls"]


# -- the lock-step path on the reduced local engine -----------------------------------


class _JaxF32:
    """Test-side wrapper: the JAX model with every call in f32."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def param_specs(self):
        return self.model.param_specs()

    def cache_specs(self, *a, **kw):
        return self.model.cache_specs(*a, **kw)

    def prefill(self, params, batch, cache):
        return self.model.prefill(params, batch, cache, dtype=jnp.float32)

    def decode_step(self, params, tokens, cache, positions):
        return self.model.decode_step(params, tokens, cache, positions, dtype=jnp.float32)


class _PortF32(TransformerLM):
    def prefill(self, *a, **kw):
        return super().prefill(*a, dtype=torch.float32, **kw)

    def decode_step(self, *a, **kw):
        return super().decode_step(*a, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_get_config("qwen3-4b").reduced()
    model = jax_model_mod.build_model(jcfg, remat="none")
    tree = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(0), model.param_specs()))
    return params_from_jax(tree, get_config("qwen3-4b").reduced(), device="cpu",
                           dtype=torch.float32)


@pytest.fixture
def f32(monkeypatch, bridged):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model", lambda c, **kw: _JaxF32(build(c, **kw)))
    monkeypatch.setattr(port_engines, "build_model", lambda cfg: _PortF32(cfg))
    monkeypatch.setattr(port_engines, "init_params", lambda cfg, seed, device: bridged)


def test_lockstep_on_the_local_engine_equals_the_reference_and_the_service(f32):
    rows = jax_qa(8)
    kw = {"engine_kwargs": {"n_slots": N_SLOTS, "max_len": MAX_LEN}}
    out = {}
    for mod, provider in ((R, "local"), (P, "torch_local")):
        model = mod.EngineModelConfig(provider=provider, model_name="qwen3-4b",
                                      reduced=True, seed=0, max_tokens=MAX_TOKENS)
        lock = _task(mod, model, use_service=False, n_workers=2, batch_size=3)
        out[mod] = _run(mod, lock, rows, **kw)[0]
        if mod is P:
            service = _run(mod, _task(mod, model), rows, **kw)[0]
    p, j = out[P], out[R]
    assert len(set(p.responses)) > 1
    _assert_results_equal(p, j)
    assert p.engine_stats["pool"] == {"shards": 3, "retries": 0, "speculative_launches": 0,
                                      "speculative_wins": 0, "failures": 0}
    # the lock-step path gives the service path's texts, scores and calls
    assert p.responses == service.responses
    assert {k: v for k, v in p.engine_stats.items() if k != "pool"} == {
        k: v for k, v in service.engine_stats.items() if k != "pool"}
    for name, s in service.scores.items():
        np.testing.assert_array_equal(p.scores[name], s)


def test_concurrent_direct_callers_get_their_own_answers(f32):
    """Two threads calling ``infer`` on one local engine, which steps its
    batcher for whichever caller holds the lock: each gets its own answer,
    equal to the one it gets alone."""
    model = P.EngineModelConfig(model_name="qwen3-4b", reduced=True, seed=0,
                                max_tokens=MAX_TOKENS)
    engine = P.TorchLocalEngine(model, n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu")
    prompts = [f"what is known about neurons (case {i})?" for i in range(6)]
    alone = [engine.infer(P.InferenceRequest(p, MAX_TOKENS)).text for p in prompts]
    got: dict[int, str] = {}

    def worker(idxs):
        for i in idxs:
            got[i] = engine.infer(P.InferenceRequest(prompts[i], MAX_TOKENS)).text

    threads = [threading.Thread(target=worker, args=(range(k, 6, 2),)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert [got[i] for i in range(6)] == alone
    assert engine.serving_stats()["completions"] == 12


class _FlakySlots:
    """A stub slot engine: ``stream_submit`` refuses a prompt's first
    admission with the package's ``RecoverableEngineError`` when it ends in
    "!", and a prompt ending in "?" finishes first with a 429 error; every
    answer is the prompt reversed.  One prompt finishes a pump."""

    supports_streaming = True

    def __init__(self, mod):
        self.mod, self.seen, self.rid, self.queue = mod, set(), 0, []
        self.calls = 0

    def stream_submit(self, req):
        self.calls += 1
        if req.prompt.endswith("!") and ("submit", req.prompt) not in self.seen:
            self.seen.add(("submit", req.prompt))
            raise self.mod.RecoverableEngineError("slots full")
        self.rid += 1
        self.queue.append((self.rid, req))
        return self.rid

    def stream_pump(self):
        if not self.queue:
            return []
        rid, req = self.queue.pop(0)
        if req.prompt.endswith("?") and ("pump", req.prompt) not in self.seen:
            self.seen.add(("pump", req.prompt))
            return [(rid, self.mod.InferenceResponse("", 0, 0, 1.0, error="http 429"))]
        return [(rid, self.mod.InferenceResponse(req.prompt[::-1], 1, 1, 1.0))]

    def stream_pending(self):
        return bool(self.queue)

    def stream_cancel(self, rid):
        return False

    def serving_stats(self):
        return {}


def test_service_batcher_retries_and_limits_as_the_reference():
    """The batcher loop's scheduled retries (a refused admission, a 429
    answer) under a no-op sleep, and the rate limiter acquired once an
    admission, round the workers' buckets: the same answers, attempts,
    counters and bucket acquires as the reference's service."""
    prompts = ["a", "b!", "c?", "d", "e!", "f?", "g"]
    out = {}
    for mod, svc_mod, rl in ((R.engines, R.service, jax_ratelimit),
                             (port_engines, P.service, ratelimit)):
        clock = FakeClock()
        buckets = [rl.TokenBucket(600.0, 1e6, 2, clock=clock, sleep=clock.sleep)
                   for _ in range(2)]
        engine = _FlakySlots(mod)
        svc = svc_mod.InferenceService(engine, sleep=lambda s: None, max_batch_wait_ms=0.0)
        try:
            tickets = [svc.submit(mod.InferenceRequest(p, 4), key=p, limiter=buckets,
                                  est_tokens=5.0, max_retries=2, retry_delay=9.0)
                       for p in prompts]
            got = [(t.result(30.0).text, t.attempts) for t in tickets]
            over = svc.submit(mod.InferenceRequest("z?", 4), key="z?", max_retries=0)
            got.append((over.result(30.0).error, over.attempts))
        finally:
            svc.close()
        snap = svc.snapshot()
        out[mod] = (got, engine.calls, [b.acquires for b in buckets],
                    {k: snap[k] for k in ("submitted", "dispatched", "completed",
                                          "retries", "errors")})
    assert out[port_engines] == out[R.engines]
    got, calls, acquires, counters = out[port_engines]
    assert got[:3] == [("a", 1), ("!b", 2), ("?c", 2)] and got[-1] == ("http 429", 1)
    assert sum(acquires) == 11 and counters["retries"] == 4
