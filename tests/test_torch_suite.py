"""The port's comparison path against the JAX package's, on the CPU, with
the reduced qwen3-4b and the reduced mamba2-2.7b (the JAX engines' seed-0
weights carried across by ``params_from_jax``, every call in f32):

* ``EvalSession.run_suite`` over both models x an in-memory and a
  streaming task: equal texts in every job, and a significance matrix with
  the same cells.  Every comparison has the reference's test; where the
  two frameworks' scores are equal (the lexical metrics) its statistic,
  p-value and effect size are equal too, and the in-memory interval of the
  difference agrees to ``compute_ci``'s tolerance for non-dyadic scores
  (1e-6, ``tests/test_torch_inmemory.py``).  ``embedding_similarity``'s f32
  hash embeddings are summed in other orders, so its scores differ by up
  to 1e-6; there the port's ``compare_scores`` on the reference's own
  scores gives the reference's test, statistic and p-value bit for bit,
  and the cross-framework numbers agree to a stated tolerance.
* ``parallel_jobs=2`` gives the serial run's results.
* The two listed repairs: a default streaming task (``backend="numpy"``)
  gives the reference's default intervals bit for bit (and ``"pallas"``
  runs the device engine against the reference's ref path); forced engine
  errors appear in ``failures`` at the reference's indices in memory and
  streaming, with the reference's ``engine_stats``, ``cache_stats`` and
  ``throughput_per_min``.
* ``rescore_stages`` re-scores a result's responses with no engine call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engines as jax_engines
import repro.models.model as jax_model_mod
import repro_torch.core.engines as port_engines
from repro.configs import get_config as jax_get_config
from repro.core import EngineModelConfig as JaxModelConfig
from repro.core import EvalSession as JaxSession
from repro.core import EvalSuite as JaxSuite
from repro.core import EvalTask as JaxTask
from repro.core import InferenceConfig as JaxInference
from repro.core import MetricConfig as JaxMetric
from repro.core import StatisticsConfig as JaxStats
from repro.core.compare import compare_scores as jax_compare_scores
from repro.data import iter_qa_examples as jax_rows
from repro.models import params as jax_pm
from repro_torch.configs import get_config
from repro_torch.core import (
    MAX_FAILURE_SAMPLE,
    EngineModelConfig,
    EvalSession,
    EvalSuite,
    EvalTask,
    MetricConfig,
    StatisticsConfig,
    compare_scores,
    rescore_stages,
)
from repro_torch.data import iter_qa_examples
from repro_torch.models import MambaLM, TransformerLM, params_from_jax

N_ROWS, CHUNK, MAX_TOKENS, N_SLOTS, MAX_LEN, N_BOOT = 16, 8, 8, 4, 64, 200
MODELS = ("qwen3-4b", "mamba2-2.7b")
METRICS = (("exact_match", "lexical"), ("token_f1", "lexical"),
           ("embedding_similarity", "semantic"))
LEXICAL = {"exact_match", "token_f1"}


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
        return self.model.decode_step(params, tokens, cache, positions,
                                      dtype=jnp.float32)


def _f32(cls):
    class F32(cls):
        def prefill(self, *a, **kw):
            return super().prefill(*a, dtype=torch.float32, **kw)

        def decode_step(self, *a, **kw):
            return super().decode_step(*a, dtype=torch.float32, **kw)

    return F32


_PORT_F32 = {"dense": _f32(TransformerLM), "ssm": _f32(MambaLM)}


@pytest.fixture(scope="module")
def bridged():
    """Each model's JAX seed-0 parameters, bridged to the port in f32."""
    out = {}
    for arch in MODELS:
        jcfg = jax_get_config(arch).reduced()
        model = jax_model_mod.build_model(jcfg, remat="none")
        tree = jax.tree.map(np.asarray,
                            jax_pm.init_params(jax.random.key(0), model.param_specs()))
        cfg = get_config(arch).reduced()
        out[cfg.name] = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    return out


def _patch_f32(mp, bridged):
    build = jax_model_mod.build_model
    mp.setattr(jax_model_mod, "build_model", lambda c, **kw: _JaxF32(build(c, **kw)))
    mp.setattr(port_engines, "build_model", lambda cfg: _PORT_F32[cfg.family](cfg))
    mp.setattr(port_engines, "init_params", lambda cfg, seed, device: bridged[cfg.name])


@pytest.fixture
def f32(monkeypatch, bridged):
    """Both frameworks' engines in f32; the port's weights are the JAX
    engine's, whichever model the registry builds."""
    _patch_f32(monkeypatch, bridged)


ENGINE_KW = {"n_slots": N_SLOTS, "max_len": MAX_LEN}


def _jax_model(arch):
    return JaxModelConfig(provider="local", model_name=arch, reduced=True, seed=0,
                          max_tokens=MAX_TOKENS)


def _port_model(arch):
    return EngineModelConfig(model_name=arch, reduced=True, seed=0,
                             max_tokens=MAX_TOKENS)


def _jax_suite():
    metrics = tuple(JaxMetric(m, type=t) for m, t in METRICS)
    mem = JaxTask("mem", model=_jax_model(MODELS[0]), metrics=metrics,
                  inference=JaxInference(n_workers=2),
                  statistics=JaxStats(bootstrap_iterations=N_BOOT))
    stream = JaxTask("stream", model=_jax_model(MODELS[0]), metrics=metrics,
                     inference=JaxInference(n_workers=2),
                     statistics=JaxStats(bootstrap_iterations=N_BOOT,
                                         ci_method="percentile"),
                     ).with_streaming(max_memory_rows=CHUNK)
    return (JaxSuite("pair").add_task(mem, list(jax_rows(N_ROWS, seed=0)))
            .add_task(stream, lambda: jax_rows(N_ROWS, seed=0))
            .sweep_models([_jax_model(a) for a in MODELS]))


def _port_suite():
    metrics = tuple(MetricConfig(m, type=t) for m, t in METRICS)
    mem = EvalTask("mem", model=_port_model(MODELS[0]), metrics=metrics,
                   statistics=StatisticsConfig(bootstrap_iterations=N_BOOT))
    stream = EvalTask("stream", model=_port_model(MODELS[0]), metrics=metrics,
                      statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                                  ci_method="percentile"),
                      ).with_streaming(max_memory_rows=CHUNK)
    return (EvalSuite("pair").add_task(mem, list(iter_qa_examples(N_ROWS, seed=0)))
            .add_task(stream, lambda: iter_qa_examples(N_ROWS, seed=0))
            .sweep_models([_port_model(a) for a in MODELS]))


def _texts(monkeypatch, stages_mod, sink):
    """Record each job's texts as ScoreStage sees them (streaming drops
    them from the result)."""
    orig = stages_mod.ScoreStage.run

    def run(self, art, session):
        sink.setdefault((art.task.model.model_name, art.task.task_id), []).extend(art.texts)
        return orig(self, art, session)

    monkeypatch.setattr(stages_mod.ScoreStage, "run", run)


@pytest.fixture(scope="module")
def suites(bridged):
    """Both frameworks' suites, and the port's again with two jobs at once
    (one run for the module: the suites take most of its time)."""
    import repro.core.stages as jax_stages
    import repro_torch.core.stages as port_stages

    jtexts, ptexts, ptexts_par = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_f32(mp, bridged)
        _texts(mp, jax_stages, jtexts)
        _texts(mp, port_stages, ptexts)
        with JaxSession(engine_kwargs=ENGINE_KW) as s:
            jres = s.run_suite(_jax_suite())
        with EvalSession(device="cpu", engine_kwargs=ENGINE_KW) as s:
            pres = s.run_suite(_port_suite())
            serial = dict(ptexts)
            ptexts.clear()
            ppar = s.run_suite(_port_suite(), parallel_jobs=2)
            ptexts_par.update(ptexts)
            assert len(s.engines) == 2
    return jres, jtexts, pres, serial, ppar, ptexts_par


def test_run_suite_over_two_models_equals_the_reference(suites):
    jres, jtexts, pres, ptexts, *_ = suites
    assert pres.models == jres.models == list(MODELS)
    assert pres.tasks == jres.tasks == ["mem", "stream"]
    assert sorted(ptexts) == sorted(jtexts) and len(ptexts) == 4
    for key, texts in jtexts.items():
        assert len(texts) == N_ROWS and ptexts[key] == texts, key
    for key, j in jres.results.items():
        p = pres.results[key]
        assert p.responses == j.responses
        assert p.engine_stats == j.engine_stats
        assert (p.failures, p.cache_stats) == (j.failures, j.cache_stats) == ([], {})
        for name, kind in METRICS:
            jm, pm = j.metrics[name], p.metrics[name]
            assert (pm.n, pm.ci_method) == (jm.n, jm.ci_method)
            if key[1] == "stream" and name in LEXICAL:
                # host f64 moments and the numpy engine's replicates of
                # equal scores: the default streaming interval bit for bit
                assert (pm.value, pm.ci) == (jm.value, jm.ci)
    # the models differ: the cosine metric separates them
    mem = [pres.results[(m, "mem")].scores["embedding_similarity"] for m in MODELS]
    assert not np.array_equal(*mem)


def test_significance_matrix_equals_the_reference(suites):
    jres, _, pres, *_ = suites
    assert set(pres.comparisons) == set(jres.comparisons) == {"mem", "stream"}
    pair = tuple(MODELS)
    for task_id, by_metric in jres.comparisons.items():
        assert set(pres.comparisons[task_id]) == set(by_metric) == {m for m, _ in METRICS}
        for metric, cells in by_metric.items():
            assert set(pres.comparisons[task_id][metric]) == set(cells) == {pair}
            j, p = cells[pair], pres.comparisons[task_id][metric][pair]
            assert p.test.test == j.test.test and p.recommendation.test == j.recommendation.test
            assert p.n == j.n and p.effect.name == j.effect.name
            assert 0.0 <= p.test.p_value <= 1.0
            if metric in LEXICAL:
                assert (p.test.statistic, p.test.p_value) == (j.test.statistic, j.test.p_value)
                assert (p.mean_a, p.mean_b, p.diff) == (j.mean_a, j.mean_b, j.diff)
                np.testing.assert_allclose(p.effect.value, j.effect.value,
                                           rtol=0, atol=1e-12)
            else:
                # scores within 1e-6 of the reference's
                np.testing.assert_allclose(
                    [p.test.statistic, p.test.p_value, p.effect.value, p.diff],
                    [j.test.statistic, j.test.p_value, j.effect.value, j.diff],
                    rtol=1e-4, atol=1e-6)
            if task_id == "mem":
                # compute_ci on the diffs: 1e-6 on non-dyadic scores
                np.testing.assert_allclose(p.diff_ci, j.diff_ci, rtol=0, atol=2e-6)
            else:
                assert p.test.test == "paired_bootstrap"
                assert p.test.detail == j.test.detail == {"n_boot": N_BOOT,
                                                          "backend": "numpy"}
                tol = 0.0 if metric in LEXICAL else 1e-5
                np.testing.assert_allclose(p.diff_ci, j.diff_ci, rtol=0, atol=tol)


def test_compare_scores_on_the_reference_scores_is_bit_equal(suites):
    jres, *_ = suites
    for name, _ in METRICS:
        a, b = (jres.results[(m, "mem")].scores[name] for m in MODELS)
        want = jax_compare_scores(name, a, b, n_boot=N_BOOT)
        got = compare_scores(name, a, b, n_boot=N_BOOT, device="cpu")
        assert dataclasses.astuple(got.test) == dataclasses.astuple(want.test)
        assert (got.recommendation.test, got.recommendation.reason,
                got.recommendation.normal_p) == (
            want.recommendation.test, want.recommendation.reason,
            want.recommendation.normal_p)
        assert dataclasses.astuple(got.effect) == dataclasses.astuple(want.effect)
        assert (got.mean_a, got.mean_b, got.diff, got.n) == (
            want.mean_a, want.mean_b, want.diff, want.n)
        np.testing.assert_allclose(got.diff_ci, want.diff_ci, rtol=0, atol=2e-6)


def test_parallel_jobs_give_the_serial_results(suites):
    _, _, pres, ptexts, ppar, ptexts_par = suites
    assert ptexts_par == ptexts
    for key, r in pres.results.items():
        q = ppar.results[key]
        assert q.responses == r.responses
        # two jobs on one engine may share a flight in the service: each
        # prompt is paid for once or coalesced, never lost
        assert (q.engine_stats["calls"] + q.engine_stats["coalesced"]
                == r.engine_stats["calls"] + r.engine_stats["coalesced"] == N_ROWS)
        for name, mv in r.metrics.items():
            assert (q.metrics[name].value, q.metrics[name].ci) == (mv.value, mv.ci)
        for name, v in r.scores.items():
            np.testing.assert_array_equal(q.scores[name], v)
    for task_id, by_metric in pres.comparisons.items():
        for metric, cells in by_metric.items():
            for pair, c in cells.items():
                d = ppar.comparisons[task_id][metric][pair]
                assert (d.test, d.diff, d.diff_ci, d.effect) == (
                    c.test, c.diff, c.diff_ci, c.effect)
    assert "torch_local:qwen3-4b" in ppar.to_markdown()


# -- repair 1: the default streaming backend -----------------------------------------


STREAM_METRICS = (("exact_match", "lexical"), ("token_f1", "lexical"))


def _jax_stream(**stats):
    task = JaxTask("default-stream", model=_jax_model("qwen3-4b"),
                   inference=JaxInference(n_workers=2),
                   metrics=tuple(JaxMetric(m, type=t) for m, t in STREAM_METRICS),
                   statistics=JaxStats(**stats)).with_streaming(max_memory_rows=CHUNK)
    with JaxSession(engine_kwargs=ENGINE_KW) as s:
        return s.run_task(jax_rows(24, seed=1), task)


def _port_stream(**stats):
    task = EvalTask("default-stream", model=_port_model("qwen3-4b"),
                    metrics=tuple(MetricConfig(m, type=t) for m, t in STREAM_METRICS),
                    statistics=StatisticsConfig(**stats)
                    ).with_streaming(max_memory_rows=CHUNK)
    with EvalSession(device="cpu", engine_kwargs=ENGINE_KW) as s:
        return s.run_task(iter_qa_examples(24, seed=1), task)


def test_default_streaming_intervals_equal_the_reference(f32):
    assert StatisticsConfig().backend == "numpy"
    jres, pres = _jax_stream(), _port_stream()
    assert pres.logs["streaming"]["stats_stream"] == "numpy"
    assert pres.logs["streaming"]["stats_backend"] == jres.logs["streaming"]["stats_backend"]
    np.testing.assert_array_equal(pres.stream_stats.engine.sum_wx,
                                  jres.stream_stats.engine.sum_wx)
    np.testing.assert_array_equal(pres.stream_stats.engine.sum_w,
                                  jres.stream_stats.engine.sum_w)
    for name, j in jres.metrics.items():
        p = pres.metrics[name]
        assert (p.value, p.ci, p.ci_method, p.n) == (j.value, j.ci, j.ci_method, j.n)
    # timing: the reference's keys, with the per-chunk partials on their own
    assert set(pres.timing) == set(jres.timing) | {"partials_s"}


def test_pallas_backend_runs_the_device_engine_against_the_reference_ref(f32):
    jres = _jax_stream(backend="pallas", ci_method="percentile")
    pres = _port_stream(backend="pallas", ci_method="percentile")
    assert pres.logs["streaming"]["stats_stream"] == "device-ref"
    assert jres.stream_stats.engine.stream_id() == "pallas-ref"
    np.testing.assert_array_equal(pres.stream_stats.engine.sum_w,
                                  jres.stream_stats.engine.sum_w)
    for name, j in jres.metrics.items():
        p = pres.metrics[name]
        assert p.value == j.value
        # the same weights, f32 partials summed in another order
        np.testing.assert_allclose(p.ci, j.ci, rtol=0, atol=1e-5)
    # the host and device weight streams never pair
    host = _port_stream(ci_method="percentile")
    assert "streams differ" in pres.stream_stats.comparable_with(host.stream_stats)
    assert host.stream_stats.comparable_with(host.stream_stats) is None
    analytical = _port_stream(ci_method="analytical")
    assert "analytical" in analytical.stream_stats.comparable_with(host.stream_stats)


# -- repair 2: failures, cache and engine stats, throughput --------------------------

BAD = 3  # every third row's answer comes back as an engine error


def _fail_every(monkeypatch, engine_cls, predicate):
    """Mark the response of every request whose prompt satisfies
    ``predicate`` as failed, as a provider error would."""
    sub, pump = engine_cls.stream_submit, engine_cls.stream_pump
    bad: set = set()

    def stream_submit(self, request):
        rid = sub(self, request)
        if predicate(request.prompt):
            bad.add((id(self), rid))
        return rid

    def stream_pump(self):
        return [(rid, dataclasses.replace(r, text="", error="provider error: bad row")
                 if (id(self), rid) in bad else r) for rid, r in pump(self)]

    monkeypatch.setattr(engine_cls, "stream_submit", stream_submit)
    monkeypatch.setattr(engine_cls, "stream_pump", stream_pump)


def _bad_prompts(rows):
    return {r["question"] for i, r in enumerate(rows) if i % BAD == 1}


@pytest.mark.parametrize("streaming", [False, True])
def test_failures_and_stats_equal_the_reference(monkeypatch, f32, streaming):
    n = 20
    rows = list(iter_qa_examples(n, seed=2))
    bad = _bad_prompts(rows)
    _fail_every(monkeypatch, jax_engines.LocalJaxEngine, lambda p: p in bad)
    _fail_every(monkeypatch, port_engines.TorchLocalEngine, lambda p: p in bad)
    jtask = JaxTask("fails", model=_jax_model("qwen3-4b"),
                    inference=JaxInference(n_workers=2, max_retries=0))
    ptask = EvalTask("fails", model=_port_model("qwen3-4b"))
    if streaming:
        jtask, ptask = (t.with_streaming(max_memory_rows=CHUNK) for t in (jtask, ptask))
    with JaxSession(engine_kwargs=ENGINE_KW) as s:
        jres = s.run_task(list(jax_rows(n, seed=2)), jtask)
    with EvalSession(device="cpu", engine_kwargs=ENGINE_KW) as s:
        pres = s.run_task(rows, ptask)
    want = [{"index": i, "error": "provider error: bad row"}
            for i in range(n) if i % BAD == 1]
    assert pres.failures == jres.failures == want
    assert pres.engine_stats == jres.engine_stats
    assert pres.engine_stats["calls"] == n
    assert pres.cache_stats == jres.cache_stats == {}
    assert list(dataclasses.asdict(pres)) == list(dataclasses.asdict(jres))
    dt = pres.timing["infer_s"]
    assert pres.throughput_per_min == n / dt * 60.0 > 0
    if streaming:
        assert pres.responses == [] and pres.logs["streaming"]["n_failures"] == len(want)
    else:
        assert pres.responses == jres.responses
        assert all(pres.responses[f["index"]] == "" for f in want)


def test_streaming_keeps_the_first_hundred_failures(monkeypatch, f32):
    n = MAX_FAILURE_SAMPLE + 12
    _fail_every(monkeypatch, port_engines.TorchLocalEngine, lambda p: True)
    task = EvalTask("all-fail", model=EngineModelConfig(max_tokens=1),
                    ).with_streaming(max_memory_rows=32)
    with EvalSession(device="cpu", engine_kwargs=ENGINE_KW) as s:
        res = s.run_task(iter_qa_examples(n, seed=4), task)
    assert [f["index"] for f in res.failures] == list(range(MAX_FAILURE_SAMPLE))
    assert res.logs["streaming"]["n_failures"] == n
    assert res.engine_stats["calls"] == n


# -- rescoring ------------------------------------------------------------------------


def test_rescore_makes_no_engine_call(f32):
    rows = list(iter_qa_examples(N_ROWS, seed=0))
    task = EvalTask("rescore", model=_port_model("qwen3-4b"),
                    metrics=(MetricConfig("exact_match"),),
                    statistics=StatisticsConfig(bootstrap_iterations=N_BOOT))
    with EvalSession(device="cpu", engine_kwargs=ENGINE_KW) as s:
        first = s.run_task(rows, task)
        calls = s.accounting.engine_calls
        more = task.with_metrics(MetricConfig("exact_match"),
                                 MetricConfig("bertscore", type="semantic",
                                              params={"max_len": 16}))
        again = s.run_task(rows, more, stages=rescore_stages(first.responses))
        assert s.accounting.engine_calls == calls == N_ROWS
    assert again.engine_stats == {"calls": 0, "total_cost": 0.0, "pool": {}}
    assert again.responses == first.responses
    assert (again.metrics["exact_match"].value, again.metrics["exact_match"].ci) == (
        first.metrics["exact_match"].value, first.metrics["exact_match"].ci)
    assert np.isfinite(again.scores["bertscore"]).all()
    with pytest.raises(ValueError, match="responses for"):
        with EvalSession(device="cpu") as s:
            s.run_task(rows, task, stages=rescore_stages(first.responses[:3]))


# -- middleware, the registry's key, the task's JSON ---------------------------------


def test_middleware_hooks_fire_as_the_reference(f32):
    import io

    from repro.core.stages import ProgressMiddleware as JaxProgress
    from repro_torch.core import CostBudgetExceeded, ProgressMiddleware

    rows = list(iter_qa_examples(4, seed=5))
    ptask = EvalTask("mw", model=_port_model("qwen3-4b"),
                     statistics=StatisticsConfig(ci_method="analytical"))
    jtask = JaxTask("mw", model=_jax_model("qwen3-4b"),
                    inference=JaxInference(n_workers=2),
                    statistics=JaxStats(ci_method="analytical"))
    logs = []
    for session, task, progress in (
        (EvalSession(device="cpu", engine_kwargs=ENGINE_KW), ptask, ProgressMiddleware),
        (JaxSession(engine_kwargs=ENGINE_KW), jtask, JaxProgress),
    ):
        out = io.StringIO()
        session.middleware.append(progress(out))
        with session:
            session.run_task(rows, task)
            session.run_task(rows, task.with_streaming(max_memory_rows=2))
        # stage seconds and the provider's name differ; the lines and
        # their order do not
        logs.append([line.split(":")[0].replace("torch_local", "local")
                     for line in out.getvalue().splitlines()])
    # in memory: start, 4 stages, done; streaming: start, 2 chunks, done
    assert logs[0] == logs[1] and len(logs[0]) == 6 + 4
    with EvalSession(device="cpu", engine_kwargs=ENGINE_KW, cost_budget_usd=-1.0) as s:
        with pytest.raises(CostBudgetExceeded, match="after stage 'prepare'"):
            s.run_task(rows, ptask)
        with pytest.raises(CostBudgetExceeded, match="after streaming chunk 0"):
            s.run_task(rows, ptask.with_streaming(max_memory_rows=2))


def test_registry_keys_params_by_identity(f32, bridged):
    from repro_torch.core import EngineRegistry

    reg = EngineRegistry()
    model = _port_model("qwen3-4b")
    params = bridged["qwen3-4b-reduced"]
    a = reg.get(model, device="cpu", n_slots=2, max_len=32, params=params)
    assert reg.get(model, device="cpu", n_slots=2, max_len=32, params=params) is a
    other = {k: v for k, v in params.items()}  # equal tensors, another object
    assert reg.get(model, device="cpu", n_slots=2, max_len=32, params=other) is not a
    assert reg.get(model, device="cpu", n_slots=3, max_len=32, params=params) is not a
    assert len(reg) == 3
    reg.shutdown()
    assert len(reg) == 0 and a.batcher is None


def test_compare_results_and_task_json(suites):
    from repro_torch.core import compare_results

    _, _, pres, *_ = suites
    a, b = (pres.results[(m, "mem")] for m in MODELS)
    cmp = compare_results(a, b, n_boot=N_BOOT, device="cpu")
    assert set(cmp) == {m for m, _ in METRICS}
    for metric, c in cmp.items():
        assert c.test == pres.comparisons["mem"][metric][MODELS].test
    task = _port_suite()._tasks[0][0]
    assert task.fingerprint() == task.with_model(task.model).fingerprint()
    assert task.fingerprint() != task.with_model(_port_model(MODELS[1])).fingerprint()
    import json

    payload = json.loads(task.to_json())
    assert payload["inference"]["cache_policy"] == "enabled"
    assert payload["statistics"]["backend"] == "numpy"
