"""The port's judge and RAG metrics, its data sources and the 13-metric
registry against the JAX package's, on the CPU:

* the judge templates, ``extract_score``, ``pointwise_judge`` and
  ``pairwise_judge`` (with and without position de-biasing) over the
  simulated API engine: scores and unparseable logs bit for bit;
* the five RAG metrics bit for bit (answer relevance's f32 hash embeddings
  within 1e-6);
* the sources row for row;
* ``run_task`` with all 13 metrics over a simulated task engine, judged by
  a simulated judge engine or by the task's own engine, in memory and
  streaming: the reference's scores, metrics and ``judge_unparseable`` logs;
* a judge that never answers in format (the reduced ``"torch_local"``
  engine, the JAX engine's weights bridged, both in f32): every judge
  metric is the reference's empty result (NaN, method ``"none"``, ``n`` 0)
  in memory and streaming, under both streaming backends, and the paired
  streaming comparison of such a metric is the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.models.model as jax_model_mod
import repro_torch.core as P
import repro_torch.core.engines as port_engines
from repro import data as jax_data
from repro.configs import get_config as jax_get_config
from repro.core.compare import compare_stream_stats as jax_compare_stream
from repro.metrics import judge as jax_judge
from repro.metrics import rag as jax_rag
from repro.metrics import registry as jax_registry
from repro.models import params as jax_pm
from repro.stats import bootstrap as jax_boot
from repro_torch import data
from repro_torch.configs import get_config
from repro_torch.core import compare_stream_stats
from repro_torch.metrics import judge, rag, registry
from repro_torch.models import TransformerLM, params_from_jax

#: the 13 registry metrics, and those whose scores are f32 hash embeddings
METRICS = (("exact_match", "lexical"), ("contains", "lexical"), ("token_f1", "lexical"),
           ("bleu", "lexical"), ("rouge_l", "lexical"),
           ("embedding_similarity", "semantic"), ("bertscore", "semantic"),
           ("llm_judge", "llm_judge"), ("faithfulness", "rag"),
           ("context_relevance", "rag"), ("answer_relevance", "rag"),
           ("context_precision", "rag"), ("context_recall", "rag"))
EMBEDDED = {"embedding_similarity", "bertscore", "answer_relevance"}
#: metrics whose scores are dyadic (0/1, or a judge's grade in quarters), so
#: that the in-memory value and interval are the reference's bit for bit
DYADIC = {"exact_match", "contains", "llm_judge", "faithfulness", "context_relevance"}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))


def _sim(mod, provider="openai", model="gpt-4o-mini"):
    return mod.engines.SimulatedAPIEngine(
        mod.EngineModelConfig(provider=provider, model_name=model))


# -- the judge --------------------------------------------------------------------------


def _graded(n):
    """Questions and simulated answers of two model tiers (``flub`` fillers
    in the weaker), enough of them that the judge's rare malformed answer
    shows."""
    rows = jax_data.mixed_examples(n, seed=3)
    qs = [r["question"] for r in rows]
    good = [R.engines.simulated_answer(q, 64, "gpt-4o") for q in qs]
    weak = [R.engines.simulated_answer(q, 64, "gpt-3.5-turbo") for q in qs]
    return qs, good, weak


def test_templates_and_extract_score_equal_the_reference():
    assert judge.POINTWISE_TEMPLATE == jax_judge.POINTWISE_TEMPLATE
    assert judge.PAIRWISE_TEMPLATE == jax_judge.PAIRWISE_TEMPLATE
    texts = ["Score: 4. ok", "score=2", "SCORE : 5.0", "Score: 7", "Score: 0", "no",
             "the score is 3", "Score: 2.5 of 5", "Winner: A", ""]
    for scale in (5, 10):
        assert [judge.extract_score(t, scale) for t in texts] == [
            jax_judge.extract_score(t, scale) for t in texts]


@pytest.mark.parametrize("scale,rubric", [(5, "helpfulness and accuracy"), (10, "brevity")])
def test_pointwise_judge_equals_the_reference(scale, rubric):
    qs, good, weak = _graded(1800)
    bad = 0
    for resp in (good, weak):
        want = jax_judge.pointwise_judge(_sim(R), qs, resp, scale=scale, rubric=rubric)
        got = judge.pointwise_judge(_sim(P), qs, resp, scale=scale, rubric=rubric)
        _eq(got.scores, want.scores)
        assert got.unparseable == want.unparseable
        assert got.unparseable_rate == want.unparseable_rate
        bad += len(got.unparseable)
    if scale == 5:
        assert bad  # the simulated judge's rare malformed answer showed


@pytest.mark.parametrize("debias", [True, False])
def test_pairwise_judge_equals_the_reference(debias):
    qs, good, weak = _graded(1800)
    want = jax_judge.pairwise_judge(_sim(R), qs, good, weak, debias_position=debias)
    got = judge.pairwise_judge(_sim(P), qs, good, weak, debias_position=debias)
    _eq(got.scores, want.scores)
    assert got.unparseable == want.unparseable
    if debias:
        assert (got.scores == 0.5).any()  # the two orders disagreed somewhere


def test_rag_metrics_equal_the_reference():
    rows = jax_data.rag_examples(300, seed=2)
    qs = [r["question"] for r in rows]
    refs = [r["reference"] for r in rows]
    ctxs = [r["contexts"] for r in rows]
    answers = [R.engines.simulated_answer(q, 64, "claude-3-haiku") for q in qs]
    _eq(rag.faithfulness(_sim(P), answers, ctxs), jax_rag.faithfulness(_sim(R), answers, ctxs))
    _eq(rag.context_relevance(_sim(P), qs, ctxs, scale=7),
        jax_rag.context_relevance(_sim(R), qs, ctxs, scale=7))
    _eq(rag.context_precision(ctxs, refs), jax_rag.context_precision(ctxs, refs))
    _eq(rag.context_precision(ctxs, refs, overlap_threshold=0.9),
        jax_rag.context_precision(ctxs, refs, overlap_threshold=0.9))
    _eq(rag.context_recall(ctxs, refs), jax_rag.context_recall(ctxs, refs))
    assert rag.context_recall([["x"]], [""]).tolist() == jax_rag.context_recall([["x"]], [""]).tolist()
    np.testing.assert_allclose(rag.answer_relevance(qs, answers),
                               jax_rag.answer_relevance(qs, answers), rtol=0, atol=1e-6)


# -- the sources ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "qa_examples", "summarization_examples", "instruction_examples", "mixed_examples",
    "iter_qa_examples", "iter_summarization_examples", "iter_instruction_examples",
    "iter_mixed_examples", "rag_examples"])
def test_sources_equal_the_reference(name):
    for n, seed in ((0, 0), (1, 5), (31, 0), (200, 9)):
        assert list(getattr(data, name)(n, seed)) == list(getattr(jax_data, name)(n, seed))


# -- run_task with every metric -----------------------------------------------------------


def _metric_task(mod, *, streaming, backend="numpy", model=None, **inference):
    task = mod.EvalTask(
        "rag",
        model=model or mod.EngineModelConfig(provider="anthropic", model_name="claude-3-haiku"),
        inference=mod.InferenceConfig(**inference),
        metrics=tuple(mod.MetricConfig(m, type=t) for m, t in METRICS),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200, backend=backend),
    )
    return task.with_streaming(max_memory_rows=7) if streaming else task


def _run(mod, rows, task, **kw):
    with mod.EvalSession(**({} if mod is R else {"device": "cpu"}), **kw) as s:
        return s.run_task(rows, task)


def _assert_metrics_equal(p, j):
    """Equal metrics: bit for bit where the scores are dyadic, or streaming
    (host f64 sums of equal scores); the hash-embedding metrics' scores
    differ by up to 1e-6 (f32 sums in other orders), so streaming their
    intervals agree within 1e-5.  In memory, non-dyadic f32 replicate means
    are a few ulps apart and BCa can move an end to a neighbouring
    replicate mean: the value within 1e-6 and the ends within the widest
    gap between two of the reference's sorted replicate means, as in
    ``tests/test_torch_inmemory.py``."""
    assert sorted(p.metrics) == sorted(j.metrics) == sorted(m for m, _ in METRICS)
    for name, jm in j.metrics.items():
        pm = p.metrics[name]
        assert (pm.n, pm.n_unscored, pm.ci_method) == (jm.n, jm.n_unscored, jm.ci_method), name
        if p.stream_stats is not None and name in EMBEDDED:
            np.testing.assert_allclose([pm.value, *pm.ci], [jm.value, *jm.ci],
                                       rtol=0, atol=1e-5, err_msg=name)
        elif p.stream_stats is not None or name in DYADIC or jm.n == 0:
            _eq([pm.value, *pm.ci], [jm.value, *jm.ci])
        else:
            reps = np.sort(jax_boot._resample_stats(
                jnp.asarray(j.scores[name][~np.isnan(j.scores[name])], jnp.float32),
                jnp.mean, 200, 0))
            np.testing.assert_allclose(pm.value, jm.value, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(pm.ci, jm.ci, rtol=0,
                                       atol=float(np.diff(reps).max()) + 1e-6, err_msg=name)


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("judged_by", ["judge-engine", "task-engine"])
def test_run_task_with_thirteen_metrics_equals_the_reference(streaming, judged_by):
    rows = jax_data.rag_examples(30, seed=1)
    out = {}
    for mod in (R, P):
        kw = {"judge_engine": _sim(mod)} if judged_by == "judge-engine" else {}
        out[mod] = _run(mod, rows, _metric_task(mod, streaming=streaming), **kw)
    p, j = out[P], out[R]
    assert p.responses == j.responses and p.engine_stats == j.engine_stats
    _assert_metrics_equal(p, j)
    # judge calls are not the task's engine calls, in either package
    assert p.engine_stats["calls"] == len(rows)
    if streaming:
        assert p.logs.keys() == j.logs.keys() == {"streaming"}
    else:
        assert p.logs == j.logs and "judge_unparseable" in p.logs
        for name, s in j.scores.items():
            if name in EMBEDDED:
                np.testing.assert_allclose(p.scores[name], s, rtol=0, atol=1e-6)
            else:
                _eq(p.scores[name], s)
        assert np.isfinite(p.scores["llm_judge"]).any()


def test_judge_params_bind_and_hash_as_the_reference():
    rows = jax_data.qa_examples(12)
    cfgs = {mod: mod.MetricConfig("llm_judge", type="llm_judge",
                                  params={"rubric": "concision", "scale": 10})
            for mod in (R, P)}
    assert hash(cfgs[P]) == hash(cfgs[R]) and cfgs[P] == P.MetricConfig(
        "llm_judge", type="llm_judge", params={"scale": 10, "rubric": "concision"})
    out = {}
    for mod in (R, P):
        task = mod.EvalTask("p", model=mod.EngineModelConfig(provider="openai",
                                                             model_name="gpt-4o"),
                            metrics=(cfgs[mod],))
        hash(task)
        out[mod] = _run(mod, rows, task)
    _eq(out[P].scores["llm_judge"], out[R].scores["llm_judge"])
    assert out[P].scores["llm_judge"].max() > 5  # the 1-10 scale reached the judge


def test_a_judge_metric_without_a_judge_raises():
    ctx = registry.MetricContext(device=torch.device("cpu"))
    rows = [{"question": "q", "reference": "r", "contexts": ["c"]}]
    for name in sorted(registry.JUDGE_METRICS):
        with pytest.raises(ValueError, match="judge engine"):
            registry.get_metric(P.MetricConfig(name))(rows, ["a"], ctx)
    assert registry.JUDGE_METRICS == jax_registry.JUDGE_METRICS
    assert registry.available_metrics() == jax_registry.available_metrics()


# -- a judge that never answers in format ---------------------------------------------------


class _JaxF32:
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


def test_unparseable_judge_gives_the_references_empty_metrics(f32):
    rows = jax_data.rag_examples(6, seed=0)
    kw = {"engine_kwargs": {"n_slots": 4, "max_len": 64}}
    runs = {}
    for mod, provider in ((R, "local"), (P, "torch_local")):
        model = mod.EngineModelConfig(provider=provider, model_name="qwen3-4b",
                                      reduced=True, seed=0, max_tokens=6)
        runs[mod, "mem"] = _run(mod, rows, _metric_task(mod, streaming=False, model=model), **kw)
        runs[mod, "numpy"] = _run(mod, rows, _metric_task(mod, streaming=True, model=model), **kw)
        if mod is P:
            runs[P, "device"] = _run(P, rows, _metric_task(P, streaming=True, model=model,
                                                           backend="device"), **kw)
    for kind in ("mem", "numpy"):
        p, j = runs[P, kind], runs[R, kind]
        assert p.responses == j.responses
        _assert_metrics_equal(p, j)
    mem = runs[P, "mem"]
    assert len(mem.logs["judge_unparseable"]) == len(rows)
    assert mem.logs == runs[R, "mem"].logs
    for name in ("llm_judge", "faithfulness", "context_relevance"):
        assert np.isnan(mem.scores[name]).all()
        for kind in ("mem", "numpy", "device"):
            mv = runs[P, kind].metrics[name]
            assert (mv.n, mv.n_unscored, mv.ci_method) == (0, len(rows), "none")
            assert np.isnan([mv.value, *mv.ci]).all()
    # the device backend's replicate state of an all-NaN column is empty
    dev = runs[P, "device"].stream_stats
    assert not dev.engine.view("llm_judge").sum_w.any()
    # the paired streaming comparison of an all-NaN metric, as the reference's
    pst, jst = runs[P, "numpy"].stream_stats, runs[R, "numpy"].stream_stats
    assert pst.comparable_with(pst) is None and jst.comparable_with(jst) is None
    with np.errstate(all="ignore"):
        try:
            want = jax_compare_stream("llm_judge", jst, jst)
        except Exception as e:  # noqa: BLE001 — the port must fail the same way
            with pytest.raises(type(e)):
                compare_stream_stats("llm_judge", pst, pst)
        else:
            got = compare_stream_stats("llm_judge", pst, pst)
            _eq([got.diff, *got.diff_ci, got.test.statistic, got.test.p_value, got.n],
                [want.diff, *want.diff_ci, want.test.statistic, want.test.p_value, want.n])
