"""The reference's default path in the port: in-memory aggregation.

* The port's threefry key split and ``randint`` give the integers of
  ``jax.random`` (threefry2x32, partitionable) bit for bit, and the
  replicate means of exact multinomial resamples equal the reference's on
  dyadic scores.
* ``compute_ci`` under each method, and ``replicate_p_value``, equal the
  reference's: bit for bit on dyadic scores (k / 64, whose f32 sums are
  exact, and whose means both frameworks round as the sum times the f32
  reciprocal of n), to a stated tolerance on seeded uniform scores (XLA
  and torch sum a replicate's f32 mean in other orders).
* ``EvalSession.run_task`` with the default ``StreamingConfig()`` against
  the JAX session with its defaults, on the reduced qwen3-4b weights in f32:
  in memory, BCa at B = 1,000, per-example scores and greedy texts equal.
* Streaming only with ``enabled``: custom stages then raise as the
  reference's do; under ``ci_method="analytical"`` no bootstrap engine is
  built (the reference's is ``None`` too); a task with 13 metric configs
  streams end to end as the reference's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.stages as jax_stages
import repro.models.model as jax_model_mod
import repro_torch.core.engines as port_engines
import repro_torch.core.stages as port_stages
import repro_torch.stats.streaming as port_streaming
from repro.configs import get_config as jax_get_config
from repro.core import EngineModelConfig as JaxModelConfig
from repro.core import EvalSession as JaxSession
from repro.core import EvalTask as JaxTask
from repro.core import InferenceConfig
from repro.core import MetricConfig as JaxMetric
from repro.core import StatisticsConfig as JaxStats
from repro.core import StreamingConfig as JaxStreaming
from repro.data import iter_qa_examples as jax_rows
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro.stats import bootstrap as jax_boot
from repro_torch.configs import get_config
from repro_torch.core import (
    EngineModelConfig,
    EvalSession,
    EvalTask,
    MetricConfig,
    StatisticsConfig,
    StreamingConfig,
    default_stages,
)
from repro_torch.data import iter_qa_examples
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.stats import bootstrap as port_boot
from repro_torch.stats import threefry

N_ROWS, CHUNK, MAX_TOKENS, N_SLOTS, MAX_LEN = 24, 8, 16, 4, 64


# -- threefry: split and randint against jax.random --------------------------------


@pytest.mark.parametrize("seed", [0, 1234, -7])
@pytest.mark.parametrize("n", [1, 7, 64, 1000])
@pytest.mark.parametrize("n_boot", [1, 128, 1000])
def test_split_and_randint_equal_jax_random(seed, n, n_boot):
    keys = jax.random.split(jax.random.key(seed), n_boot)
    want_keys = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    want_idx = np.asarray(
        jax.vmap(lambda k: jax.random.randint(k, (n,), 0, n))(keys)
    )
    got_keys = threefry.split(threefry.key(seed), n_boot)
    got_idx = threefry.randint(got_keys, n, 0, n)
    np.testing.assert_array_equal(got_keys.numpy(), want_keys)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)


@pytest.mark.parametrize("maxval", [3, 65_536, 65_537, 100_000, 2**31 - 1])
def test_randint_folds_wide_spans_as_jax_does(maxval):
    """Spans above 2**16 wrap the multiplier in uint32 (to 0 past it)."""
    key = jax.random.key(11)
    want = np.asarray(jax.random.randint(key, (257,), 0, maxval))
    got = threefry.randint(threefry.key(11), 257, 0, maxval)
    np.testing.assert_array_equal(got.numpy(), want)


def _dyadic(n, seed):
    return (np.random.default_rng(seed).integers(0, 65, n) / 64.0).astype(np.float32)


@pytest.mark.parametrize("n,n_boot", [(24, 1000), (300, 257)])
def test_replicate_means_equal_the_reference_on_dyadic_scores(n, n_boot):
    x = _dyadic(n, n)
    want = jax_boot._resample_stats(jnp.asarray(x), jnp.mean, n_boot, 5)
    got = port_boot.resample_stats(torch.from_numpy(x), n_boot=n_boot, seed=5)
    np.testing.assert_array_equal(got, want)


# -- compute_ci and replicate_p_value ----------------------------------------------


CI_CASES = [("analytical", False), ("analytical", True), ("percentile", False),
            ("bca", False), ("bca", True)]


def _binary(n, seed):
    return (np.random.default_rng(seed).random(n) < 0.3).astype(np.float64)


@pytest.mark.parametrize("method,binary", CI_CASES)
@pytest.mark.parametrize("n", [2, 37, 500])
def test_compute_ci_equals_the_reference_on_dyadic_scores(method, binary, n):
    x = _binary(n, n) if binary else _dyadic(n, n).astype(np.float64)
    kw = dict(method=method, confidence=0.95, n_boot=400, seed=3, binary=binary)
    want = jax_boot.compute_ci(x, **kw)
    got = port_boot.compute_ci(x, **kw)
    assert (got.method, got.n) == (want.method, want.n)
    assert (got.value, got.lo, got.hi) == (want.value, want.lo, want.hi)


@pytest.mark.parametrize("method", ["percentile", "bca"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_ci_agrees_with_the_reference_on_uniform_scores(method, seed):
    """Uniform f32 scores: each replicate mean is one f32 sum of 200 terms
    divided by 200, rounded by XLA and by torch after sums in other orders,
    so a mean may differ by a few ulps (~1e-7 of ~0.5).  The interval ends
    are quantiles of the means, so they differ by as much: 1e-6 allows 10
    ulps.  A wrong index draw moves a mean by ~1e-3."""
    x = np.random.default_rng(seed).random(200).astype(np.float32)
    kw = dict(method=method, n_boot=1000, seed=seed)
    want = jax_boot.compute_ci(x, **kw)
    got = port_boot.compute_ci(x, **kw)
    assert got.method == want.method and got.n == want.n
    np.testing.assert_allclose([got.value, got.lo, got.hi],
                               [want.value, want.lo, want.hi], rtol=0, atol=1e-6)


def test_bca_with_another_statistic_takes_the_jackknife_loop():
    x = _dyadic(40, 9)
    want = jax_boot.bca_bootstrap(x, lambda a: jnp.max(a), n_boot=300, seed=2)
    got = port_boot.bca_bootstrap(x, lambda a: a.max(dim=-1).values, n_boot=300,
                                  seed=2)
    assert (got.value, got.lo, got.hi, got.method) == (
        want.value, want.lo, want.hi, want.method)


def test_unknown_ci_method_raises():
    with pytest.raises(ValueError, match="unknown ci method"):
        port_boot.compute_ci(np.ones(3), method="jackknife")


@pytest.mark.parametrize("null", [0.0, 0.25, -1.0])
def test_replicate_p_value_equals_the_reference(null):
    reps = np.random.default_rng(4).normal(0.2, 0.3, 999)
    assert port_boot.replicate_p_value(reps, null) == jax_boot.replicate_p_value(
        reps, null)
    assert port_boot.replicate_p_value([]) == jax_boot.replicate_p_value([]) == 1.0


# -- run_task: the default in-memory path against the JAX session ------------------


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


class _PortF32(TransformerLM):
    def prefill(self, *a, **kw):
        return super().prefill(*a, dtype=torch.float32, **kw)

    def decode_step(self, *a, **kw):
        return super().decode_step(*a, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def port_params():
    """The JAX engine's seed-0 parameters of the reduced model, bridged."""
    model = JaxLM(jax_get_config("qwen3-4b").reduced(), remat="none")
    tree = jax.tree.map(np.asarray,
                        jax_pm.init_params(jax.random.key(0), model.param_specs()))
    return params_from_jax(tree, get_config("qwen3-4b").reduced(), device="cpu",
                           dtype=torch.float32)


INMEM_METRICS = (("exact_match", "lexical"), ("token_f1", "lexical"),
                 ("bleu", "lexical"), ("embedding_similarity", "semantic"))


def _jax_task(metrics, stats, streaming):
    return JaxTask(
        task_id="inmemory",
        model=JaxModelConfig(provider="local", model_name="qwen3-4b",
                             reduced=True, seed=0, max_tokens=MAX_TOKENS),
        inference=InferenceConfig(cache_dir="", n_workers=2),
        metrics=tuple(JaxMetric(m, type=t, params=p) for m, t, p in metrics),
        statistics=stats,
        streaming=streaming,
    )


def _port_task(metrics, stats, streaming):
    return EvalTask(
        task_id="inmemory",
        model=EngineModelConfig(provider="torch_local", model_name="qwen3-4b",
                                reduced=True, seed=0, max_tokens=MAX_TOKENS),
        metrics=tuple(MetricConfig(m, type=t, params=p) for m, t, p in metrics),
        statistics=stats,
        streaming=streaming,
    )


def _run_jax(monkeypatch, task):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model",
                        lambda cfg, **kw: _JaxF32(build(cfg, **kw)))
    with JaxSession(engine_kwargs={"n_slots": N_SLOTS, "max_len": MAX_LEN}) as s:
        return s.run_task(jax_rows(N_ROWS, seed=0), task)


def _run_port(monkeypatch, params, task, **kw):
    monkeypatch.setattr(port_engines, "build_model", _PortF32)
    ekw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cpu", engine_kwargs=ekw) as s:
        return s.run_task(iter_qa_examples(N_ROWS, seed=0), task, **kw)


def test_default_task_runs_in_memory_as_the_reference(monkeypatch, port_params):
    metrics = [(m, t, {}) for m, t in INMEM_METRICS]
    jres = _run_jax(monkeypatch, _jax_task(metrics, JaxStats(), JaxStreaming()))
    pres = _run_port(monkeypatch, port_params,
                     _port_task(metrics, StatisticsConfig(), StreamingConfig()))
    assert StreamingConfig().enabled is False and pres.stream_stats is None
    assert len(pres.responses) == N_ROWS and pres.responses == jres.responses
    assert set(pres.timing) == {"prepare_s", "infer_s", "metrics_s", "stats_s"}
    assert list(pres.metrics) == [m for m, _ in INMEM_METRICS]
    for name, kind in INMEM_METRICS:
        j, p = jres.metrics[name], pres.metrics[name]
        assert p.ci_method == j.ci_method == "bca"
        assert (p.n, p.n_unscored) == (j.n, j.n_unscored) == (N_ROWS, 0)
        assert pres.scores[name].shape == (N_ROWS,)
        if kind == "lexical":
            # equal tokens give equal scores
            np.testing.assert_array_equal(pres.scores[name], jres.scores[name])
        else:
            # f32 hash embeddings matched in another order: 1e-6 a score
            np.testing.assert_allclose(pres.scores[name], jres.scores[name],
                                       rtol=0, atol=1e-6)
        if name == "exact_match":
            # 0/1 scores: every f32 sum exact, so the interval bit for bit
            assert (p.value, p.ci) == (j.value, j.ci)
            continue
        # other scores: f32 means summed in another order than XLA's, a few
        # ulps apart (the semantic scores' 1e-6 on top).  The replicate
        # means agree to that; BCa's bias correction counts the means below
        # the estimate, so an ulp can move an end to a neighbouring
        # replicate mean: the ends agree within the widest gap between two.
        reps_j = np.sort(jax_boot._resample_stats(
            jnp.asarray(jres.scores[name], jnp.float32), jnp.mean, 1000, 0))
        reps_p = np.sort(port_boot.resample_stats(
            torch.from_numpy(pres.scores[name].astype(np.float32)),
            n_boot=1000, seed=0))
        np.testing.assert_allclose(reps_p, reps_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p.value, j.value, rtol=1e-5, atol=1e-6)
        gap = float(np.diff(reps_j).max())
        np.testing.assert_allclose(p.ci, j.ci, rtol=0, atol=gap + 1e-6)
        assert p.ci[0] <= p.value <= p.ci[1]


def test_stages_with_streaming_raise_as_the_reference(monkeypatch, port_params):
    metrics = [("exact_match", "lexical", {})]
    jtask = _jax_task(metrics, JaxStats(), JaxStreaming(enabled=True))
    with JaxSession() as s, pytest.raises(ValueError) as jerr:
        s.run_task(jax_rows(2, seed=0), jtask, stages=jax_stages.default_stages())
    ptask = _port_task(metrics, StatisticsConfig(), StreamingConfig(enabled=True))
    with pytest.raises(ValueError) as perr:
        _run_port(monkeypatch, port_params, ptask, stages=default_stages())
    assert str(perr.value) == str(jerr.value)
    assert ptask.with_streaming(max_memory_rows=4).streaming.enabled
    assert not ptask.with_streaming(enabled=False).streaming.enabled


def test_custom_stages_run_in_memory(monkeypatch, port_params):
    metrics = [("exact_match", "lexical", {})]
    task = _port_task(metrics, StatisticsConfig(ci_method="analytical"),
                      StreamingConfig())
    stages = default_stages()[:3]  # no aggregation
    res = _run_port(monkeypatch, port_params, task, stages=stages)
    assert res.metrics == {} and res.scores["exact_match"].shape == (N_ROWS,)
    assert set(res.timing) == {"prepare_s", "infer_s", "metrics_s"}


# -- streaming: analytical builds no engine; 13 metric configs ---------------------


def test_analytical_streaming_builds_no_engine(monkeypatch, port_params):
    def refuse(*a, **kw):
        raise AssertionError("a bootstrap engine was built under analytical")

    metrics = [(m, t, {}) for m, t in INMEM_METRICS]
    jres = _run_jax(monkeypatch, _jax_task(
        metrics, JaxStats(ci_method="analytical", backend="pallas"),
        JaxStreaming(enabled=True, max_memory_rows=CHUNK)))
    monkeypatch.setattr(port_streaming.DeviceBootstrapEngine, "__init__", refuse)
    pres = _run_port(monkeypatch, port_params, _port_task(
        metrics, StatisticsConfig(ci_method="analytical"),
        StreamingConfig(enabled=True, max_memory_rows=CHUNK)))
    assert pres.stream_stats.engine is None and jres.stream_stats.engine is None
    assert pres.logs["streaming"]["stats_stream"] is None
    assert (pres.logs["streaming"]["stats_backend"]
            == jres.logs["streaming"]["stats_backend"] == "")
    for name, kind in INMEM_METRICS:
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.ci_method, p.n) == (j.ci_method, j.n)
        # the moments are f64 sums of the same scores (semantic: within 1e-6)
        np.testing.assert_allclose([p.value, *p.ci], [j.value, *j.ci],
                                   rtol=0, atol=1e-12 if kind == "lexical" else 1e-5)


#: 13 metric configs, repeats included: the statistics engine gets one
#: column per config (the device kernel takes them in two launches)
THIRTEEN = (
    ("exact_match", "lexical", {}), ("contains", "lexical", {}),
    ("token_f1", "lexical", {}), ("bleu", "lexical", {}),
    ("rouge_l", "lexical", {}), ("embedding_similarity", "semantic", {}),
    ("bertscore", "semantic", {"max_len": 16}),
    ("exact_match", "lexical", {"normalized": False}),
    ("contains", "lexical", {"normalized": False}),
    ("token_f1", "lexical", {}), ("bleu", "lexical", {}),
    ("rouge_l", "lexical", {}), ("embedding_similarity", "semantic", {}),
)


def test_thirteen_metric_configs_stream_as_the_reference(monkeypatch, port_params):
    stream = dict(enabled=True, max_memory_rows=CHUNK)
    jres = _run_jax(monkeypatch, _jax_task(
        THIRTEEN, JaxStats(bootstrap_iterations=200, ci_method="percentile",
                           backend="pallas"), JaxStreaming(**stream)))
    pres = _run_port(monkeypatch, port_params, _port_task(
        THIRTEEN, StatisticsConfig(bootstrap_iterations=200, ci_method="percentile",
                                   backend="device"),
        StreamingConfig(**stream)))
    assert len(pres.stream_stats.engine.metrics) == 13
    assert list(pres.metrics) == list(jres.metrics)
    for name in jres.metrics:
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.n, p.n_unscored, p.ci_method) == (j.n, j.n_unscored, j.ci_method)
        # the same weights, f32 partials summed in another order (as in
        # test_torch_metrics_slice.py); semantic values within 1e-6
        np.testing.assert_allclose([p.value, *p.ci], [j.value, *j.ci],
                                   rtol=0, atol=1e-5)
