"""The port's statistics (``repro_torch.stats``) against the JAX
package's: the device bootstrap engine against ``PallasBootstrapEngine``
(CPU ref mode) on the same chunked scores, the refusal to merge partials
from another summation stream, the interval methods of ``streaming_ci``,
the special functions, and the statistics API ``bootstrap_ci`` with kernel
5's plain version against the JAX ``bootstrap_means_ref`` and the Pallas
kernel in interpret mode."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bootstrap.bootstrap import bootstrap_means as jax_means_kernel
from repro.kernels.bootstrap.ops import bootstrap_ci as jax_bootstrap_ci
from repro.kernels.bootstrap.ref import bootstrap_means_ref as jax_means_ref
from repro.stats import MetricAccumulator as JaxAccumulator
from repro.stats import PoissonBootstrap as JaxPoissonBootstrap
from repro.stats import make_bootstrap_engine as jax_engine
from repro.stats import special as jax_special
from repro.stats import streaming_ci as jax_streaming_ci
from repro.stats.bootstrap import t_interval as jax_t_interval
from repro.stats.bootstrap import wilson_interval as jax_wilson
from repro_torch.kernels.bootstrap import bootstrap_means, bootstrap_means_ref
from repro_torch.stats import (
    DeviceBootstrapEngine,
    MetricAccumulator,
    bootstrap_ci,
    make_bootstrap_engine,
    streaming_ci,
    t_interval,
    wilson_interval,
)
from repro_torch.stats import special

METRICS = ("exact_match", "token_f1", "other")


def _chunks(seed, sizes=(8, 8, 5)):
    rng = np.random.default_rng(seed)
    out, start = [], 0
    for n in sizes:
        s = {
            "exact_match": (rng.random(n) > 0.6).astype(np.float64),
            "token_f1": rng.random(n),
            "other": np.where(rng.random(n) > 0.8, np.nan, rng.random(n)),
        }
        out.append((s, start))
        start += n
    return out


def _fold(engine, chunks):
    for scores, start in chunks:
        part = engine.spawn()
        part.update(scores, start)
        engine.merge(part)
    return engine


@pytest.mark.parametrize("seed,n_boot", [(0, 200), (1, 64), (2, 1000)])
def test_device_engine_matches_jax_pallas_engine(seed, n_boot):
    chunks = _chunks(seed)
    ours = _fold(make_bootstrap_engine("device", n_boot, 7, METRICS,
                                       device=torch.device("cpu")), chunks)
    theirs = _fold(jax_engine("pallas", n_boot, 7, METRICS), chunks)
    assert ours.stream_id() == "device-ref"
    # identical weights; f32 partials summed in another order
    np.testing.assert_allclose(ours.sum_w, theirs.sum_w, rtol=0)
    np.testing.assert_allclose(ours.sum_wx, theirs.sum_wx, rtol=1e-5)
    for m in METRICS:
        acc, jacc = MetricAccumulator(), JaxAccumulator()
        for scores, _ in chunks:
            acc.update(scores[m])
            jacc.update(scores[m])
        assert (acc.n, acc.total, acc.n_nan) == (jacc.n, jacc.total, jacc.n_nan)
        iv = streaming_ci(acc, ours.view(m), method="percentile")
        jiv = jax_streaming_ci(jacc, theirs.view(m), method="percentile")
        assert (iv.value, iv.n, iv.method) == (jiv.value, jiv.n, jiv.method)
        np.testing.assert_allclose([iv.lo, iv.hi], [jiv.lo, jiv.hi], atol=1e-5)


def test_partials_are_independent_of_the_chunking():
    """Weights are keyed by absolute position: another chunk layout gives
    the same replicate weights (sum w is exact)."""
    scores = _chunks(3, sizes=(21,))[0][0]
    whole = _fold(DeviceBootstrapEngine(128, 1, METRICS, device="cpu"),
                  [(scores, 0)])
    parts = [({m: v[a:b] for m, v in scores.items()}, a)
             for a, b in ((0, 5), (5, 13), (13, 21))]
    split = _fold(DeviceBootstrapEngine(128, 1, METRICS, device="cpu"), parts)
    np.testing.assert_array_equal(whole.sum_w, split.sum_w)
    np.testing.assert_allclose(whole.sum_wx, split.sum_wx, rtol=1e-6)


def test_merge_across_streams_is_refused():
    cpu = DeviceBootstrapEngine(16, 0, METRICS, device="cpu")
    card = DeviceBootstrapEngine(16, 0, METRICS, device=torch.device("cuda"))
    assert card.stream_id() == "device-kernel"
    with pytest.raises(ValueError, match="cannot merge"):
        cpu.merge(card)
    with pytest.raises(ValueError, match="cannot merge"):
        cpu.merge(DeviceBootstrapEngine(16, 1, METRICS, device="cpu"))


def test_unported_methods_and_backends_raise():
    acc = MetricAccumulator()
    acc.update(np.array([1.0, 0.0]))
    boot = DeviceBootstrapEngine(16, 0, ("m",), device="cpu").view("m")
    jacc = JaxAccumulator()
    jacc.update(np.array([1.0, 0.0]))
    for method in ("bootstrap", "BCa", ""):
        with pytest.raises(ValueError, match="unknown ci method"):
            streaming_ci(acc, boot, method=method)
        with pytest.raises(ValueError, match="unknown ci method"):
            jax_streaming_ci(jacc, JaxPoissonBootstrap(16, 0), method=method)
    with pytest.raises(ValueError, match="needs a PoissonBootstrap"):
        streaming_ci(acc, None, method="bca")
    with pytest.raises(ValueError, match="backend"):
        make_bootstrap_engine("bogus", 16, 0, ("m",), device=torch.device("cpu"))
    with pytest.raises(ValueError, match="backend"):
        jax_engine("bogus", 16, 0, ("m",))


# -- streaming_ci's methods ------------------------------------------------------


def _accumulators(scores):
    acc, jacc = MetricAccumulator(), JaxAccumulator()
    for chunk in np.array_split(scores, 3):
        acc.update(chunk)
        jacc.update(chunk)
    return acc, jacc


@pytest.mark.parametrize("kind", ["binary", "graded", "nan", "one", "constant"])
def test_analytical_intervals_equal_the_reference(kind):
    rng = np.random.default_rng(11)
    scores = {
        "binary": (rng.random(57) > 0.3).astype(np.float64),
        "graded": rng.random(57),
        "nan": np.where(rng.random(57) > 0.8, np.nan, rng.random(57)),
        "one": np.array([0.25]),
        "constant": np.full(20, 0.5),
    }[kind]
    acc, jacc = _accumulators(scores)
    assert acc.variance == jacc.variance
    for binary in (False, True):
        for conf in (0.95, 0.9):
            iv = streaming_ci(acc, None, method="analytical", binary=binary,
                              confidence=conf)
            jiv = jax_streaming_ci(jacc, None, method="analytical", binary=binary,
                                   confidence=conf)
            assert (iv.value, iv.lo, iv.hi, iv.method, iv.n) == (
                jiv.value, jiv.lo, jiv.hi, jiv.method, jiv.n)


def test_bca_gives_the_percentile_interval():
    chunks = _chunks(4)
    engine = _fold(make_bootstrap_engine("device", 300, 2, METRICS,
                                         device=torch.device("cpu")), chunks)
    for m in METRICS:
        acc = MetricAccumulator()
        for scores, _ in chunks:
            acc.update(scores[m])
        assert streaming_ci(acc, engine.view(m), method="bca") == streaming_ci(
            acc, engine.view(m), method="percentile")
        # the default method is the reference's, bca
        assert streaming_ci(acc, engine.view(m)) == streaming_ci(
            acc, engine.view(m), method="bca")


def test_empty_accumulator_gives_the_none_interval():
    iv = streaming_ci(MetricAccumulator(), None, method="analytical")
    jiv = jax_streaming_ci(JaxAccumulator(), None, method="analytical")
    assert (iv.method, iv.n, jiv.method, jiv.n) == ("none", 0, "none", 0)
    assert math.isnan(iv.value) and math.isnan(iv.lo) and math.isnan(iv.hi)


@pytest.mark.parametrize("seed", [0, 1])
def test_t_and_wilson_intervals_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 9, 250):
        x = rng.random(n)
        iv, jiv = t_interval(x, confidence=0.9), jax_t_interval(x, confidence=0.9)
        assert (iv.value, iv.lo, iv.hi, iv.method, iv.n) == (
            jiv.value, jiv.lo, jiv.hi, jiv.method, jiv.n)
        for k in (0, n // 3, n):
            iv, jiv = wilson_interval(k, n), jax_wilson(k, n)
            assert (iv.value, iv.lo, iv.hi, iv.method, iv.n) == (
                jiv.value, jiv.lo, jiv.hi, jiv.method, jiv.n)
    iv = wilson_interval(0, 0)
    assert (iv.lo, iv.hi, iv.n) == (0.0, 1.0, 0)


def test_special_functions_equal_the_reference():
    """Pure Python floats on both sides: exactly equal."""
    ps = [1e-12, 1e-6, 0.001, 0.01, 0.02425, 0.025, 0.05, 0.1, 0.3, 0.5, 0.7,
          0.9, 0.95, 0.97575, 0.975, 0.99, 0.999, 1 - 1e-9]
    for p in ps:
        assert special.norm_ppf(p) == jax_special.norm_ppf(p)
        for df in (1, 2, 3, 7.5, 30, 1000, 1e6):
            assert special.t_ppf(p, df) == jax_special.t_ppf(p, df)
    for x in np.linspace(-8, 8, 41):
        assert special.norm_cdf(x) == jax_special.norm_cdf(x)
        for df in (1, 4, 50):
            assert special.t_cdf(x, df) == jax_special.t_cdf(x, df)
    for a, b, x in ((0.5, 0.5, 0.3), (2.0, 5.0, 0.9), (30.0, 0.5, 0.99),
                    (1.0, 1.0, 0.0), (3.0, 2.0, 1.0)):
        assert special.betainc(a, b, x) == jax_special.betainc(a, b, x)
    assert special.norm_ppf(0.0) == -math.inf and special.norm_ppf(1.0) == math.inf
    with pytest.raises(ValueError):
        special.norm_ppf(1.5)
    with pytest.raises(ValueError):
        special.t_ppf(0.0, 3)


# -- bootstrap means and the statistics API ---------------------------------------


@pytest.mark.parametrize("n_boot", [1, 1000])
@pytest.mark.parametrize("n", [1, 1000, 3000])
def test_bootstrap_means_plain_version_matches_jax_ref(n, n_boot):
    rng = np.random.default_rng(n + n_boot)
    x = rng.random(n).astype(np.float32)
    got = bootstrap_means_ref(torch.from_numpy(x), n_boot, 9).numpy()
    want = np.asarray(jax_means_ref(jnp.asarray(x), n_boot, 9))
    # identical weights; f32 sums of n terms in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # a NaN makes every mean NaN in both
    x[n // 2] = np.nan
    got = bootstrap_means_ref(torch.from_numpy(x), n_boot, 9).numpy()
    want = np.asarray(jax_means_ref(jnp.asarray(x), n_boot, 9))
    assert np.isnan(got).all() and np.isnan(want).all()


def test_bootstrap_means_plain_version_matches_pallas_kernel():
    """n = 3000 leaves a ragged third 1,024-row tile."""
    x = np.random.default_rng(5).random(3000).astype(np.float32)
    got = bootstrap_means_ref(torch.from_numpy(x), 256, 4).numpy()
    want = np.asarray(jax_means_kernel(jnp.asarray(x), jnp.uint32(4), n_boot=256,
                                       interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_bootstrap_ci_matches_jax_at_the_default_replicate_count():
    """B = 1000: the JAX Pallas kernel refuses it (its 128-replicate block
    must divide B), so the reference's answer is its jnp path."""
    x = np.random.default_rng(6).random(2500).astype(np.float32)
    for seed in (0, 17):
        got = bootstrap_ci(torch.from_numpy(x), seed)
        want = jax_bootstrap_ci(jnp.asarray(x), seed)
        assert all(t.dtype == torch.float32 and t.dim() == 0 for t in got)
        np.testing.assert_allclose([float(t) for t in got],
                                   [float(t) for t in want], rtol=1e-5)
        assert float(got[1]) <= float(got[0]) <= float(got[2])
    got = bootstrap_ci(torch.from_numpy(x), 3, n_boot=256, confidence=0.9)
    want = jax_bootstrap_ci(jnp.asarray(x), 3, n_boot=256, confidence=0.9,
                            use_pallas=True, interpret=True)
    np.testing.assert_allclose([float(t) for t in got],
                               [float(t) for t in want], rtol=1e-5)
    with pytest.raises(AssertionError):
        jax_bootstrap_ci(jnp.asarray(x), 0, use_pallas=True, interpret=True)


def test_bootstrap_means_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        bootstrap_means(torch.zeros(8), 0, n_boot=4)
    assert bootstrap_means.launches == 0
