"""The port's anytime-valid sequential statistics
(``repro_torch.stats.sequential``) against the JAX package's
``repro.stats.sequential``, on the CPU and bit for bit: the mixture
boundary over a grid of (n, variance, rho, alpha), ``rho_opt``,
``sequential_ci`` under both methods, ``certify_verdict`` over its cases,
the ``StoppingRule``'s fingerprint and decisions on the same accumulators,
and ``sequential_compare`` / ``paired_delta_variance`` on the same pair of
engine states.  The seeded coverage and false-certification guarantees
run on the port alone."""

import dataclasses
import itertools
import math

import numpy as np
import pytest

import repro.stats as RS
import repro.stats.sequential as RQ
import repro_torch.stats as PS
import repro_torch.stats.sequential as PQ

ALPHA = 0.05
#: binomial noise allowance on the empirical rates (400 simulations)
SLACK = 0.035


def _accs(values):
    out = []
    for mod in (PS, RS):
        a = mod.MetricAccumulator()
        a.update(np.asarray(values, np.float64))
        out.append(a)
    return out


def _same(a, b):
    """Equal as floats, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def _same_fields(p, j):
    pd, jd = dataclasses.asdict(p), dataclasses.asdict(j)
    assert pd.keys() == jd.keys()
    for k in pd:
        assert _same(pd[k], jd[k]), (k, pd[k], jd[k])


@pytest.mark.parametrize("alpha", [0.001, 0.05, 0.2])
def test_rho_opt_equals_the_reference(alpha):
    for n in (1, 2, 16, 100, 256, 10_000, 10**7):
        assert PQ.rho_opt(n, alpha) == RQ.rho_opt(n, alpha)
    for bad in ((0, alpha), (10, 0.0), (10, 1.5)):
        with pytest.raises(ValueError) as pe:
            PQ.rho_opt(*bad)
        with pytest.raises(ValueError) as je:
            RQ.rho_opt(*bad)
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("alpha", [0.01, 0.05, 0.1])
def test_mixture_half_width_grid_equals_the_reference(alpha):
    ns = (0, 1, 2, 7, 16, 48, 100, 1024, 10**6)
    variances = (0.0, 1e-9, 0.01, 0.25, 1.0, 4.0)
    rhos = (0.0, 0.01, 0.1, 0.5, 2.0)
    for n, var, rho in itertools.product(ns, variances, rhos):
        p = PQ.mixture_half_width(var, n, alpha=alpha, rho=rho)
        j = RQ.mixture_half_width(var, n, alpha=alpha, rho=rho)
        assert p == j, (n, var, rho, p, j)


@pytest.mark.parametrize("method", ["acs", "mixture"])
def test_sequential_ci_equals_the_reference(method):
    rng = np.random.default_rng(3)
    cases = [[], [0.7], [0.0, 0.0], [0.5] * 40, list(rng.random(200)),
             list((rng.random(333) < 0.3).astype(float)),
             [float("nan"), 0.2, 0.9, float("nan")]]
    for values, rho, scale in itertools.product(cases, (0.0, 0.05), (0.5, 1.0)):
        pa, ja = _accs(values)
        p = PQ.sequential_ci(pa, alpha=ALPHA, rho=rho, method=method, scale=scale)
        j = RQ.sequential_ci(ja, alpha=ALPHA, rho=rho, method=method, scale=scale)
        _same_fields(p, j)
        assert p.as_tuple() == j.as_tuple() or math.isnan(p.lo)
    with pytest.raises(ValueError, match="unknown sequential method"):
        PQ.sequential_ci(_accs([0.1, 0.2])[0], method="bonferroni")


def test_certify_verdict_cases_equal_the_reference():
    bounds = (float("-inf"), -0.2, -0.06, -0.05, -0.01, 0.0, 0.01, 0.05, 0.06,
              0.2, float("inf"), float("nan"))
    seen = set()
    for lo, hi, margin in itertools.product(bounds, bounds, (0.0, 0.05)):
        v = PQ.certify_verdict(lo, hi, margin)
        assert v == RQ.certify_verdict(lo, hi, margin), (lo, hi, margin)
        seen.add(v)
    assert seen == set(PQ.VERDICTS) == set(RQ.VERDICTS)


RULES = [
    dict(),
    dict(enabled=True, target_half_width=0.02),
    dict(enabled=True, target_half_width=0.2, min_examples=16),
    dict(enabled=True, metric="a", target_half_width=0.3, min_examples=16),
    dict(enabled=True, min_examples=10, max_examples=200),
    dict(enabled=True, target_half_width=0.1, alpha=0.01, rho=0.05),
    dict(enabled=True, target_half_width=0.1, method="mixture", margin=0.02),
]


@pytest.mark.parametrize("kw", RULES)
def test_stopping_rule_fingerprint_and_decisions_equal_the_reference(kw):
    pr, jr = PQ.StoppingRule(**kw), RQ.StoppingRule(**kw)
    assert dataclasses.asdict(pr) == dataclasses.asdict(jr)
    assert pr.fingerprint() == jr.fingerprint()
    assert pr.effective_rho() == jr.effective_rho()
    rng = np.random.default_rng(1)
    streams = {"a": rng.random(400), "b": (rng.random(400) < 0.4).astype(float),
               "c": np.full(400, 0.5)}
    for n in (8, 16, 50, 100, 150, 199, 200, 256, 400):
        p_accs, j_accs = {}, {}
        for name, x in streams.items():
            p_accs[name], j_accs[name] = _accs(x[:n])
        pd, jd = pr.should_stop(p_accs, n), jr.should_stop(j_accs, n)
        _same_fields(pd, jd)
        ci_p, ci_j = pr.ci(p_accs["a"]), jr.ci(j_accs["a"])
        _same_fields(ci_p, ci_j)


def test_stopping_rule_refuses_an_unknown_metric_as_the_reference():
    kw = dict(enabled=True, metric="bleu", target_half_width=0.1)
    pa, ja = _accs([1.0, 0.0])
    with pytest.raises(KeyError) as pe:
        PQ.StoppingRule(**kw).should_stop({"exact_match": pa}, 2)
    with pytest.raises(KeyError) as je:
        RQ.StoppingRule(**kw).should_stop({"exact_match": ja}, 2)
    assert str(pe.value) == str(je.value)


def _stream_pair(mod, a_scores, b_scores, *, analytical=False, chunk=50):
    """Two runs' StreamingStats over one chunk layout (numpy engine)."""
    out = []
    for scores in (a_scores, b_scores):
        acc = mod.MetricAccumulator()
        eng = None if analytical else mod.make_bootstrap_engine("numpy", 300, 0, ("m",))
        for lo in range(0, len(scores), chunk):
            part = mod.MetricAccumulator()
            part.update(scores[lo:lo + chunk])
            acc.merge(part)
            if eng is not None:
                e = eng.spawn()
                e.update({"m": scores[lo:lo + chunk]}, lo)
                eng.merge(e)
        out.append(mod.StreamingStats(accs={"m": acc}, engine=eng, chunk_size=chunk,
                                      n_examples=len(scores)))
    return out


@pytest.mark.parametrize("analytical", [False, True])
def test_sequential_compare_on_the_same_states_equals_the_reference(analytical):
    rng = np.random.default_rng(5)
    n = 400
    a = (rng.random(n) < 0.65).astype(float)
    b = (rng.random(n) < 0.5).astype(float)
    a[::37] = np.nan
    p_pair = _stream_pair(PS, a, b, analytical=analytical)
    j_pair = _stream_pair(RS, a, b, analytical=analytical)
    if not analytical:
        np.testing.assert_array_equal(p_pair[0].engine.sum_wx, j_pair[0].engine.sum_wx)
    pv, pp = PQ.paired_delta_variance("m", *p_pair)
    jv, jp = RQ.paired_delta_variance("m", *j_pair)
    assert (pv, pp) == (jv, jp) and pp is not analytical
    for method, margin, rho, alpha in itertools.product(
            ("acs", "mixture"), (0.0, 0.05), (0.0, 0.1), (0.05, 0.2)):
        p = PQ.sequential_compare("m", *p_pair, alpha=alpha, margin=margin,
                                  rho=rho, method=method)
        j = RQ.sequential_compare("m", *j_pair, alpha=alpha, margin=margin,
                                  rho=rho, method=method)
        _same_fields(p, j)
        assert p.summary() == j.summary()


def test_sequential_compare_certifies_separated_streams():
    rng = np.random.default_rng(6)
    a = (rng.random(3000) < 0.8).astype(float)
    b = (rng.random(3000) < 0.4).astype(float)
    c = PQ.sequential_compare("m", *_stream_pair(PS, a, b))
    assert c.paired and c.verdict == "a_better" and c.lo > 0
    same = PQ.sequential_compare("m", *_stream_pair(PS, a, a))
    assert same.verdict == "undecided"


# -- the guarantees under optional stopping (the port alone) --------------------


def _peek_halfwidths(x: np.ndarray, peeks: np.ndarray, rho: float):
    csum, csq = np.cumsum(x), np.cumsum(x * x)
    out = []
    for n in peeks:
        var = (csq[n - 1] - csum[n - 1] ** 2 / n) / (n - 1)
        out.append(PQ.mixture_half_width(max(var, 0.0), int(n), rho=rho))
    return csum[peeks - 1] / peeks, np.array(out)


def test_anytime_coverage_under_continuous_peeking():
    rng = np.random.default_rng(7)
    n_sims, n, mu = 400, 2000, 0.6
    peeks = np.arange(50, n + 1, 50)
    rho = PQ.rho_opt(200, ALPHA)
    misses = fixed_misses = 0
    for _ in range(n_sims):
        x = (rng.random(n) < mu).astype(float)
        means, hw = _peek_halfwidths(x, peeks, rho)
        misses += int(np.any(np.abs(means - mu) > hw))
        fixed_hw = 1.96 * np.sqrt(np.maximum(means * (1 - means), 1e-12) / peeks)
        fixed_misses += int(np.any(np.abs(means - mu) > fixed_hw))
    assert misses / n_sims <= ALPHA + SLACK, misses / n_sims
    assert fixed_misses / n_sims > ALPHA + SLACK


def test_false_certification_rate_under_null_with_optional_stopping():
    rng = np.random.default_rng(11)
    n_sims, n = 400, 2000
    peeks = np.arange(50, n + 1, 50)
    rho = PQ.rho_opt(200, ALPHA)
    false_cert = 0
    for _ in range(n_sims):
        p = rng.uniform(0.3, 0.8)
        d = (rng.random(n) < p).astype(float) - (rng.random(n) < p).astype(float)
        means, hw = _peek_halfwidths(d, peeks, rho)
        for m, w in zip(means, hw):
            if PQ.certify_verdict(m - w, m + w) != "undecided":
                false_cert += 1
                break
    assert false_cert / n_sims <= ALPHA + SLACK, false_cert / n_sims
