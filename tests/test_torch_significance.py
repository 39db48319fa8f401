"""The port's significance machinery against the JAX package's, bit for
bit: the special functions, the paired tests (t, McNemar exact and
chi-squared, Wilcoxon exact and normal, the sign-flip permutation test),
the effect sizes, Shapiro-Wilk and the Table 2 test selection.  Both
packages hold this arithmetic in host float64 numpy and pure Python, so
every statistic and p-value must be equal, not close (tolerance 0).  Inputs
come from fixed numpy seeds and from hypothesis."""

import math

import numpy as np
import pytest

from repro.stats import effect as jax_effect
from repro.stats import select as jax_select
from repro.stats import significance as jax_sig
from repro.stats import special as jax_special
from repro_torch.stats import effect, select, significance, special
from _hypothesis_compat import given, settings, st


def _same(a, b):
    """Equal bit for bit (NaN equal to NaN)."""
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


# -- special -----------------------------------------------------------------------


@pytest.mark.parametrize("x", [-8.5, -1.0, 0.0, 0.3, 1.96, 6.0, 38.0])
def test_norm_sf_equals_the_reference(x):
    assert _same(special.norm_sf(x), jax_special.norm_sf(x))


@pytest.mark.parametrize("a", [0.5, 1.0, 2.5, 17.0, 240.0])
@pytest.mark.parametrize("x", [0.0, 1e-3, 0.7, 3.5, 20.0, 400.0])
def test_gammainc_takes_both_branches_as_the_reference(a, x):
    got = special.gammainc(a, x)
    assert _same(got, jax_special.gammainc(a, x))
    if x > 0:
        branch = special._gser if x < a + 1.0 else special._gcf
        ref = jax_special._gser if x < a + 1.0 else jax_special._gcf
        assert _same(branch(a, x), ref(a, x))


@pytest.mark.parametrize("df", [1.0, 3.0, 29.0, 1000.0])
@pytest.mark.parametrize("x", [0.0, 0.5, 2.0, 11.0])
def test_t_and_chi2_tails_equal_the_reference(df, x):
    assert _same(special.t_sf(x, df), jax_special.t_sf(x, df))
    assert _same(special.chi2_sf(x, df), jax_special.chi2_sf(x, df))
    assert _same(special.chi2_sf(-x - 1, df), jax_special.chi2_sf(-x - 1, df))


@pytest.mark.parametrize("n", [1, 9, 40])
def test_binomial_test_equals_the_reference(n):
    for k in range(n + 1):
        assert _same(special.binom_pmf(k, n, 0.5), jax_special.binom_pmf(k, n, 0.5))
        assert _same(special.binom_test_two_sided(k, n),
                     jax_special.binom_test_two_sided(k, n))


def test_distribution_errors_match_the_reference():
    for fn, args in ((special.gammainc, (0.0, 1.0)), (special.gammainc, (1.0, -1.0)),
                     (special.t_ppf, (1.0, 3.0)), (special.norm_ppf, (2.0,))):
        ref = getattr(jax_special, fn.__name__)
        with pytest.raises(ValueError):
            fn(*args)
        with pytest.raises(ValueError):
            ref(*args)


# -- the paired tests ------------------------------------------------------------


def _pair(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        a = (rng.random(n) < 0.55).astype(np.float64)
        b = (rng.random(n) < 0.45).astype(np.float64)
    elif kind == "ties":  # ordinal scores with many ties and zero differences
        a = rng.integers(0, 5, n) / 4.0
        b = rng.integers(0, 5, n) / 4.0
    elif kind == "skewed":
        a = rng.exponential(1.0, n)
        b = a * rng.uniform(0.7, 1.2, n)
    else:
        a = rng.normal(0.6, 0.2, n)
        b = rng.normal(0.55, 0.2, n)
    return a, b


def _rec(r):
    return (r.test, r.reason, r.normal_p)


def _test_result_equal(got, want):
    assert got.test == want.test and got.n == want.n and got.detail == want.detail
    assert _same(got.statistic, want.statistic) and _same(got.p_value, want.p_value)


KINDS = ["binary", "ties", "skewed", "normal"]
SIZES = [1, 3, 8, 25, 26, 64, 500]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_paired_tests_equal_the_reference(kind, n):
    a, b = _pair(kind, n, seed=n)
    for name in ("paired_t_test", "mcnemar_test", "wilcoxon_signed_rank"):
        _test_result_equal(getattr(significance, name)(a, b),
                           getattr(jax_sig, name)(a, b))
    _test_result_equal(significance.permutation_test(a, b, n_perm=300, seed=n),
                       jax_sig.permutation_test(a, b, n_perm=300, seed=n))
    _test_result_equal(
        significance.permutation_test(a, b, n_perm=200, seed=1, stat="median"),
        jax_sig.permutation_test(a, b, n_perm=200, seed=1, stat="median"))


def test_mcnemar_and_wilcoxon_take_every_branch():
    """Exact McNemar (< 10 discordant pairs), chi-squared, no discordance;
    exact Wilcoxon (n <= 25) and the normal approximation; all-zero
    differences."""
    a = np.array([1, 1, 0, 0, 1, 0, 1, 1], float)
    b = np.array([1, 0, 0, 1, 0, 0, 0, 1], float)
    seen = set()
    for x, y in ((a, b), (a, a), *(_pair("binary", n, 9) for n in (200, 12))):
        got, want = significance.mcnemar_test(x, y), jax_sig.mcnemar_test(x, y)
        _test_result_equal(got, want)
        seen.add(got.test if got.detail["n01"] + got.detail["n10"] else "none")
    assert seen == {"mcnemar_exact", "mcnemar", "none"}
    seen = set()
    for x, y in (_pair("normal", 20, 1), _pair("normal", 80, 2), (a, a)):
        got, want = (significance.wilcoxon_signed_rank(x, y),
                     jax_sig.wilcoxon_signed_rank(x, y))
        _test_result_equal(got, want)
        seen.add((got.test, got.n > 0))
    assert seen == {("wilcoxon_exact", True), ("wilcoxon", True), ("wilcoxon", False)}


@settings(max_examples=60, deadline=None)
@given(
    n=st.integers(min_value=2, max_value=60),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    kind=st.sampled_from(KINDS),
)
def test_recommended_tests_equal_the_reference_property(n, seed, kind):
    a, b = _pair(kind, n, seed)
    got, want = select.recommend_test(a, b), jax_select.recommend_test(a, b)
    assert _rec(got) == _rec(want)
    _test_result_equal(select.run_recommended(a, b, seed=seed % 1000),
                       jax_select.run_recommended(a, b, seed=seed % 1000))


# -- effect sizes and selection ------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 3, 40])
def test_effect_sizes_equal_the_reference(kind, n):
    a, b = _pair(kind, n, seed=100 + n)
    for name in ("cohens_d", "hedges_g", "odds_ratio"):
        got, want = getattr(effect, name)(a, b), getattr(jax_effect, name)(a, b)
        assert got.name == want.name and got.magnitude == want.magnitude
        assert _same(got.value, want.value), name
    mom = (float(a.mean()), float(a.var(ddof=1)) if n > 1 else 0.0, n,
           float(b.mean()), float(b.var(ddof=1)) if n > 1 else 0.0, n)
    got, want = effect.hedges_g_from_moments(*mom), jax_effect.hedges_g_from_moments(*mom)
    assert (got.name, got.magnitude) == (want.name, want.magnitude)
    assert _same(got.value, want.value)


@pytest.mark.parametrize("n", [3, 4, 5, 11, 12, 300, 6000])
@pytest.mark.parametrize("kind", ["normal", "skewed", "ties"])
def test_shapiro_wilk_equals_the_reference(n, kind):
    x = _pair(kind, n, seed=n)[0]
    w, p = select.shapiro_wilk(x)
    jw, jp = jax_select.shapiro_wilk(x)
    assert _same(float(w), float(jw)) and _same(float(p), float(jp))


def test_recommendations_cover_table_2():
    cases = {"mcnemar": _pair("binary", 50, 0), "paired_t": _pair("normal", 200, 3),
             "wilcoxon": _pair("skewed", 200, 4)}
    for test, (a, b) in cases.items():
        got, want = select.recommend_test(a, b), jax_select.recommend_test(a, b)
        assert _rec(got) == _rec(want) and got.test == test
        assert select.is_binary(a) == jax_select.is_binary(a)
