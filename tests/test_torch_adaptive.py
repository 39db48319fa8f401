"""The port's adaptive evaluation against the JAX package's, on the CPU,
over the simulated API engine: per-task early stopping in the serial and
the concurrent streaming pipelines (the same stop chunk, decision and
bits as the JAX run), the manifest's stop and regime rows (a stopped run
resumes bit for bit and never reopens; a declared ``max_examples`` cap can
be raised and replayed), and ``run_adaptive_suite`` over two simulated
models that differ in accuracy: the ``adaptive`` payload equal to the
reference's, a replay over the same spill dirs with no engine call,
exhaustion leaving a task undecided, and the input checks."""

import dataclasses
import json

import pytest

import repro.core as R
import repro_torch.core as P
import repro_torch.core.streaming as PJ
import repro_torch.ft as PF
from repro.data import iter_qa_examples as jax_rows
from repro_torch.data import iter_qa_examples as port_rows
from repro_torch.stats.sequential import StoppingRule
from repro_torch.storage.spill import ChunkManifest

#: stops at chunk 2 (n = 150) of the 400-example sources below
RULE = dict(min_examples=100, max_examples=150)


def _task(mod, task_id="adapt", **stream_kw):
    return mod.EvalTask(
        task_id, model=mod.EngineModelConfig(provider="openai", model_name="gpt-4o-mini"),
        inference=mod.InferenceConfig(batch_size=32, n_workers=3, cache_dir=""),
        metrics=(mod.MetricConfig("exact_match"), mod.MetricConfig("token_f1")),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200, ci_method="percentile"),
    ).with_streaming(max_memory_rows=50, **stream_kw)


def _session(mod, **kw):
    return mod.EvalSession(**({"device": "cpu"} if mod is P else {}), **kw)


def _rows(mod, n=400, seed=1):
    return (port_rows if mod is P else jax_rows)(n, seed=seed)


def _metrics(res):
    return {k: (v.value, v.ci, v.n) for k, v in res.metrics.items()}


def _both(tmp_path, build, n=400, seed=1, **session_kw):
    """``build(mod, spill_dir)``'s task run in both packages: (port, jax)
    results and each session's engine calls."""
    out = {}
    for mod in (P, R):
        task = build(mod, str(tmp_path / mod.__name__))
        with _session(mod, **session_kw) as s:
            out[mod] = (s.run_task(_rows(mod, n, seed), task), s.accounting.engine_calls)
    return out[P], out[R]


@pytest.mark.parametrize("concurrency", [1, 3])
def test_early_stop_equals_the_reference(tmp_path, concurrency):
    def build(mod, spill):
        return _task(mod, spill_dir=spill, concurrency=concurrency).with_stopping(**RULE)

    (port, pcalls), (jax, jcalls) = _both(tmp_path, build)
    assert port.logs["adaptive"] == jax.logs["adaptive"]
    ad = port.logs["adaptive"]
    assert ad["stopped"] and ad["reason"] == "max_examples"
    assert (ad["stop_chunk"], ad["n_examples"]) == (2, 150)
    assert _metrics(port) == _metrics(jax)
    assert port.logs["streaming"]["n_examples"] == 150
    if concurrency == 1:
        # in-flight chunks past the stop may run in a concurrent run; the
        # serial one never pulls them
        assert pcalls == jcalls == 150
    task = build(P, str(tmp_path / P.__name__))
    stop = ChunkManifest(str(tmp_path / P.__name__), PJ._run_key(task)).stop_row()
    assert int(stop["stop_chunk"]) == 2 and stop["rule"] == task.stopping.fingerprint()
    regime = ChunkManifest(str(tmp_path / P.__name__), PJ._run_key(task)).regime_row()
    assert regime["rule"] == task.stopping.fingerprint()


def test_width_stop_equals_the_reference(tmp_path):
    def build(mod, spill):
        return _task(mod, spill_dir=spill).with_stopping(
            metric="exact_match", target_half_width=0.2, min_examples=100)

    (port, pcalls), (jax, jcalls) = _both(tmp_path, build, seed=2)
    assert port.logs["adaptive"] == jax.logs["adaptive"]
    ad = port.logs["adaptive"]
    assert ad["stopped"] and ad["reason"] == "target_half_width" and ad["half_width"] <= 0.2
    assert pcalls == jcalls < 400 and _metrics(port) == _metrics(jax)


def test_stopped_run_resumes_bit_identical_and_never_reopens(tmp_path):
    task = _task(P, spill_dir=str(tmp_path / "s")).with_stopping(**RULE)
    crash = PF.ChunkCrashMiddleware([PF.Fault(shard=1, attempt=1)])
    with _session(P, middleware=[crash]) as s:
        with pytest.raises(PF.SimulatedCrash):
            s.run_task(_rows(P, seed=3), task)
    with _session(P) as s:
        first = s.run_task(_rows(P, seed=3), task)
        assert s.accounting.engine_calls == 50  # chunk 2 alone
    assert first.logs["adaptive"]["stop_chunk"] == 2
    with _session(P) as s:
        again = s.run_task(_rows(P, seed=3), task)
        assert s.accounting.engine_calls == 0
    assert again.logs["adaptive"] == first.logs["adaptive"]
    assert again.logs["streaming"]["n_examples"] == 150
    assert _metrics(again) == _metrics(first)
    with R.EvalSession() as s:
        jax = s.run_task(_rows(R, seed=3), _task(R).with_stopping(**RULE))
    assert _metrics(again) == _metrics(jax)
    assert again.logs["adaptive"] == jax.logs["adaptive"]


def test_concurrent_stop_replays_serially_for_free(tmp_path):
    conc = _task(P, spill_dir=str(tmp_path / "b"), concurrency=3).with_stopping(**RULE)
    with _session(P) as s:
        res = s.run_task(_rows(P, seed=4), conc)
    serial = conc.with_streaming(concurrency=1)
    with _session(P) as s:
        replay = s.run_task(_rows(P, seed=4), serial)
        assert s.accounting.engine_calls == 0
    assert _metrics(replay) == _metrics(res)
    assert replay.logs["adaptive"] == res.logs["adaptive"]


def test_declared_cap_is_extendable_and_replayable(tmp_path):
    """``StreamingConfig.max_examples`` is the budget scheduler's round cap:
    raising it resumes the earlier chunks, and a smaller cap replays over
    the larger manifest without touching the extra chunks."""
    base = _task(P, spill_dir=str(tmp_path / "s"))
    calls = []
    results = []
    for cap in (100, 200, 100):
        with _session(P) as s:
            results.append(s.run_task(_rows(P, seed=7), base.with_streaming(max_examples=cap)))
            calls.append(s.accounting.engine_calls)
    assert calls == [100, 100, 0]
    assert results[1].logs["streaming"]["n_resumed_chunks"] == 2
    assert _metrics(results[2]) == _metrics(results[0])
    with R.EvalSession() as s:
        jax = s.run_task(_rows(R, seed=7), _task(R).with_streaming(max_examples=200))
    assert _metrics(results[1]) == _metrics(jax)
    # an uncapped run over the same spill still refuses a shrunk source
    with _session(P) as s:
        with pytest.raises(P.ManifestMismatch, match="beyond the end"):
            s.run_task(_rows(P, 100, seed=7), base)


# -- the suite-level budget scheduler -------------------------------------------------


def _suite(mod, spill, n=3000, models=("gpt-4o", "gpt-3.5-turbo"), providers=None):
    task = mod.EvalTask(
        "qa",
        inference=mod.InferenceConfig(batch_size=32, n_workers=2, cache_dir=""),
        metrics=(mod.MetricConfig("token_f1"),),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200, ci_method="percentile"),
    ).with_streaming(max_memory_rows=128, spill_dir=spill)
    rows = port_rows if mod is P else jax_rows
    providers = providers or ("openai",) * len(models)
    return (mod.EvalSuite("adaptive")
            .add_task(task, lambda: rows(n))
            .sweep_models([mod.EngineModelConfig(provider=p, model_name=m)
                           for p, m in zip(providers, models)]))


def _adaptive(mod, tmp_path, budget_kw, **suite_kw):
    budget = mod.BudgetConfig(**budget_kw)
    with _session(mod) as s:
        res = mod.run_adaptive_suite(s, _suite(mod, str(tmp_path / mod.__name__), **suite_kw),
                                     budget)
        return res, s.accounting.engine_calls


def _adaptive_section(md: str) -> str:
    """The report's adaptive table, up to the next section."""
    tail = md.split("## Adaptive evaluation", 1)[1]
    return tail.split("##", 1)[0].split("_session accounting", 1)[0]


BUDGET = dict(total_examples=4000, round_examples=256, min_examples=256, metric="token_f1")


def test_adaptive_suite_equals_the_reference_and_replays_for_free(tmp_path):
    port, pcalls = _adaptive(P, tmp_path, BUDGET)
    jax, jcalls = _adaptive(R, tmp_path, BUDGET)
    assert port.adaptive == jax.adaptive
    assert json.dumps(port.adaptive, sort_keys=True) == json.dumps(jax.adaptive, sort_keys=True)
    assert pcalls == jcalls == port.adaptive["budget"]["spent"]
    t = port.adaptive["tasks"]["qa"]
    assert t["certified"] and t["verdicts"] == {"gpt-4o vs gpt-3.5-turbo": "a_better"}
    assert all(c < 3000 for c in t["consumed"].values())
    assert 0 < t["n_at_stop"] < 3000
    assert port.adaptive["budget"]["spent"] <= BUDGET["total_examples"]
    for key, res in port.results.items():
        assert _metrics(res) == _metrics(jax.results[key])
    cmp = port.comparison("qa", "token_f1", "gpt-4o", "gpt-3.5-turbo")
    assert cmp.diff > 0
    md = port.to_markdown()
    assert "a_better" in _adaptive_section(md)
    assert _adaptive_section(md) == _adaptive_section(jax.to_markdown())
    # a replay over the same spill dirs: the same payload, no engine call
    again, calls = _adaptive(P, tmp_path, BUDGET)
    assert calls == 0 and again.adaptive == port.adaptive
    for key, res in port.results.items():
        assert _metrics(again.results[key]) == _metrics(res)


def test_budget_exhaustion_leaves_the_task_undecided_not_wrong(tmp_path):
    kw = dict(models=("gpt-4o", "claude-3-5-sonnet"), providers=("openai", "anthropic"))
    budget = dict(total_examples=700, round_examples=128, min_examples=256,
                  metric="token_f1")
    port, _ = _adaptive(P, tmp_path, budget, **kw)
    jax, _ = _adaptive(R, tmp_path, budget, **kw)
    assert port.adaptive == jax.adaptive
    t = port.adaptive["tasks"]["qa"]
    assert t["reason"] in ("budget_exhausted", "certified")
    if t["reason"] == "budget_exhausted":
        assert t["verdicts"]["gpt-4o vs claude-3-5-sonnet"] == "undecided"
    assert port.adaptive["budget"]["spent"] <= budget["total_examples"] + 2 * 256


def test_single_arm_width_target_equals_the_reference(tmp_path):
    budget = dict(total_examples=4000, round_examples=256, min_examples=256,
                  target_half_width=0.05, metric="token_f1")
    port, _ = _adaptive(P, tmp_path, budget, n=4000, models=("gpt-4o-mini",))
    jax, _ = _adaptive(R, tmp_path, budget, n=4000, models=("gpt-4o-mini",))
    assert port.adaptive == jax.adaptive
    t = port.adaptive["tasks"]["qa"]
    assert t["certified"] and t["half_width"] <= 0.05
    assert t["consumed"]["gpt-4o-mini"] < 4000


def test_multi_arm_tasks_drop_their_own_stopping_rule(tmp_path):
    """Per-arm width stopping would stop the arms at different n; the
    scheduler runs a multi-arm task without it, as the reference does."""
    from repro_torch.core.budget import _arm_task

    task = P.EvalTask("t").with_stopping(target_half_width=0.1)
    assert _arm_task(task, 2).stopping == StoppingRule()
    assert _arm_task(task, 1) is task


def test_budget_scheduler_validates_inputs(tmp_path):
    msgs = {}
    for mod in (P, R):
        no_stream = mod.EvalTask("t", metrics=(mod.MetricConfig("token_f1"),))
        rows = port_rows if mod is P else jax_rows
        budget = mod.BudgetConfig(total_examples=100)
        streamed = no_stream.with_streaming(max_memory_rows=64,
                                            spill_dir=str(tmp_path / mod.__name__))
        cases = [
            (mod.EvalSuite("bad").add_task(no_stream, lambda: rows(10)), budget, "spill_dir"),
            (mod.EvalSuite("bad2").add_task(streamed, list(rows(10))), budget, "factory"),
            (mod.EvalSuite("bad3").add_task(streamed, lambda: rows(10)),
             dataclasses.replace(budget, metric="no_such_metric"), "certifies on metric"),
        ]
        msgs[mod] = []
        for suite, b, match in cases:
            with _session(mod) as s:
                with pytest.raises(ValueError, match=match) as e:
                    mod.run_adaptive_suite(s, suite, b)
            msgs[mod].append(str(e.value))
    assert msgs[P] == msgs[R]
    assert P.BudgetConfig(100).effective_rho() == R.BudgetConfig(100).effective_rho()
