"""The port's fault-tolerant serving against the JAX package's, on the CPU
(the mirror of ``tests/test_fault_tolerant_serving.py``):

* the serving fault schedule and its batcher hook;
* the slot simulator's page gate, page-pressure preemption and a prompt
  larger than the pool;
* a replica crash mid-decode restarted and served again byte for byte; a
  restart budget spent, whose fleet-dead error names every replica; the
  health probe, off by default; a deadline hedged to another replica; the
  error taxonomy (a bad request, a recoverable refusal, retries spent);
* the port's batcher under pool exhaustion and a cancel;
* a slotsim chaos session (3 replicas, round robin, page pressure, a crash
  and a hang) against the port's fault-free run and the reference's chaos
  run; the same crash on a reduced local engine, dense and Mamba2;
* the default ``InferenceConfig`` restarting a crashed engine, as the
  reference does.

No outcome here depends on a clock or a thread schedule: sessions sleep
through a no-op; a hedge is tested only where the primary replica never
answers, so the deadline expires and the winner is fixed; counts are
asserted only under ``round_robin`` routing from one submitting thread or
where each replica's work is fixed; every service and session is closed
before the test ends."""

import json

import numpy as np
import pytest

import repro.core as R
import repro.ft as RF
import repro_torch.core as P
import repro_torch.ft as PF
from repro.data import mixed_examples
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.paged_cache import PagePoolExhausted

PKGS = {"port": (P, PF), "jax": (R, RF)}
SLOT_KW = {"n_slots": 4, "step_ms": 0.0}
TIMEOUT = 60


def _slot_model(mod, name="slot-sim"):
    return mod.EngineModelConfig(provider="slotsim", model_name=name)


def _pump_all(eng, rids, max_pumps=5000):
    done = {}
    for _ in range(max_pumps):
        for rid, resp in eng.stream_pump():
            done[rid] = resp
        if len(done) == len(rids):
            return done
    raise AssertionError(f"only {len(done)}/{len(rids)} completed")


def _texts(n=8, words=8):
    return [" ".join(f"w{i}t{j}" for j in range(words)) + f" tail {i}"
            for i in range(n)]


def _mv_tuple(mv):
    return (mv.value, mv.ci, mv.ci_method, mv.n, mv.n_unscored)


def _assert_metrics_as_the_reference(p, j):
    """Equal metrics, bit for bit but for the in-memory interval of a
    non-dyadic score (``compute_ci``'s 1e-6, ``tests/test_torch_inmemory.py``)."""
    assert sorted(p.metrics) == sorted(j.metrics)
    for name, jm in j.metrics.items():
        pm = p.metrics[name]
        assert (pm.value, pm.ci_method, pm.n, pm.n_unscored) == \
            (jm.value, jm.ci_method, jm.n, jm.n_unscored)
        if name == "exact_match":
            assert pm.ci == jm.ci
        else:
            np.testing.assert_allclose(pm.ci, jm.ci, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(p.scores[name], j.scores[name])


def _oracle(mod, prompts):
    eng = mod.SimulatedSlotEngine(_slot_model(mod), **SLOT_KW)
    return [eng.infer(mod.InferenceRequest(p, 8, 0.0)).text for p in prompts]


# -- the fault schedule ---------------------------------------------------------------


def test_serving_fault_kind_is_validated_as_the_reference():
    assert PF.SERVING_FAULT_KINDS == RF.SERVING_FAULT_KINDS
    msgs = []
    for ft in (PF, RF):
        with pytest.raises(ValueError, match="unknown serving fault kind") as e:
            ft.ServingFault(replica=0, step=1, kind="meteor_strike")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_schedule_attaches_and_fires_as_the_reference():
    calls = [("attach",), ("attach",), ("poll", 0, 2), ("poll", 0, 7), ("poll", 0, 8),
             ("poll", 1, 4), ("poll", 1, 5), ("poll", 1, 5), ("poll", 2, 99),
             ("poll", 1, 40), ("poll", 1, 41)]
    out = {}
    for name, (_, ft) in PKGS.items():
        plan = ft.ServingFaultSchedule([
            ft.ServingFault(1, 5, "hang", duration=2),
            ft.ServingFault(0, 3, "page_pressure"),
            ft.ServingFault(1, 40, "slow_step", delay_s=0.0),
        ])
        got = []
        for c in calls:
            if c[0] == "attach":
                got.append(plan.attach())
            else:
                f = plan.poll(*c[1:])
                got.append(None if f is None else (f.replica, f.step, f.kind, f.duration))
        out[name] = (got, plan.injected)
    assert out["port"] == out["jax"]
    assert out["port"][1] == [(0, 7, "page_pressure"), (1, 5, "hang"), (1, 40, "slow_step")]


def test_hook_raises_preempts_and_hangs_for_its_duration():
    """The batcher hook: a crash raises the reference's ``SimulatedCrash``
    with its message, page pressure returns its kind, and a hang returns
    "hang" for ``duration`` calls (the reference's hook for one)."""
    plans = {name: ft.ServingFaultSchedule([
        ft.ServingFault(0, 2, "replica_crash"), ft.ServingFault(1, 1, "page_pressure"),
        ft.ServingFault(1, 3, "hang", duration=3)]) for name, (_, ft) in PKGS.items()}
    msgs = []
    for name, (_, ft) in PKGS.items():
        hook = plans[name].as_hook(0)
        assert hook(0) is None and hook(1) is None
        with pytest.raises(ft.SimulatedCrash) as e:
            hook(2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "injected replica_crash replica=0 step=2"
    port, ref = plans["port"].as_hook(1), plans["jax"].as_hook(1)
    assert [port(s) for s in (0, 1, 2)] == [ref(s) for s in (0, 1, 2)] == \
        [None, "page_pressure", None]
    assert [port(3) for _ in range(4)] == ["hang", "hang", "hang", None]
    assert [ref(3) for _ in range(2)] == ["hang", None]
    assert plans["port"].injected == plans["jax"].injected
    # an engine reset builds a new hook, which is not hung
    plan = PF.ServingFaultSchedule([PF.ServingFault(0, 0, "hang", duration=10)])
    assert plan.as_hook(0)(0) == "hang" and plan.as_hook(0)(0) is None


# -- the slot simulator: page gate and preemption --------------------------------------


def test_sim_page_gate_defers_prefills_and_stays_byte_identical():
    prompts = _texts(6, words=8)  # 10 words each: 3 pages at page size 4
    out = {}
    for name, (mod, _) in PKGS.items():
        big = mod.SimulatedSlotEngine(_slot_model(mod), kv_page_size=4, **SLOT_KW)
        small = mod.SimulatedSlotEngine(_slot_model(mod), kv_page_size=4, page_pool=7,
                                        **SLOT_KW)
        texts = {}
        for label, eng in (("big", big), ("small", small)):
            rids = [eng.stream_submit(mod.InferenceRequest(p, 8, 0.0)) for p in prompts]
            done = _pump_all(eng, rids)
            texts[label] = [done[r].text for r in rids]
        assert texts["small"] == texts["big"]
        assert small.stats.prefills_deferred > 0
        assert small.stats.completions == len(prompts)
        small._pages.check_no_leaks()
        out[name] = (texts, big.serving_stats(), small.serving_stats())
    assert out["port"] == out["jax"]


def test_sim_page_pressure_fault_preempts_and_recomputes_identically():
    prompts = _texts(8, words=8)
    out = {}
    for name, (mod, ft) in PKGS.items():
        plan = ft.ServingFaultSchedule([ft.ServingFault(0, 2, "page_pressure", duration=2),
                                        ft.ServingFault(0, 4, "page_pressure")])
        faulted = mod.SimulatedSlotEngine(_slot_model(mod), kv_page_size=4,
                                          fault_plan=plan, **SLOT_KW)
        plain = mod.SimulatedSlotEngine(_slot_model(mod), kv_page_size=4, **SLOT_KW)
        texts = []
        for eng in (plain, faulted):
            rids = [eng.stream_submit(mod.InferenceRequest(p, 8, 0.0)) for p in prompts]
            done = _pump_all(eng, rids)
            texts.append([done[r].text for r in rids])
        assert texts[0] == texts[1]
        assert faulted.stats.preemptions >= 3 and len(plan.injected) == 2
        faulted._pages.check_no_leaks()
        out[name] = (texts, faulted.serving_stats(), plan.injected)
    assert out["port"] == out["jax"]


def test_sim_prompt_larger_than_pool_raises_instead_of_deferring_forever():
    eng = P.SimulatedSlotEngine(_slot_model(P), kv_page_size=4, page_pool=2, **SLOT_KW)
    eng.stream_submit(P.InferenceRequest(" ".join(["w"] * 40), 4, 0.0))
    with pytest.raises(PagePoolExhausted):
        for _ in range(50):
            eng.stream_pump()


# -- replica restart ---------------------------------------------------------------------


def test_replica_crash_mid_decode_restarts_and_serves_again_byte_identically():
    prompts = _texts(8)
    plan = PF.ServingFaultSchedule([PF.ServingFault(0, 3, "replica_crash")])
    crashy = P.SimulatedSlotEngine(_slot_model(P), fault_plan=plan, **SLOT_KW)
    steady = P.SimulatedSlotEngine(_slot_model(P), **SLOT_KW)
    expect = _oracle(P, prompts)
    assert expect == _oracle(R, prompts)
    with P.InferenceService(engines=[crashy, steady], routing="round_robin",
                            max_batch_wait_ms=0.0, max_replica_restarts=2,
                            restart_backoff_s=0.0, sleep=lambda s: None,
                            name="crashy") as svc:
        tickets = [svc.submit(P.InferenceRequest(p, 8, 0.0), key=f"k{i}")
                   for i, p in enumerate(prompts)]
        got = [t.result(timeout=TIMEOUT) for t in tickets]
        assert [r.text for r in got] == expect and all(r.error is None for r in got)
        # the restarted replica serves new work too
        late = svc.submit(P.InferenceRequest(prompts[0], 8, 0.0), key="late")
        assert late.result(timeout=TIMEOUT).text == expect[0]
        snap = svc.snapshot()
    assert snap["restarts"] == 1 and snap["errors"] == 0
    per = {r["index"]: r for r in snap["replica_stats"]}
    assert not per[0]["broken"] and per[0]["restarts"] == 1 and per[1]["restarts"] == 0
    assert plan.injected == [(0, 3, "replica_crash")]


def _dying(mod):
    class AlwaysDying(mod.SimulatedSlotEngine):
        """Crashes every pump, even after reset()."""

        def stream_pump(self):
            raise RuntimeError(f"cursed replica (pump {self._pumps})")

    return AlwaysDying


def test_restart_budget_exhausted_fleet_report_names_every_replica():
    messages = {}
    for name, (mod, _) in PKGS.items():
        fleet = [_dying(mod)(_slot_model(mod), **SLOT_KW) for _ in range(2)]
        with mod.InferenceService(engines=fleet, routing="round_robin",
                                  max_batch_wait_ms=0.0, max_replica_restarts=1,
                                  restart_backoff_s=0.0, sleep=lambda s: None,
                                  name="doomed") as svc:
            tickets = [svc.submit(mod.InferenceRequest(f"doomed {i}", 8, 0.0), key=f"d{i}")
                       for i in range(2)]
            for t in tickets:
                with pytest.raises(RuntimeError, match="cursed replica"):
                    t.result(timeout=TIMEOUT)
            # each replica was retired before it failed its ticket
            with pytest.raises(RuntimeError) as e:
                svc.submit(mod.InferenceRequest("after the fall", 8, 0.0), key="x")
            messages[name] = str(e.value)
            assert [r.restarts for r in svc.replicas] == [1, 1]
    for msg in messages.values():
        assert "replica 0:" in msg and "replica 1:" in msg
        assert "cursed replica" in msg and msg.count("restarts 1") == 2
    assert messages["port"] == messages["jax"]


# -- the health probe --------------------------------------------------------------------


def test_health_probe_catches_hung_replica_and_restart_recovers():
    prompts = _texts(4)
    plan = PF.ServingFaultSchedule([PF.ServingFault(0, 2, "hang", duration=1_000_000)])
    eng = P.SimulatedSlotEngine(_slot_model(P), fault_plan=plan, **SLOT_KW)
    with P.InferenceService(engine=eng, max_batch_wait_ms=0.0, max_replica_restarts=1,
                            restart_backoff_s=0.0, health_probe_steps=5,
                            sleep=lambda s: None, name="hung") as svc:
        tickets = [svc.submit(P.InferenceRequest(p, 8, 0.0), key=f"h{i}")
                   for i, p in enumerate(prompts)]
        got = [t.result(timeout=TIMEOUT).text for t in tickets]
    assert got == _oracle(P, prompts)
    assert svc.stats.restarts == 1 and svc.stats.errors == 0


def test_probe_disabled_by_default_short_hangs_self_recover():
    plan = PF.ServingFaultSchedule([PF.ServingFault(0, 2, "hang", duration=3)])
    eng = P.SimulatedSlotEngine(_slot_model(P), fault_plan=plan, **SLOT_KW)
    with P.InferenceService(engine=eng, max_batch_wait_ms=0.0) as svc:
        assert svc.health_probe_steps == 0
        t = svc.submit(P.InferenceRequest("just slow", 8, 0.0), key="s")
        assert t.result(timeout=TIMEOUT).error is None
    assert svc.stats.restarts == 0 and plan.injected == [(0, 2, "hang")]


# -- deadlines and hedges ----------------------------------------------------------------


class WedgedEngine(P.SimulatedSlotEngine):
    """Accepts submissions and never completes them, without raising: only
    a deadline (or the probe) can rescue its requests."""

    def stream_pump(self):
        return []


def test_deadline_hedges_to_another_replica_first_completion_wins():
    wedged = WedgedEngine(_slot_model(P), **SLOT_KW)
    steady = P.SimulatedSlotEngine(_slot_model(P), **SLOT_KW)
    req = P.InferenceRequest("stuck prompt", 8, 0.0)
    with P.InferenceService(engines=[wedged, steady], routing="round_robin",
                            max_batch_wait_ms=0.0, name="hedged") as svc:
        t = svc.submit(req, key="hk", deadline_s=0.02)  # round robin: replica 0
        assert t.result(timeout=TIMEOUT).text == _oracle(P, [req.prompt])[0]
    # closing joined the loops: the wedged replica cancelled its losing leg
    s = svc.stats
    assert (s.deadline_expiries, s.hedges_issued, s.hedges_won, s.completed) == (1, 1, 1, 1)
    assert t.attempts == 2
    assert [r.cancelled for r in svc.replicas] == [1, 0]
    assert [r.completed for r in svc.replicas] == [0, 1]
    assert not wedged.stream_pending() and wedged.slots_busy() == 0


def test_no_deadline_means_no_hedging():
    eng = P.SimulatedSlotEngine(_slot_model(P), **SLOT_KW)
    with P.InferenceService(engine=eng, max_batch_wait_ms=0.0) as svc:
        assert svc.submit(P.InferenceRequest("calm", 8, 0.0), key="c").result(
            timeout=TIMEOUT).error is None
    assert (svc.stats.deadline_expiries, svc.stats.hedges_issued) == (0, 0)


# -- the error taxonomy ----------------------------------------------------------------


class TaxonomyEngine(P.SimulatedSlotEngine):
    """``stream_submit`` raises ValueError for "bad" prompts and
    RecoverableEngineError for the first ``flake`` "flaky" ones."""

    def __init__(self, model, flake=1, **kw):
        super().__init__(model, **kw)
        self.flake = flake

    def stream_submit(self, request):
        if request.prompt.startswith("bad"):
            raise ValueError(f"malformed prompt: {request.prompt!r}")
        if request.prompt.startswith("flaky") and self.flake > 0:
            self.flake -= 1
            raise P.RecoverableEngineError("engine briefly overloaded")
        return super().stream_submit(request)


def test_value_error_fails_one_ticket_replica_lives_on():
    eng = TaxonomyEngine(_slot_model(P), **SLOT_KW)
    with P.InferenceService(engine=eng, max_batch_wait_ms=0.0) as svc:
        bad = svc.submit(P.InferenceRequest("bad {", 8, 0.0), key="b")
        with pytest.raises(ValueError, match="malformed prompt"):
            bad.result(timeout=TIMEOUT)
        good = svc.submit(P.InferenceRequest("good prompt", 8, 0.0), key="g")
        assert good.result(timeout=TIMEOUT).error is None
        assert svc.replicas[0].broken is None
    assert svc.stats.restarts == 0 and svc.stats.errors == 1


def test_recoverable_error_retries_with_backoff_then_succeeds():
    eng = TaxonomyEngine(_slot_model(P), flake=2, **SLOT_KW)
    sleeps = []
    with P.InferenceService(engine=eng, max_batch_wait_ms=0.0, sleep=sleeps.append) as svc:
        t = svc.submit(P.InferenceRequest("flaky prompt", 8, 0.0), key="f",
                       max_retries=3, retry_delay=0.5)
        assert t.result(timeout=TIMEOUT).error is None
        assert t.attempts == 3 and svc.replicas[0].broken is None
    assert sleeps == [] and svc.stats.retries == 2


def test_recoverable_error_exhausting_retries_fails_the_ticket_only():
    eng = TaxonomyEngine(_slot_model(P), flake=10, **SLOT_KW)
    with P.InferenceService(engine=eng, max_batch_wait_ms=0.0, sleep=lambda s: None) as svc:
        t = svc.submit(P.InferenceRequest("flaky forever", 8, 0.0), key="f",
                       max_retries=1, retry_delay=0.5)
        with pytest.raises(P.RecoverableEngineError):
            t.result(timeout=TIMEOUT)
        ok = svc.submit(P.InferenceRequest("fine", 8, 0.0), key="o")
        assert ok.result(timeout=TIMEOUT).error is None
    assert t.attempts == 2 and svc.stats.errors == 1


# -- the port's batcher: pool exhaustion preempts, a cancel frees -----------------------


def _batcher(n_slots=3, **kw):
    cfg = get_config("qwen3-4b").reduced()
    params = init_params(cfg, 0, device="cpu")
    return ContinuousBatcher(build_model(cfg), cfg, params, n_slots=n_slots, max_len=64,
                             eos_id=1, **kw)


def test_batcher_pool_exhaustion_preempts_and_no_request_is_lost():
    reqs = [Request(i, prompt_tokens=[10 + i + j for j in range(14)], max_new_tokens=6)
            for i in range(5)]

    def run(**kw):
        sched = _batcher(page_size=16, **kw)
        for r in reqs:
            sched.submit(Request(r.request_id, list(r.prompt_tokens), r.max_new_tokens))
        return sched, {c.request_id: c for c in sched.run_to_completion()}

    full, base = run()
    tight, pressured = run(page_pool=3)
    assert sorted(pressured) == list(range(5))
    assert all(c.finished_reason in ("eos", "length") for c in pressured.values())
    assert tight.stats.preemptions >= 1 and tight.stats.prefills_deferred >= 1
    assert full.stats.preemptions == 0
    assert all(pressured[i].tokens == base[i].tokens for i in range(5))
    tight.manager.check_no_leaks()


def test_batcher_cancel_releases_slot_and_pages():
    sched = _batcher(page_size=16)
    for i in range(2):
        sched.submit(Request(i, prompt_tokens=[30 + i + j for j in range(10)],
                             max_new_tokens=8))
    for _ in range(3):
        sched.step()
    assert sched.cancel(0) and not sched.cancel(0)
    assert [c.request_id for c in sched.run_to_completion()] == [1]
    sched.manager.check_no_leaks()


def test_batcher_hook_pressure_and_hang_keep_the_tokens():
    """The fault hook on the port's batcher: page pressure preempts the
    cheapest slot, a hang of 3 steps stops admission and decode, a crash
    raises; the surviving tokens are those of an unfaulted run."""
    reqs = [Request(i, prompt_tokens=[20 + 3 * i + j for j in range(9)], max_new_tokens=6)
            for i in range(4)]

    def run(plan):
        sched = _batcher(n_slots=4)
        if plan is not None:
            sched.fault_hook = plan.as_hook(0)
        for r in reqs:
            sched.submit(Request(r.request_id, list(r.prompt_tokens), r.max_new_tokens))
        return sched, {c.request_id: c.tokens for c in sched.run_to_completion()}

    _, base = run(None)
    plan = PF.ServingFaultSchedule([PF.ServingFault(0, 2, "page_pressure"),
                                    PF.ServingFault(0, 3, "hang", duration=3)])
    sched, got = run(plan)
    assert got == base
    assert sched.stats.preemptions == 1 and plan.injected == [(0, 2, "page_pressure"),
                                                               (0, 3, "hang")]
    crash = PF.ServingFaultSchedule([PF.ServingFault(0, 1, "replica_crash")])
    sched = _batcher(n_slots=4)
    sched.fault_hook = crash.as_hook(0)
    sched.submit(Request(0, prompt_tokens=[5, 6, 7], max_new_tokens=4))
    with pytest.raises(PF.SimulatedCrash, match="replica=0 step=1"):
        sched.run_to_completion()


# -- end to end through the session ----------------------------------------------------


def _task(mod, model, task_id="chaos", **inf_kw):
    return mod.EvalTask(
        task_id=task_id, model=model,
        inference=mod.InferenceConfig(batch_size=8, n_workers=4, **inf_kw),
        metrics=(mod.MetricConfig("exact_match"), mod.MetricConfig("token_f1")),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200, ci_method="percentile"),
    )


def _session(mod, **kw):
    return mod.EvalSession(device="cpu", **kw) if mod is P else mod.EvalSession(**kw)


def test_session_chaos_run_matches_fault_free_run_and_the_reference():
    rows = mixed_examples(30, seed=23)
    inf_kw = dict(n_replicas=3, routing="round_robin", kv_page_size=4,
                  health_probe_steps=50)
    out = {}
    for name, (mod, ft) in PKGS.items():
        plan = ft.ServingFaultSchedule([
            ft.ServingFault(0, 4, "page_pressure", duration=2),
            ft.ServingFault(1, 6, "replica_crash"),
            ft.ServingFault(2, 3, "hang", duration=4),
        ])
        runs = {}
        for label, extra in (("base", {}), ("chaos", {"fault_plan": plan})):
            with _session(mod, engine_kwargs={**SLOT_KW, "kv_page_size": 4, **extra}) as s:
                res = s.run_task(rows, _task(mod, _slot_model(mod), **inf_kw))
                (snap,) = s.serving_stats()
            runs[label] = (res, snap)
        (base, base_snap), (chaos, snap) = runs["base"], runs["chaos"]
        assert not chaos.failures and not base.failures and snap["errors"] == 0
        assert chaos.responses == base.responses
        for m in base.metrics:
            assert _mv_tuple(chaos.metrics[m]) == _mv_tuple(base.metrics[m])
        assert snap["restarts"] == 1 and snap["batcher"]["preemptions"] >= 1
        assert snap["completed"] == base_snap["completed"]
        out[name] = (chaos, sorted(plan.injected), snap["restarts"], snap["completed"])
    p, j = out["port"], out["jax"]
    assert p[0].responses == j[0].responses and p[0].failures == j[0].failures
    _assert_metrics_as_the_reference(p[0], j[0])
    assert p[1:] == j[1:]
    assert p[1] == [(0, 4, "page_pressure"), (1, 6, "replica_crash"), (2, 3, "hang")]


@pytest.mark.parametrize("model_name,fault", [
    ("qwen3-4b", "replica_crash"), ("qwen3-4b", "hang"), ("mamba2-2.7b", "replica_crash"),
])
def test_local_engine_restarts_and_serves_the_fault_free_texts(model_name, fault):
    """A reduced local engine (dense or Mamba2) crashed, or hung past the
    probe, mid-decode: the restarted replica rebuilds its batcher on the
    same weights and tokenizer, and the run gives the fault-free texts and
    metrics."""
    rows = mixed_examples(8, seed=3)
    model = P.EngineModelConfig(model_name=model_name, reduced=True, seed=0, max_tokens=6)
    kw = {"n_slots": 4, "max_len": 64}
    faults = {"replica_crash": [PF.ServingFault(0, 3, "replica_crash")],
              "hang": [PF.ServingFault(0, 3, "hang", duration=1_000_000)]}
    plan = PF.ServingFaultSchedule(faults[fault])
    runs = {}
    for label, extra in (("base", {}), ("fault", {"fault_plan": plan})):
        with P.EvalSession(device="cpu", engine_kwargs={**kw, **extra}) as s:
            res = s.run_task(rows, _task(P, model, "local", health_probe_steps=4))
            (snap,) = s.serving_stats()
            engines = s.engines.engines()
        runs[label] = (res, snap, engines)
    (base, _, _), (got, snap, engines) = runs["base"], runs["fault"]
    assert not got.failures and got.responses == base.responses
    assert len(set(base.responses)) > 1
    for m in base.metrics:
        assert _mv_tuple(got.metrics[m]) == _mv_tuple(base.metrics[m])
    assert snap["restarts"] == 1 and snap["errors"] == 0
    assert plan.injected == [(0, 3, fault)]
    assert snap["batcher"]["completions"] >= len(rows)


# -- the default InferenceConfig restarts a crashed engine ----------------------------


class _CrashOnceSlots:
    """A slot engine that raises RuntimeError once out of ``stream_pump``,
    at its second pump with work in flight, and has a ``reset()``; every
    answer is the prompt's words reversed, after three pumps."""

    supports_streaming = True

    def __init__(self, mod):
        self.mod, self.live, self.next_id = mod, {}, 0
        self.pumps, self.crashed, self.resets = 0, False, 0

    def initialize(self):
        pass

    def shutdown(self):
        pass

    def reset(self):
        self.live.clear()
        self.resets += 1

    def _answer(self, prompt):
        return " ".join(reversed(prompt.split()))

    def infer_batch(self, requests):
        return [self.mod.InferenceResponse(self._answer(r.prompt), 1, 1, 0.0)
                for r in requests]

    def infer(self, request):
        return self.infer_batch([request])[0]

    def stream_submit(self, request):
        rid, self.next_id = self.next_id, self.next_id + 1
        self.live[rid] = [request.prompt, 3]
        return rid

    def stream_pump(self):
        self.pumps += 1
        if self.pumps == 2 and not self.crashed:
            self.crashed = True
            raise RuntimeError("transient engine crash")
        done = []
        for rid, item in list(self.live.items()):
            item[1] -= 1
            if item[1] <= 0:
                del self.live[rid]
                done.append((rid, self.mod.InferenceResponse(
                    self._answer(item[0]), len(item[0].split()), 3, 0.0)))
        return done

    def stream_pending(self):
        return bool(self.live)

    def stream_cancel(self, rid):
        return self.live.pop(rid, None) is not None

    def serving_stats(self):
        return {"steps": self.pumps}


def _crash_once_registry(mod):
    class Registry(mod.EngineRegistry):
        """Builds a :class:`_CrashOnceSlots` for every key."""

        def get(self, model, *, replica=0, **kw):
            key = (model, replica, json.dumps(kw, sort_keys=True, default=str))
            with self._lock:
                if key not in self._engines:
                    self._engines[key] = _CrashOnceSlots(mod)
                return self._engines[key]

    return Registry()


def test_default_config_restarts_a_crashed_engine_as_the_reference():
    """At the default ``InferenceConfig`` (``max_replica_restarts=2``) an
    engine that raises once out of its pump is reset and its in-flight work
    served again: every row gets its answer, in both packages."""
    rows = mixed_examples(12, seed=1)
    out = {}
    for name, (mod, _) in PKGS.items():
        model = mod.EngineModelConfig(provider="slotsim", model_name="crash-once")
        task = mod.EvalTask(
            "crash-once", model=model,
            metrics=(mod.MetricConfig("exact_match"), mod.MetricConfig("token_f1")),
            statistics=mod.StatisticsConfig(bootstrap_iterations=200,
                                            ci_method="percentile"))
        assert task.inference.max_replica_restarts == 2
        with _session(mod) as s:
            s.engines = _crash_once_registry(mod)
            res = s.run_task(rows, task)
            (snap,) = s.serving_stats()
            (engine,) = s.engines._engines.values()
        out[name] = (res, snap, engine)
    (p, psnap, peng), (j, jsnap, jeng) = out["port"], out["jax"]
    assert j.failures == [] and p.failures == j.failures
    assert p.responses == j.responses and len(set(p.responses)) == len(rows)
    _assert_metrics_as_the_reference(p, j)
    assert psnap["restarts"] == jsnap["restarts"] == 1
    assert psnap["errors"] == jsnap["errors"] == 0
    assert peng.crashed and peng.resets == jeng.resets == 1
