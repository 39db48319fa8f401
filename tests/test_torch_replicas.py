"""The port's multi-replica serving fabric against the JAX package's, on the
CPU (the mirror of ``tests/test_replica_service.py``):

* the router's policies and tie-breaks, call for call against the
  reference's ``ReplicaRouter`` on the same load snapshots;
* ``aggregate_batcher_stats`` against the reference's;
* the engine registry's keys by replica;
* global single-flight across replicas; distinct keys spread by round
  robin; a dead replica failing its own tickets only; a dead fleet
  refusing submissions;
* the fleet built from ``InferenceConfig``, the suite report's replicas
  column, the aggregation invariants, the prefill cap;
* replica-count parity: the slot simulator's suite over 1, 2 and 4
  replicas, and a reduced ``"torch_local"`` qwen3 over 1, 2 and 3 replicas
  under each policy, give the texts and metrics of the port's single
  engine and of the JAX session's single-replica run.

No outcome depends on a clock or a thread schedule: counts are asserted
only under ``round_robin`` or ``prefix_affinity`` routing from one
submitting thread (``least_loaded`` runs assert outputs only), every
``result()`` has a timeout, and every service and session is closed before
the test ends."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.service as RS
import repro.models.model as jax_model_mod
import repro_torch.core as P
import repro_torch.core.engines as port_engines
import repro_torch.core.service as PS
from repro.configs import get_config as jax_get_config
from repro.data import mixed_examples, qa_examples
from repro.models import params as jax_pm
from repro_torch.configs import get_config
from repro_torch.models import TransformerLM, params_from_jax

PKGS = {"port": P, "jax": R}
SLOT_KW = {"n_slots": 4, "step_ms": 0.0}
TIMEOUT = 60
POLICIES = ("least_loaded", "prefix_affinity", "round_robin")


def _slot(mod, name="slot-sim"):
    return mod.EngineModelConfig(provider="slotsim", model_name=name)


def _api(mod):
    return mod.EngineModelConfig(provider="openai", model_name="gpt-4o-mini")


def _task(mod, task_id="rep", model=None, **inf_kw):
    return mod.EvalTask(
        task_id=task_id, model=model or _slot(mod),
        inference=mod.InferenceConfig(batch_size=8, n_workers=4, **inf_kw),
        metrics=(mod.MetricConfig("exact_match"), mod.MetricConfig("token_f1")),
        statistics=mod.StatisticsConfig(bootstrap_iterations=200, ci_method="percentile"),
    )


def _session(mod, **kw):
    return mod.EvalSession(device="cpu", **kw) if mod is P else mod.EvalSession(**kw)


def _mv_tuple(mv):
    return (mv.value, mv.ci, mv.ci_method, mv.n, mv.n_unscored)


def _cmp_tuple(c):
    return (c.diff, c.diff_ci, c.test.p_value, c.effect.value)


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


def _views(svc_mod, loads):
    return [svc_mod.ReplicaView(index=i, queued=q, outstanding=o)
            for i, (q, o) in enumerate(loads)]


# -- the router ---------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("prefix_len", [16, 64])
def test_router_routes_call_for_call_as_the_reference(policy, prefix_len):
    """Random load snapshots over random alive subsets: the port's router
    picks the reference's replica at every call (round robin's rotation
    included)."""
    rng = np.random.default_rng(prefix_len)
    routers = {name: svc.ReplicaRouter(policy, prefix_len=prefix_len)
               for name, svc in (("port", PS), ("jax", RS))}
    for call in range(400):
        n = int(rng.integers(1, 6))
        alive = sorted(rng.choice(8, size=n, replace=False).tolist())
        loads = rng.integers(0, 4, size=(n, 3)).tolist()
        prompt = f"Few-shot header {int(rng.integers(6))}: question {call} " * 2
        picks = [r.route(prompt, [svc.ReplicaView(index=i, queued=q, outstanding=o,
                                                   busy_slots=b)
                                  for i, (q, o, b) in zip(alive, loads)])
                 for r, svc in ((routers["port"], PS), (routers["jax"], RS))]
        assert picks[0] == picks[1] and picks[0] in alive


def test_least_loaded_picks_min_load_breaking_ties_low_index():
    r = PS.ReplicaRouter("least_loaded")
    assert r.route("p", _views(PS, [(2, 1), (0, 1), (4, 0)])) == 1
    assert r.route("p", _views(PS, [(1, 1), (0, 2), (2, 0)])) == 0
    for _ in range(5):
        assert r.route("x", _views(PS, [(3, 3), (1, 0), (1, 1)])) == 1


def test_prefix_affinity_is_deterministic_and_prefix_only():
    r = PS.ReplicaRouter("prefix_affinity", prefix_len=16)
    views = _views(PS, [(0, 0)] * 4)
    header = "Few-shot header #7: "
    picks = {r.route(header + s, views) for s in ("alpha", "beta", "gamma", "delta")}
    assert len(picks) == 1
    assert r.route(header + "epsilon", _views(PS, [(9, 9)] * 4)) == picks.pop()
    spread = {PS.ReplicaRouter("prefix_affinity").route(f"prompt family {i}: body", views)
              for i in range(64)}
    assert len(spread) > 1


def test_round_robin_rotates_and_unknown_policy_is_refused():
    r = PS.ReplicaRouter("round_robin")
    assert [r.route("p", _views(PS, [(0, 0)] * 3)) for _ in range(6)] == [0, 1, 2, 0, 1, 2]
    msgs = []
    for svc in (PS, RS):
        with pytest.raises(ValueError, match="unknown routing policy") as e:
            svc.ReplicaRouter("random")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(RuntimeError, match="no alive replicas"):
        r.route("p", [])


# -- fleet counters ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_aggregate_batcher_stats_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    keys = ("n_slots", "steps", "admissions", "completions", "tokens_generated",
            "active_slot_steps", "prefill_recompiles", "prefills_deferred",
            "prefix_pages_hit", "prefix_tokens_saved", "cow_copies", "preemptions",
            "preempted_tokens", "pool_pages", "kv_bytes_per_token")
    parts = []
    for _ in range(int(rng.integers(1, 5))):
        if rng.random() < 0.2:
            parts.append({})
            continue
        part = {k: int(rng.integers(0, 500)) for k in keys if rng.random() < 0.9}
        part["prefill_s"], part["decode_s"] = float(rng.random()), float(rng.random())
        parts.append(part)
    assert PS.aggregate_batcher_stats(parts) == RS.aggregate_batcher_stats(parts)
    assert PS.aggregate_batcher_stats([{}, {}]) == RS.aggregate_batcher_stats([{}, {}]) == {}


def test_registry_keys_replicas_separately():
    reg = P.EngineRegistry()
    e0 = reg.get(_slot(P), replica=0, **SLOT_KW)
    e1 = reg.get(_slot(P), replica=1, **SLOT_KW)
    assert e0 is not e1 and reg.get(_slot(P), replica=0, **SLOT_KW) is e0
    assert reg.get(_slot(P), **SLOT_KW) is e0  # replica 0 is the single engine
    assert len(reg) == 2 and reg.initializations == 2 and _slot(P) in reg
    assert reg.engines() == [e0, e1]
    reg.shutdown()
    assert len(reg) == 0


# -- single-flight, spreading and dead replicas -----------------------------------------


class GatedEngine(P.SimulatedAPIEngine):
    def __init__(self, model, gate, **kw):
        super().__init__(model, **kw)
        self.gate = gate

    def infer(self, request):
        assert self.gate.wait(TIMEOUT), "test gate never opened"
        return super().infer(request)


def test_single_flight_is_global_across_replicas():
    gate = threading.Event()
    fleet = [GatedEngine(_api(P), gate) for _ in range(4)]
    with P.InferenceService(engines=fleet, routing="round_robin", n_dispatchers=2,
                            name="fleet") as svc:
        req = P.InferenceRequest("the same expensive prompt", 16, 0.0)
        tickets = [svc.submit(req, key="dup") for _ in range(8)]
        assert tickets[0].primary and not any(t.primary for t in tickets[1:])
        gate.set()
        assert len({t.result(timeout=TIMEOUT).text for t in tickets}) == 1
        snap = svc.snapshot()
    assert sum(e.calls for e in fleet) == 1
    assert (snap["submitted"], snap["coalesced"], snap["dispatched"]) == (8, 7, 1)
    assert [r["routed"] for r in snap["replica_stats"]] == [1, 0, 0, 0]


def test_distinct_keys_spread_across_replicas_as_the_reference():
    out = {}
    for name, mod in PKGS.items():
        fleet = [mod.SimulatedAPIEngine(_api(mod)) for _ in range(2)]
        with mod.InferenceService(engines=fleet, routing="round_robin") as svc:
            tickets = [svc.submit(mod.InferenceRequest(f"unique {i}", 8, 0.0), key=f"k{i}")
                       for i in range(10)]
            texts = [t.result(timeout=TIMEOUT).text for t in tickets]
            snap = svc.snapshot()
        out[name] = (texts, [e.calls for e in fleet],
                     {k: v for k, v in snap.items() if k != "replica_stats"})
    assert out["port"] == out["jax"] and out["port"][1] == [5, 5]


class DyingSlotEngine(P.SimulatedSlotEngine):
    """A slot engine whose pump raises once ``die`` is set."""

    def __init__(self, model, **kw):
        super().__init__(model, **kw)
        self.die = threading.Event()

    def stream_pump(self):
        if self.die.is_set():
            raise RuntimeError("replica hardware fault")
        return super().stream_pump()


def test_dead_replica_fails_its_tickets_without_stranding_gathers():
    sick = DyingSlotEngine(_slot(P), **SLOT_KW)
    healthy = P.SimulatedSlotEngine(_slot(P), **SLOT_KW)
    sick.die.set()
    with P.InferenceService(engines=[sick, healthy], routing="round_robin",
                            max_batch_wait_ms=0.0, name="split") as svc:
        tickets = [svc.submit(P.InferenceRequest(f"prompt {i}", 8, 0.0), key=f"k{i}")
                   for i in range(8)]
        outcomes = []
        for t in tickets:
            try:
                assert t.result(timeout=TIMEOUT).error is None
                outcomes.append("ok")
            except RuntimeError as e:
                assert "hardware fault" in str(e)
                outcomes.append("fail")
        # the first goes to the sick replica, the second to the healthy one
        # (the only one alive, or next in the rotation)
        assert outcomes[:2] == ["fail", "ok"]
        late = [svc.submit(P.InferenceRequest(f"late {i}", 8, 0.0), key=f"l{i}")
                for i in range(4)]
        assert all(t.result(timeout=TIMEOUT).error is None for t in late)
        per = {r["index"]: r for r in svc.snapshot()["replica_stats"]}
    assert per[0]["broken"] and not per[1]["broken"] and per[1]["completed"] >= 5


def test_whole_fleet_dead_breaks_the_service():
    fleet = [DyingSlotEngine(_slot(P), **SLOT_KW) for _ in range(2)]
    for e in fleet:
        e.die.set()
    with P.InferenceService(engines=fleet, routing="round_robin",
                            max_batch_wait_ms=0.0) as svc:
        tickets = [svc.submit(P.InferenceRequest(f"doomed {i}", 8, 0.0), key=f"d{i}")
                   for i in range(2)]
        for t in tickets:
            with pytest.raises(RuntimeError, match="hardware fault"):
                t.result(timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="dispatch failed.*replica 1:"):
            svc.submit(P.InferenceRequest("after the fall", 8, 0.0), key="x")


# -- session plumbing -----------------------------------------------------------------


def test_session_builds_replica_fleet_from_inference_config():
    rows = mixed_examples(30, seed=11)
    out = {}
    for name, mod in PKGS.items():
        with _session(mod, engine_kwargs=SLOT_KW) as session:
            res = session.run_task(rows, _task(mod, n_replicas=3, routing="round_robin"))
            (snap,) = session.serving_stats()
            assert snap["replicas"] == 3 and len(session.engines) == 3
        assert not res.failures
        per = snap["replica_stats"]
        # steps and occupancy follow how submissions interleave with pumps;
        # admissions and completions do not
        out[name] = (res, [r["routed"] for r in per], [r["dispatched"] for r in per],
                     [snap["batcher"][k] for k in ("admissions", "completions")])
    (p, *pc), (j, *jc) = out["port"], out["jax"]
    assert p.responses == j.responses and pc == jc
    _assert_metrics_as_the_reference(p, j)


def test_suite_report_shows_replica_column():
    rows = mixed_examples(20, seed=13)
    suite = P.EvalSuite("repmd").add_task(_task(P, task_id="qa", n_replicas=2), rows)
    with _session(P, engine_kwargs=SLOT_KW) as session:
        md = session.run_suite(suite).to_markdown()
    assert "## Inference service" in md and "| replicas |" in md
    assert "| batcher | 2 " in md


def test_replica_aggregation_invariants():
    rows = mixed_examples(48, seed=9)
    with _session(P, engine_kwargs=SLOT_KW) as session:
        session.run_task(rows, _task(P, n_replicas=3, routing="round_robin"))
        (snap,) = session.serving_stats()
    assert snap["mode"] == "batcher" and snap["replicas"] == 3
    b, per = snap["batcher"], snap["replica_stats"]
    assert b["admissions"] == snap["dispatched"] and b["completions"] == snap["completed"]
    assert 0.0 < b["slot_occupancy"] <= 1.0
    assert sum(r["dispatched"] for r in per) == snap["dispatched"]
    assert sum(r["completed"] for r in per) == snap["completed"]
    assert all(r["routed"] > 0 for r in per)
    assert sum(r["batcher"]["admissions"] for r in per) == b["admissions"]


def test_prefill_cap_defers_admissions_and_keeps_the_texts():
    prompts = [f"identical workload {i}" for i in range(10)]

    def run(cap):
        eng = P.SimulatedSlotEngine(_slot(P), n_slots=4, step_ms=0.0,
                                    max_prefills_per_step=cap)
        rids = {eng.stream_submit(P.InferenceRequest(p, 8, 0.0)): p for p in prompts}
        out = {}
        while eng.stream_pending():
            for rid, resp in eng.stream_pump():
                out[rids[rid]] = resp.text
        return out, eng.stats

    (base, _), (capped, st), (two, _) = run(0), run(1), run(2)
    assert base == capped == two
    assert st.admissions == st.completions == 10 and st.prefills_deferred > 0


def test_session_forwards_the_prefill_cap_to_every_replica():
    rows = mixed_examples(16, seed=2)
    with _session(P, engine_kwargs=SLOT_KW) as session:
        session.run_task(rows, _task(P, n_replicas=2, max_prefills_per_step=1))
        engines = session.engines.engines()
    assert [e.max_prefills_per_step for e in engines] == [1, 1]


# -- replica-count parity ---------------------------------------------------------------


@pytest.mark.parametrize("routing", ["least_loaded", "prefix_affinity"])
def test_replica_count_parity_suite_output(routing):
    """1, 2 and 4 slot-simulator replicas: texts, metrics and the
    significance matrix are the single replica's, and the reference's."""
    rows = mixed_examples(60, seed=5)

    def run(mod, n):
        suite = (mod.EvalSuite(f"rep{n}")
                 .add_task(_task(mod, n_replicas=n, routing=routing), rows)
                 .sweep_models([_slot(mod), _slot(mod, "slot-sim-b")]))
        with _session(mod, engine_kwargs=SLOT_KW) as session:
            res = session.run_suite(suite, parallel_jobs=2)
            snaps = session.serving_stats()
        return res, snaps

    base, _ = run(P, 1)
    ref, _ = run(R, 1)
    for key, res in base.results.items():
        assert res.responses == ref.results[key].responses
        _assert_metrics_as_the_reference(res, ref.results[key])
    for n in (2, 4):
        got, snaps = run(P, n)
        for key, res in base.results.items():
            assert got.results[key].responses == res.responses, key
            for m, mv in res.metrics.items():
                assert _mv_tuple(got.results[key].metrics[m]) == _mv_tuple(mv)
        for task_id, metrics in base.comparisons.items():
            for metric, cells in metrics.items():
                for pair, cmp in cells.items():
                    assert _cmp_tuple(got.comparisons[task_id][metric][pair]) == \
                        _cmp_tuple(cmp)
        for snap in snaps:
            assert snap["replicas"] == n and len(snap["replica_stats"]) == n


class _JaxF32:
    """The JAX model run in f32 (the port's CPU tests hold the two models
    to equal greedy tokens in f32)."""

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


def test_local_replica_count_parity_equals_the_single_engine_and_the_reference(f32):
    """A reduced ``"torch_local"`` qwen3 over 1, 2 and 3 replicas under each
    policy, in memory and streaming: the texts and metrics of the port's
    single engine and of the JAX session's single-replica run.  Under round
    robin and prefix affinity each replica's dispatches are fixed."""
    rows = qa_examples(10)
    kw = {"engine_kwargs": {"n_slots": 3, "max_len": 64}}

    def task(mod, provider, streaming=False, **inf):
        model = mod.EngineModelConfig(provider=provider, model_name="qwen3-4b",
                                      reduced=True, seed=0, max_tokens=6)
        t = _task(mod, "local", model, **inf)
        return t.with_streaming(max_memory_rows=4) if streaming else t

    with R.EvalSession(**kw) as s:
        ref = s.run_task(rows, task(R, "local"))
    single = {}
    for streaming in (False, True):
        with _session(P, **kw) as s:
            single[streaming] = s.run_task(rows, task(P, "torch_local", streaming))
    assert single[False].responses == ref.responses and len(set(ref.responses)) > 2
    _assert_metrics_as_the_reference(single[False], ref)
    for routing in POLICIES:
        for n in (2, 3):
            for streaming in (False, True):
                with _session(P, **kw) as s:
                    got = s.run_task(rows, task(P, "torch_local", streaming,
                                                n_replicas=n, routing=routing))
                    (snap,) = s.serving_stats()
                    engines = s.engines.engines()
                base = single[streaming]
                assert got.responses == base.responses, (routing, n, streaming)
                assert not got.failures and got.engine_stats == base.engine_stats
                for m, mv in base.metrics.items():
                    assert _mv_tuple(got.metrics[m]) == _mv_tuple(mv)
                if streaming:
                    a, b = got.stream_stats, base.stream_stats
                    assert {k: (c.n, c.total, c.total_sq) for k, c in a.accs.items()} == \
                        {k: (c.n, c.total, c.total_sq) for k, c in b.accs.items()}
                    np.testing.assert_array_equal(a.engine.sum_wx, b.engine.sum_wx)
                    np.testing.assert_array_equal(a.engine.sum_w, b.engine.sum_w)
                assert len({id(e.tokenizer) for e in engines}) == 1
                per = [r["dispatched"] for r in snap["replica_stats"]]
                assert sum(per) == len(rows) and len(per) == n
                if routing == "round_robin":
                    assert per == [len(range(i, len(rows), n)) for i in range(n)]
                if routing == "prefix_affinity":
                    router = RS.ReplicaRouter("prefix_affinity")
                    views = [RS.ReplicaView(i, 0, 0) for i in range(n)]
                    want = [0] * n
                    for r in rows:
                        want[router.route(r["question"], views)] += 1
                    assert per == want


def test_submit_does_not_wait_for_the_engine_locks():
    """A submission is routed (each replica's queue and outstanding count read) and handed
    to ``prepare`` in the submitter's thread; neither may wait for an
    engine lock, which a batcher thread holds for a whole step (a waiting
    submitter feeds the slots one prompt a step).  Other threads hold both
    replicas' locks while the submissions are made, then release them and
    the requests are served."""
    model = P.EngineModelConfig(model_name="qwen3-4b", reduced=True, seed=0, max_tokens=4)
    fleet = [P.TorchLocalEngine(model, n_slots=2, max_len=64, device="cpu") for _ in range(2)]
    for e in fleet:
        e.initialize()
    held = [threading.Event() for _ in fleet]
    release = threading.Event()

    def hold(engine, event):
        with engine._lock:
            event.set()
            release.wait(TIMEOUT)

    holders = [threading.Thread(target=hold, args=(e, ev)) for e, ev in zip(fleet, held)]
    for t in holders:
        t.start()
    with P.InferenceService(engines=fleet, routing="least_loaded",
                            max_batch_wait_ms=0.0) as svc:
        try:
            assert all(ev.wait(TIMEOUT) for ev in held)
            tickets = []
            submitter = threading.Thread(target=lambda: tickets.extend(
                svc.submit(P.InferenceRequest(f"what is a neuron {i} ?", 4), key=str(i))
                for i in range(4)))
            submitter.start()
            submitter.join(TIMEOUT)
            assert not submitter.is_alive() and len(tickets) == 4
            assert "neuron" in fleet[0]._tokenizer._inverse.values()
        finally:
            release.set()
            for t in holders:
                t.join(TIMEOUT)
        assert all(t.result(timeout=TIMEOUT).error is None for t in tickets)
    assert not any(t.is_alive() for t in holders)


class _CountingPrepare(P.SimulatedSlotEngine):
    """A slot simulator with the local engine's ``prepare`` hook, counted."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prepared = []

    def prepare(self, request):
        self.prepared.append(request.prompt)


@pytest.mark.parametrize("n", [1, 2])
def test_prepare_is_called_only_with_several_replicas(n):
    """A one-replica service leaves the encoding to ``stream_submit`` (one
    pass a prompt); with several replicas each submission is prepared once,
    in submission order, on the replica it was routed to."""
    fleet = [_CountingPrepare(_slot(P), **SLOT_KW) for _ in range(n)]
    prompts = [f"prompt {i}" for i in range(6)]
    with P.InferenceService(engines=fleet, routing="round_robin",
                            max_batch_wait_ms=0.0) as svc:
        tickets = [svc.submit(P.InferenceRequest(p, 4), key=p) for p in prompts]
        assert all(t.result(timeout=TIMEOUT).error is None for t in tickets)
    if n == 1:
        assert fleet[0].prepared == []
    else:
        assert [e.prepared for e in fleet] == [prompts[0::2], prompts[1::2]]
