"""The port's ``SimulatedSlotEngine`` against the JAX package's, call for
call on the CPU: the same sequence of submissions, pumps, cancels and
resets (drawn from a seeded generator) gives the same stream ids, the same
completions (text, token counts, latency), the same queue and slot
occupancy, the same page-pool state and the same ``serving_stats`` after
every call, over the contiguous, paged, tight-pool (page gate and
preemption), decode-growth, prefill-capped, int8 byte-budget and
no-prefix-cache configurations; the lock-step ``infer_batch`` too; and
scheduled faults (page pressure, a hang, a slow step, a crash) fire at the
same pump with the same effect.  The engine is host-only in both packages,
so no tolerance applies."""

import numpy as np
import pytest

import repro.core as R
import repro.ft as RF
import repro_torch.core as P
import repro_torch.ft as PF

PKGS = {"port": (P, PF), "jax": (R, RF)}

CONFIGS = {
    "contiguous": {},
    "paged": {"kv_page_size": 4},
    "tight-pool": {"kv_page_size": 4, "page_pool": 9},
    "decode-growth": {"kv_page_size": 4, "page_pool": 14, "decode_page_growth": True},
    "prefill-cap": {"max_prefills_per_step": 1},
    "int8-budget": {"kv_page_size": 8, "kv_cache_dtype": "int8", "page_pool_bytes": 400_000},
    "no-prefix-cache": {"kv_page_size": 4, "prefix_cache": False},
}

HEADERS = ("shared header words for every prompt here", "another few shot header",
           "")


def _prompts(rng, n):
    out = []
    for i in range(n):
        head = HEADERS[int(rng.integers(len(HEADERS)))]
        body = " ".join(f"w{int(rng.integers(50))}" for _ in range(int(rng.integers(1, 7))))
        out.append(f"{head} {body} q{i}".strip())
    return out


def _ops(seed, n_ops=160):
    """A seeded op sequence: ("submit", prompt, max_tokens), ("pump",),
    ("cancel", k-th rid issued so far), ("reset",)."""
    rng = np.random.default_rng(seed)
    prompts = _prompts(rng, 40)
    ops, issued = [], 0
    for _ in range(n_ops):
        u = rng.random()
        if u < 0.35:
            ops.append(("submit", prompts[int(rng.integers(len(prompts)))],
                        int(rng.integers(1, 40))))
            issued += 1
        elif u < 0.42 and issued:
            ops.append(("cancel", int(rng.integers(issued))))
        elif u < 0.43:
            ops.append(("reset",))
        else:
            ops.append(("pump",))
    return ops + [("pump",)] * 200


def _state(eng):
    pages = eng._pages
    return (eng.slots_busy(), eng.stream_pending(), eng.serving_stats(),
            None if pages is None else (pages.pages_free, pages.pages_cached,
                                        pages.pages_active))


def _drive(mod, cfg, ops, plan=None):
    kw = dict(cfg)
    if plan is not None:
        kw["fault_plan"] = plan
    eng = mod.SimulatedSlotEngine(
        mod.EngineModelConfig(provider="slotsim", model_name="slot-sim"),
        n_slots=4, step_ms=0.25, **kw)
    eng.initialize()
    rids, log = [], []
    for op in ops:
        if op[0] == "submit":
            rid = eng.stream_submit(mod.InferenceRequest(op[1], op[2], 0.0))
            rids.append(rid)
            out = rid
        elif op[0] == "cancel":
            out = eng.stream_cancel(rids[op[1]])
        elif op[0] == "reset":
            out = eng.reset()
        else:
            try:
                out = [(rid, r.text, r.input_tokens, r.output_tokens, r.latency_ms, r.error)
                       for rid, r in eng.stream_pump()]
            except RuntimeError as e:  # a scheduled replica_crash
                out = ("crash", type(e).__name__, str(e))
                eng.reset()
        log.append((op[0], out, _state(eng)))
    return log, eng


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_streaming_calls_equal_the_reference(config, seed):
    ops = _ops(seed)
    port, peng = _drive(P, CONFIGS[config], ops)
    jax, jeng = _drive(R, CONFIGS[config], ops)
    assert port == jax
    # every submission that was neither cancelled nor dropped by a reset ran
    assert peng.stats.completions > 0 and not peng.stream_pending()
    if peng._pages is not None:
        peng._pages.check_no_leaks()


@pytest.mark.parametrize("config", ["contiguous", "paged", "prefill-cap"])
def test_lockstep_infer_batch_equals_the_reference(config):
    prompts = _prompts(np.random.default_rng(7), 19)
    out = {}
    for name, (mod, _) in PKGS.items():
        eng = mod.SimulatedSlotEngine(
            mod.EngineModelConfig(provider="slotsim", model_name="slot-sim"),
            n_slots=4, step_ms=0.5, prefill_ms_per_token=0.1, **CONFIGS[config])
        got = eng.infer_batch([mod.InferenceRequest(p, 24, 0.0) for p in prompts])
        one = eng.infer(mod.InferenceRequest(prompts[3], 24, 0.0))
        out[name] = ([(r.text, r.input_tokens, r.output_tokens, r.latency_ms) for r in got],
                     (one.text, one.output_tokens, one.latency_ms), eng.calls,
                     eng.serving_stats())
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("seed", [3, 4])
def test_scheduled_faults_fire_as_the_reference(seed):
    """Page pressure, a hang, a slow step and a crash at the same pumps in
    both packages: the same preemptions, stalls, crash message and, after
    the reset, the same completions."""
    ops = _ops(seed, n_ops=120)
    logs = {}
    for name, (mod, ft) in PKGS.items():
        plan = ft.ServingFaultSchedule([
            ft.ServingFault(0, 5, "page_pressure", duration=2),
            ft.ServingFault(0, 9, "hang", duration=4),
            ft.ServingFault(0, 20, "slow_step", delay_s=0.5),
            ft.ServingFault(0, 30, "replica_crash"),
            ft.ServingFault(0, 45, "page_pressure"),
        ])
        logs[name] = _drive(mod, CONFIGS["paged"], ops, plan)[0], plan.injected
    assert logs["port"] == logs["jax"]
    log, injected = logs["port"]
    assert [k for _, _, k in injected] == ["page_pressure", "hang", "slow_step",
                                           "replica_crash", "page_pressure"]
    crashes = [out for op, out, _ in log if op == "pump" and isinstance(out, tuple)]
    assert crashes == [("crash", "SimulatedCrash",
                        "injected replica_crash replica=0 pump=30")]


def test_texts_and_lengths_are_the_reference_functions():
    """A response is the simulated API engine's text for the prompt, and an
    output length is the reference's long-tail function of the prompt."""
    prompts = _prompts(np.random.default_rng(11), 200)
    model = {name: mod.EngineModelConfig(provider="slotsim", model_name="slot-sim")
             for name, (mod, _) in PKGS.items()}
    port = P.SimulatedSlotEngine(model["port"], min_out=2, max_out=64)
    jax = R.SimulatedSlotEngine(model["jax"], min_out=2, max_out=64)
    for p in prompts:
        for max_tokens in (1, 16, 200):
            assert port._out_len(P.InferenceRequest(p, max_tokens)) == \
                jax._out_len(R.InferenceRequest(p, max_tokens))
        assert port._response(P.InferenceRequest(p, 32), 5, 1.0).text == \
            P.simulated_answer(p, 32, "slot-sim") == R.SimulatedAPIEngine(
                model["jax"]).infer(R.InferenceRequest(p, 32)).text


def test_created_by_provider_and_validated_as_the_reference():
    model = P.EngineModelConfig(provider="slotsim", model_name="slot-sim")
    eng = P.create_engine(model, n_slots=2)
    assert isinstance(eng, P.SimulatedSlotEngine) and eng.supports_streaming
    for bad, match in (({"kv_cache_dtype": "fp8"}, "kv_cache_dtype must be"),
                       ({"kv_cache_dtype": "int8"}, "requires a paged cache")):
        msgs = []
        for mod in (P, R):
            with pytest.raises(ValueError, match=match) as e:
                mod.SimulatedSlotEngine(
                    mod.EngineModelConfig(provider="slotsim", model_name="s"), **bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert sorted(eng.serving_stats()) == sorted(R.SimulatedSlotEngine(
        R.EngineModelConfig(provider="slotsim", model_name="s")).serving_stats())


def test_cancel_and_reset_free_slots_queue_and_pages():
    eng = P.SimulatedSlotEngine(P.EngineModelConfig(provider="slotsim", model_name="s"),
                                n_slots=2, kv_page_size=4)
    rids = [eng.stream_submit(P.InferenceRequest(f"a b c d e f g {i}", 30)) for i in range(4)]
    eng.stream_pump()
    assert eng.slots_busy() == 4
    assert eng.stream_cancel(rids[0]) and eng.stream_cancel(rids[3])
    assert not eng.stream_cancel(rids[0]) and eng.slots_busy() == 2
    eng.reset()
    assert eng.slots_busy() == 0 and not eng.stream_pending()
    eng._pages.check_no_leaks()
    assert eng.serving_stats()["admissions"] == 2  # counters survive a reset
