"""Spill, crash and resume on the real engine path: the reduced qwen3-4b
through the port's ``torch_local`` engine (``device="cpu"``) against the
JAX local engine, the JAX engine's seed-0 weights carried across by
``params_from_jax`` and every call in f32 (as ``tests/test_torch_suite.py``
does).  Three chunks of four rows; each package runs once uninterrupted,
once crashed by ``ChunkCrashMiddleware`` after chunk 1, and once resumed:
the resumed run sends only chunk 2's prompts to the engine and equals the
uninterrupted run bit for bit, in the port and against the JAX package,
with the same texts; a concurrent port run (two chunks in flight through
one batcher) gives the same result too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.engines as jax_engines  # noqa: F401  (registers the local engine)
import repro.core.stages as jax_stages
import repro.ft as RF
import repro.models.model as jax_model_mod
import repro_torch.core as P
import repro_torch.core.engines as port_engines
import repro_torch.core.stages as port_stages
import repro_torch.ft as PF
from repro.configs import get_config as jax_get_config
from repro.data import iter_qa_examples as jax_rows
from repro.models import params as jax_pm
from repro_torch.configs import get_config
from repro_torch.data import iter_qa_examples as port_rows
from repro_torch.models import TransformerLM, params_from_jax

N_ROWS, CHUNK, MAX_TOKENS, N_SLOTS, MAX_LEN, N_BOOT = 12, 4, 8, 4, 64, 200
ARCH = "qwen3-4b"
ENGINE_KW = {"n_slots": N_SLOTS, "max_len": MAX_LEN}


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
def bridged():
    jcfg = jax_get_config(ARCH).reduced()
    model = jax_model_mod.build_model(jcfg, remat="none")
    tree = jax.tree.map(np.asarray,
                        jax_pm.init_params(jax.random.key(0), model.param_specs()))
    cfg = get_config(ARCH).reduced()
    return params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)


@pytest.fixture
def f32(monkeypatch, bridged):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model",
                        lambda c, **kw: _JaxF32(build(c, **kw)))
    monkeypatch.setattr(port_engines, "build_model", lambda cfg: _PortF32(cfg))
    monkeypatch.setattr(port_engines, "init_params", lambda cfg, seed, device: bridged)


def _task(mod, spill_dir, **stream_kw):
    provider = "torch_local" if mod is P else "local"
    return mod.EvalTask(
        "local-stream",
        model=mod.EngineModelConfig(provider=provider, model_name=ARCH, reduced=True,
                                    seed=0, max_tokens=MAX_TOKENS),
        inference=mod.InferenceConfig(n_workers=2),
        metrics=(mod.MetricConfig("exact_match"), mod.MetricConfig("token_f1")),
        statistics=mod.StatisticsConfig(bootstrap_iterations=N_BOOT, ci_method="percentile"),
    ).with_streaming(max_memory_rows=CHUNK, spill_dir=spill_dir, **stream_kw)


def _session(mod, **kw):
    extra = {"device": "cpu"} if mod is P else {}
    return mod.EvalSession(engine_kwargs=ENGINE_KW, **extra, **kw)


def _rows(mod):
    return (port_rows if mod is P else jax_rows)(N_ROWS, seed=0)


def _state(res):
    ss = res.stream_stats
    return (
        {k: (v.value, v.ci, v.n) for k, v in res.metrics.items()},
        {k: (a.n, a.total, a.total_sq, a.n_nan) for k, a in ss.accs.items()},
        ss.engine.sum_wx.tobytes(), ss.engine.sum_w.tobytes(),
    )


def test_local_engine_crash_resume_equals_the_reference(tmp_path, monkeypatch, f32):
    texts = {P: [], R: []}
    for mod, stages in ((P, port_stages), (R, jax_stages)):
        orig = stages.ScoreStage.run

        def run(self, art, session, _orig=orig, _sink=texts[mod]):
            _sink.append(list(art.texts))
            return _orig(self, art, session)

        monkeypatch.setattr(stages.ScoreStage, "run", run)

    out = {}
    for mod in (P, R):
        ft = PF if mod is P else RF
        task = _task(mod, str(tmp_path / mod.__name__ / "spill"))
        with _session(mod) as s:
            ref = s.run_task(_rows(mod), _task(mod, str(tmp_path / mod.__name__ / "ref")))
            ref_texts = [t for chunk in texts[mod] for t in chunk]
            texts[mod].clear()
            crash = ft.ChunkCrashMiddleware([ft.Fault(shard=1, attempt=1)])
            s.middleware.append(crash)
            with pytest.raises(ft.SimulatedCrash):
                s.run_task(_rows(mod), task)
            s.middleware.remove(crash)
            calls = s.accounting.engine_calls
            assert calls == N_ROWS + 2 * CHUNK
            # the resume runs in the same session, on the same engine
            res = s.run_task(_rows(mod), task)
            assert s.accounting.engine_calls - calls == CHUNK
            assert len(s.engines) == 1
            resumed_texts = [t for chunk in texts[mod] for t in chunk]
        assert resumed_texts == ref_texts  # chunks 0-1 before the crash, then 2
        assert res.logs["streaming"]["n_resumed_chunks"] == 2
        assert _state(res) == _state(ref)
        out[mod] = (res, ref_texts)
    assert out[P][1] == out[R][1]
    assert _state(out[P][0]) == _state(out[R][0])


def test_local_engine_concurrent_chunks_equal_serial(tmp_path, f32):
    with _session(P) as s:
        serial = s.run_task(_rows(P), _task(P, ""))
        conc = s.run_task(_rows(P), _task(P, "", concurrency=2))
    assert _state(conc) == _state(serial)
    assert conc.engine_stats == serial.engine_stats
    assert conc.logs["streaming"]["max_resident_rows"] <= 2 * CHUNK
