"""The hybrid slice end to end: the JAX package's ``EvalSession.run_task``
against the port's on reduced zamba2-7b (4 Mamba2 layers in 2 groups, the
shared attention block after each), with the JAX engine's seed-0 weights
bridged and both models in f32.  24 QA rows in chunks of 8,
``exact_match`` and ``token_f1``, percentile CIs with B=200, on the
contiguous cache; and a paged cache refused as the reference refuses it
(only the dense and MoE families page)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.stages as jax_stages
import repro.models.model as jax_model_mod
import repro_torch.core.engines as port_engines
import repro_torch.core.stages as port_stages
from repro.configs import get_config as jax_get_config
from repro.core import EngineModelConfig as JaxModelConfig
from repro.core import EvalSession as JaxSession
from repro.core import EvalTask as JaxTask
from repro.core import InferenceConfig as JaxInference
from repro.core import MetricConfig as JaxMetric
from repro.core import StatisticsConfig as JaxStats
from repro.data import iter_qa_examples as jax_rows
from repro.models import params as jax_pm
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import (
    EngineModelConfig,
    EvalSession,
    EvalTask,
    MetricConfig,
    StatisticsConfig,
    TorchLocalEngine,
)
from repro_torch.data import iter_qa_examples
from repro_torch.models import HybridLM, params_from_jax
from repro_torch.serve import ContinuousBatcher, Request

ARCH = "zamba2-7b"
N_ROWS, CHUNK, N_BOOT, MAX_TOKENS = 24, 8, 200, 8
N_SLOTS, MAX_LEN = 4, 64


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


class _PortF32(HybridLM):
    def prefill(self, *a, **kw):
        return super().prefill(*a, dtype=torch.float32, **kw)

    def decode_step(self, *a, **kw):
        return super().decode_step(*a, dtype=torch.float32, **kw)


def _record_texts(monkeypatch, stages_mod, sink):
    orig = stages_mod.ScoreStage.run

    def run(self, art, session):
        sink.extend(art.texts)
        return orig(self, art, session)

    monkeypatch.setattr(stages_mod.ScoreStage, "run", run)


def _run_jax(monkeypatch):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model",
                        lambda cfg, **kw: _JaxF32(build(cfg, **kw)))
    texts: list[str] = []
    _record_texts(monkeypatch, jax_stages, texts)
    task = JaxTask(
        task_id="hybrid-slice",
        model=JaxModelConfig(provider="local", model_name=ARCH, reduced=True,
                             seed=0, max_tokens=MAX_TOKENS),
        inference=JaxInference(cache_dir="", n_workers=2),
        metrics=(JaxMetric("exact_match"), JaxMetric("token_f1")),
        statistics=JaxStats(bootstrap_iterations=N_BOOT, ci_method="percentile",
                            backend="pallas"),
    ).with_streaming(max_memory_rows=CHUNK)
    with JaxSession(engine_kwargs={"n_slots": N_SLOTS, "max_len": MAX_LEN}) as s:
        result = s.run_task(jax_rows(N_ROWS, seed=0), task)
        (stats,) = s.serving_stats()
    return result, texts, stats["batcher"]


def _run_port(monkeypatch, params):
    monkeypatch.setattr(port_engines, "build_model", _PortF32)
    texts: list[str] = []
    _record_texts(monkeypatch, port_stages, texts)
    task = EvalTask(
        task_id="hybrid-slice",
        model=EngineModelConfig(provider="torch_local", model_name=ARCH,
                                reduced=True, seed=0, max_tokens=MAX_TOKENS),
        metrics=(MetricConfig("exact_match"), MetricConfig("token_f1")),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
    ).with_streaming(max_memory_rows=CHUNK)
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cpu", engine_kwargs=kw) as s:
        result = s.run_task(iter_qa_examples(N_ROWS, seed=0), task)
        (stats,) = s.serving_stats()
    return result, texts, stats["batcher"]


@pytest.fixture(scope="module")
def ref():
    """What the JAX engine builds: seed-0 params of the reduced model."""
    cfg = jax_get_config(ARCH).reduced()
    model = jax_model_mod.build_model(cfg, remat="none")
    params = jax_pm.init_params(jax.random.key(0), model.param_specs())
    return cfg, model, params, jax.tree.map(np.asarray, params)


def test_f32_hybrid_slice_equals_jax(monkeypatch, ref):
    params = params_from_jax(ref[3], get_config(ARCH).reduced(), device="cpu",
                             dtype=torch.float32)
    jres, jtexts, jstats = _run_jax(monkeypatch)
    pres, ptexts, pstats = _run_port(monkeypatch, params)
    assert len(ptexts) == N_ROWS and ptexts == jtexts
    for name in ("exact_match", "token_f1"):
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.value, p.n, p.n_unscored) == (j.value, j.n, j.n_unscored)
        # identical weights, f32 partials summed in another order: the
        # percentile bounds of the B replicate means agree to 1e-5
        np.testing.assert_allclose(p.ci, j.ci, atol=1e-5, rtol=0)
    for key in ("admissions", "completions", "tokens_generated"):
        assert pstats[key] == jstats[key], key


def test_f32_token_streams_equal_jax_batcher(ref):
    """The batcher's streams over prompts of 1-16 tokens (the JAX
    prefill's one-chunk limit) through 4 slots, 12 new tokens each: every
    request's tokens equal the JAX batcher's, through slot reuse."""
    jcfg, model, jparams, tree = ref
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(27)
    work = [(i, [int(t) for t in rng.integers(4, 512, n)], 12)
            for i, n in enumerate((1, 2, 7, 12, 16, 9, 16, 3))]
    jb = JaxBatcher(_JaxF32(model), jcfg, jparams, n_slots=N_SLOTS,
                    max_len=MAX_LEN, eos_id=1)
    pb = ContinuousBatcher(_PortF32(cfg), cfg,
                           params_from_jax(tree, cfg, device="cpu",
                                           dtype=torch.float32),
                           n_slots=N_SLOTS, max_len=MAX_LEN, eos_id=1)
    for rid, toks, n_new in work:
        jb.submit(JaxRequest(rid, prompt_tokens=toks, max_new_tokens=n_new))
        pb.submit(Request(rid, prompt_tokens=toks, max_new_tokens=n_new))
    want = {c.request_id: c.tokens for c in jb.run_to_completion()}
    got = {c.request_id: c.tokens for c in pb.run_to_completion()}
    assert got == want


def test_paged_cache_refused_as_the_reference_refuses_it(ref):
    """Only the dense and MoE families page: the port's engine raises the
    reference's error for the hybrid, at the same point."""
    jcfg, model, jparams, tree = ref
    with pytest.raises(ValueError) as jerr:
        JaxBatcher(model, jcfg, jparams, n_slots=N_SLOTS, max_len=MAX_LEN,
                   page_size=16)
    cfg = get_config(ARCH).reduced()
    params = params_from_jax(tree, cfg, device="cpu")
    with pytest.raises(ValueError) as perr:
        ContinuousBatcher(HybridLM(cfg), cfg, params, n_slots=N_SLOTS,
                          max_len=MAX_LEN, page_size=16)
    assert str(perr.value) == str(jerr.value)
    assert "not hybrid" in str(perr.value)
    engine = TorchLocalEngine(
        EngineModelConfig(provider="torch_local", model_name=ARCH, reduced=True),
        n_slots=N_SLOTS, max_len=MAX_LEN, kv_page_size=16, device="cpu",
        params=params)
    with pytest.raises(ValueError, match="not hybrid"):
        engine.initialize()
