"""The MLA slice end to end: the JAX package's ``EvalSession.run_task``
against the port's on reduced minicpm3-4b (dense, tied, the query
bottleneck) and reduced deepseek-v2-236b (MLA on the MoE stack: one dense
leading layer, a shared expert, 8 routed experts top 2, untied), with the
JAX engine's seed-0 weights bridged and both models in f32.  24 QA rows in
chunks of 8, ``exact_match`` and ``token_f1``, percentile CIs with B=200,
on the contiguous cache (the only one MLA has); and the refusals the
reference makes: a paged engine, word for word, and a suffix prefill."""

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
from repro.models.model import TransformerLM as JaxLM
from repro.serve import ContinuousBatcher as JaxBatcher
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
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.serve import ContinuousBatcher

ARCHS = ("minicpm3-4b", "deepseek-v2-236b")
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


class _PortF32(TransformerLM):
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


def _run_jax(monkeypatch, arch):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model",
                        lambda cfg, **kw: _JaxF32(build(cfg, **kw)))
    texts: list[str] = []
    _record_texts(monkeypatch, jax_stages, texts)
    task = JaxTask(
        task_id="mla-slice",
        model=JaxModelConfig(provider="local", model_name=arch, reduced=True,
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


def _run_port(monkeypatch, arch, params):
    monkeypatch.setattr(port_engines, "build_model", _PortF32)
    texts: list[str] = []
    _record_texts(monkeypatch, port_stages, texts)
    task = EvalTask(
        task_id="mla-slice",
        model=EngineModelConfig(provider="torch_local", model_name=arch,
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


def _jax_tree(arch):
    """What the JAX engine builds: the seed-0 parameters of the reduced
    model, as numpy arrays."""
    model = JaxLM(jax_get_config(arch).reduced(), remat="none")
    return model, jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(0),
                                                              model.param_specs()))


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_mla_slice_equals_jax(monkeypatch, arch):
    _, tree = _jax_tree(arch)
    params = params_from_jax(tree, get_config(arch).reduced(), device="cpu",
                             dtype=torch.float32)
    jres, jtexts, jstats = _run_jax(monkeypatch, arch)
    pres, ptexts, pstats = _run_port(monkeypatch, arch, params)
    assert len(ptexts) == N_ROWS and ptexts == jtexts
    assert any(ptexts)
    for name in ("exact_match", "token_f1"):
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.value, p.n, p.n_unscored) == (j.value, j.n, j.n_unscored)
        # identical weights, f32 partials summed in another order: the
        # percentile bounds of the B replicate means agree to 1e-5
        np.testing.assert_allclose(p.ci, j.ci, atol=1e-5, rtol=0)
    for key in ("admissions", "completions", "tokens_generated", "steps"):
        assert pstats[key] == jstats[key], key
    assert pstats["kv_bytes_per_token"] == jstats["kv_bytes_per_token"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_mla_engine_raises_the_reference_error(arch):
    """A paged cache on an MLA config: the port's batcher raises the
    reference's error word for word, and so does the port's engine; on
    a GQA config of the same family it builds."""
    jmodel, tree = _jax_tree(arch)
    jcfg = jmodel.cfg
    with pytest.raises(ValueError) as jerr:
        JaxBatcher(jmodel, jcfg, jax.tree.map(jnp.asarray, tree), n_slots=2,
                   max_len=32, page_size=16)
    pcfg = get_config(arch).reduced()
    params = params_from_jax(tree, pcfg, device="cpu")
    with pytest.raises(ValueError) as perr:
        ContinuousBatcher(TransformerLM(pcfg), pcfg, params, n_slots=2, max_len=32,
                          page_size=16)
    assert str(perr.value) == str(jerr.value)
    assert "with MLA" in str(perr.value)
    engine = TorchLocalEngine(
        EngineModelConfig(provider="torch_local", model_name=arch, reduced=True),
        n_slots=2, max_len=32, kv_page_size=16, device="cpu", params=params)
    with pytest.raises(ValueError) as eerr:
        engine.initialize()
    assert str(eerr.value) == str(jerr.value)


def test_suffix_prefill_raises_the_reference_error():
    """A suffix prefill on an MLA model: the reference's message."""
    jmodel, tree = _jax_tree("minicpm3-4b")
    jcache = jax_pm.init_params(jax.random.key(1),
                                jmodel.cache_specs(1, 32, jnp.float32))
    with pytest.raises(ValueError) as jerr:
        jmodel.prefill(jax.tree.map(jnp.asarray, tree),
                       {"tokens": jnp.asarray([[5, 6]], jnp.int32)}, jcache,
                       start=16)
    pcfg = get_config("minicpm3-4b").reduced()
    lm = TransformerLM(pcfg)
    with pytest.raises(ValueError) as perr:
        lm.prefill(params_from_jax(tree, pcfg, device="cpu"), torch.tensor([[5, 6]]),
                   lm.init_cache(1, 32, "cpu"), 0, start=16)
    assert str(perr.value) == str(jerr.value)
