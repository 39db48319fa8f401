"""The paged slice end to end: the JAX package's ``EvalSession.run_task``
against the port's with ``InferenceConfig(kv_page_size=16)``, on the same
reduced qwen3-4b weights (the JAX engine's seed-0 parameters, bridged), in
f32, over a few-shot task: every prompt carries the same header of worked
examples, so the paged cache's prefix index prefills it once.  24 QA rows
in chunks of 8, ``exact_match`` and ``token_f1``, percentile CIs with
B=200."""

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
from repro.core import DataConfig as JaxData
from repro.core import EngineModelConfig as JaxModelConfig
from repro.core import EvalSession as JaxSession
from repro.core import EvalTask as JaxTask
from repro.core import InferenceConfig as JaxInference
from repro.core import MetricConfig as JaxMetric
from repro.core import StatisticsConfig as JaxStats
from repro.data import iter_qa_examples as jax_rows
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro_torch.configs import get_config
from repro_torch.core import (
    DataConfig,
    EngineModelConfig,
    EvalSession,
    EvalTask,
    InferenceConfig,
    MetricConfig,
    StatisticsConfig,
)
from repro_torch.data import iter_qa_examples
from repro_torch.models import TransformerLM, params_from_jax

N_ROWS, CHUNK, N_BOOT, MAX_TOKENS = 24, 8, 200, 8
#: prompts keep max_len // 2 = 64 tokens: a 2-example header (~40 tokens,
#: two full 16-token pages) and the question fit
N_SLOTS, MAX_LEN, PAGE = 4, 128, 16


def _template():
    header = " ".join(f"Q: {r['question']} A: {r['reference']}"
                      for r in iter_qa_examples(2, seed=1))
    return header + " Q: {question} A:"


class _JaxF32:
    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def param_specs(self):
        return self.model.param_specs()

    def cache_specs(self, *a, **kw):
        return self.model.cache_specs(*a, **kw)

    def prefill(self, params, batch, cache, start=0):
        return self.model.prefill(params, batch, cache, dtype=jnp.float32,
                                  start=start)

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


def _run_jax(monkeypatch):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model",
                        lambda cfg, **kw: _JaxF32(build(cfg, **kw)))
    texts: list[str] = []
    _record_texts(monkeypatch, jax_stages, texts)
    task = JaxTask(
        task_id="paged-slice",
        model=JaxModelConfig(provider="local", model_name="qwen3-4b",
                             reduced=True, seed=0, max_tokens=MAX_TOKENS),
        inference=JaxInference(cache_dir="", n_workers=2, kv_page_size=PAGE),
        data=JaxData(prompt_template=_template()),
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
        task_id="paged-slice",
        model=EngineModelConfig(provider="torch_local", model_name="qwen3-4b",
                                reduced=True, seed=0, max_tokens=MAX_TOKENS),
        inference=InferenceConfig(kv_page_size=PAGE),
        data=DataConfig(prompt_template=_template()),
        metrics=(MetricConfig("exact_match"), MetricConfig("token_f1")),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
    ).with_streaming(max_memory_rows=CHUNK)
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cpu", engine_kwargs=kw) as s:
        result = s.run_task(iter_qa_examples(N_ROWS, seed=0), task)
        (stats,) = s.serving_stats()
        # the session serves the task's paging knobs; other knobs get an
        # engine of their own
        engine = s.engine_for(task.model, task.inference)
        other = s.engine_for(task.model, InferenceConfig(kv_page_size=8))
        assert other is not engine and other.paging["page_size"] == 8
    return result, texts, stats["batcher"]


@pytest.fixture(scope="module")
def jax_params():
    model = JaxLM(jax_get_config("qwen3-4b").reduced(), remat="none")
    params = jax_pm.init_params(jax.random.key(0), model.param_specs())
    return jax.tree.map(np.asarray, params)


def test_paged_f32_slice_equals_jax(monkeypatch, jax_params):
    params = params_from_jax(jax_params, get_config("qwen3-4b").reduced(),
                             device="cpu", dtype=torch.float32)
    jres, jtexts, jstats = _run_jax(monkeypatch)
    pres, ptexts, pstats = _run_port(monkeypatch, params)
    assert len(ptexts) == N_ROWS and ptexts == jtexts
    for name in ("exact_match", "token_f1"):
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.value, p.n, p.n_unscored) == (j.value, j.n, j.n_unscored)
        # identical weights, f32 partials summed in another order
        np.testing.assert_allclose(p.ci, j.ci, atol=1e-5, rtol=0)
    st = pstats
    assert st["prefix_pages_hit"] > 0 and st["prefix_tokens_saved"] > 0
    for key in ("prefix_pages_hit", "prefix_tokens_saved", "preemptions",
                "kv_bytes_per_token", "pool_pages", "admissions"):
        assert st[key] == jstats[key], key
