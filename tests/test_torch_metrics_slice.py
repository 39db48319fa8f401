"""The metrics slice end to end: the JAX package's ``EvalSession.run_task``
against the port's with all seven ported metrics (``exact_match``,
``contains``, ``token_f1``, ``bleu``, ``rouge_l``, ``embedding_similarity``
and ``bertscore``), under the reference's default ``ci_method="bca"`` and
under ``"analytical"``.  Both serve the same reduced qwen3-4b weights (the
JAX engine's seed-0 parameters, bridged) in f32, 24 QA rows in chunks of 8,
B=200; the JAX statistics run on its ``pallas`` backend in CPU ref mode,
the port's on its ``device`` backend on the CPU, and the port's BERTScore
on the CPU through kernel 7's plain version.

The tokens are equal, so the lexical scores are equal: their values and
analytical intervals exactly, their bootstrap intervals within 1e-5 (the
same weights, f32 partials summed in another order).  Semantic values
agree within 1e-6 (f32 embeddings matched in another order) and their
intervals within 1e-5."""

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
from repro.core import InferenceConfig
from repro.core import MetricConfig as JaxMetric
from repro.core import StatisticsConfig as JaxStats
from repro.data import iter_qa_examples as jax_rows
from repro.metrics.registry import BINARY_METRICS as JAX_BINARY
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro.stats import streaming_ci as jax_streaming_ci
from repro_torch.configs import get_config
from repro_torch.core import (
    EngineModelConfig,
    EvalSession,
    EvalTask,
    MetricConfig,
    StatisticsConfig,
)
from repro_torch.data import iter_qa_examples
from repro_torch.metrics import BINARY_METRICS
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.stats import streaming_ci

N_ROWS, CHUNK, N_BOOT, MAX_TOKENS = 24, 8, 200, 16
N_SLOTS, MAX_LEN = 4, 64
LEXICAL = ("exact_match", "contains", "token_f1", "bleu", "rouge_l")
SEMANTIC = {"embedding_similarity": "semantic", "bertscore": "semantic"}
METRICS = {**{m: "lexical" for m in LEXICAL}, **SEMANTIC}


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
def port_params():
    """The JAX engine's seed-0 parameters of the reduced model, bridged."""
    model = JaxLM(jax_get_config("qwen3-4b").reduced(), remat="none")
    tree = jax.tree.map(np.asarray,
                        jax_pm.init_params(jax.random.key(0), model.param_specs()))
    return params_from_jax(tree, get_config("qwen3-4b").reduced(), device="cpu",
                           dtype=torch.float32)


def _record_texts(monkeypatch, stages_mod, sink):
    orig = stages_mod.ScoreStage.run

    def run(self, art, session):
        sink.extend(art.texts)
        return orig(self, art, session)

    monkeypatch.setattr(stages_mod.ScoreStage, "run", run)


def _run_jax(monkeypatch, ci_method):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model",
                        lambda cfg, **kw: _JaxF32(build(cfg, **kw)))
    texts: list[str] = []
    _record_texts(monkeypatch, jax_stages, texts)
    task = JaxTask(
        task_id="metrics-slice",
        model=JaxModelConfig(provider="local", model_name="qwen3-4b",
                             reduced=True, seed=0, max_tokens=MAX_TOKENS),
        inference=InferenceConfig(cache_dir="", n_workers=2),
        metrics=tuple(JaxMetric(m, type=t) for m, t in METRICS.items()),
        statistics=JaxStats(bootstrap_iterations=N_BOOT, ci_method=ci_method,
                            backend="pallas"),
    ).with_streaming(max_memory_rows=CHUNK)
    with JaxSession(engine_kwargs={"n_slots": N_SLOTS, "max_len": MAX_LEN}) as s:
        result = s.run_task(jax_rows(N_ROWS, seed=0), task)
    return result, texts


def _run_port(monkeypatch, params, ci_method):
    monkeypatch.setattr(port_engines, "build_model", _PortF32)
    texts: list[str] = []
    _record_texts(monkeypatch, port_stages, texts)
    task = EvalTask(
        task_id="metrics-slice",
        model=EngineModelConfig(provider="torch_local", model_name="qwen3-4b",
                                reduced=True, seed=0, max_tokens=MAX_TOKENS),
        metrics=tuple(MetricConfig(m, type=t) for m, t in METRICS.items()),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method=ci_method, backend="device"),
    ).with_streaming(max_memory_rows=CHUNK)
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cpu", engine_kwargs=kw) as s:
        result = s.run_task(iter_qa_examples(N_ROWS, seed=0), task)
    return result, texts


@pytest.mark.parametrize("ci_method", ["bca", "analytical"])
def test_seven_metrics_equal_jax(monkeypatch, port_params, ci_method):
    jres, jtexts = _run_jax(monkeypatch, ci_method)
    pres, ptexts = _run_port(monkeypatch, port_params, ci_method)
    assert len(ptexts) == N_ROWS and ptexts == jtexts
    assert list(pres.metrics) == list(METRICS)
    for name in METRICS:
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.n, p.n_unscored, p.ci_method) == (j.n, j.n_unscored, j.ci_method)
        if name in LEXICAL:
            assert p.value == j.value
            if ci_method == "analytical":
                assert p.ci == j.ci
            else:
                np.testing.assert_allclose(p.ci, j.ci, atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(p.value, j.value, atol=1e-6, rtol=0)
            np.testing.assert_allclose(p.ci, j.ci, atol=1e-5, rtol=0)
        assert np.isfinite([p.value, *p.ci]).all()
    if ci_method == "analytical":
        assert pres.metrics["exact_match"].ci_method == "wilson"
        assert pres.metrics["bertscore"].ci_method == "t"
    else:
        assert {m.ci_method for m in pres.metrics.values()} == {"poisson"}
    # the result's state gives every method afterwards, as the reference's
    accs = pres.stream_stats.accs
    for name in METRICS:
        iv = streaming_ci(accs[name], None, method="analytical",
                          binary=name in BINARY_METRICS)
        jiv = jax_streaming_ci(jres.stream_stats.accs[name], None,
                               method="analytical", binary=name in JAX_BINARY)
        np.testing.assert_allclose([iv.lo, iv.hi], [jiv.lo, jiv.hi],
                                   atol=1e-5, rtol=0)

