"""The slice end to end: the JAX package's ``EvalSession.run_task`` against
the port's, on the same reduced qwen3-4b weights (the JAX engine's seed-0
parameters, bridged), the same 24 QA rows in chunks of 8, ``exact_match``
and ``token_f1``, percentile CIs with B=200.  The JAX statistics run on its
``pallas`` backend in CPU ref mode, the port's on its ``device`` backend
(the kernel's plain version on the CPU)."""

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
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import (
    EngineModelConfig,
    EvalSession,
    EvalTask,
    MetricConfig,
    StatisticsConfig,
)
from repro_torch.data import iter_qa_examples
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.serve import ContinuousBatcher, Request

N_ROWS, CHUNK, N_BOOT, MAX_TOKENS = 24, 8, 200, 16
N_SLOTS, MAX_LEN = 4, 64
#: the model test's bf16 logit tolerance (tests/test_torch_model.py)
BF16_LOGIT_TOL = 2e-2


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
def jax_params():
    """What the JAX engine builds: seed-0 params of the reduced model."""
    cfg = jax_get_config("qwen3-4b").reduced()
    model = JaxLM(cfg, remat="none")
    params = jax_pm.init_params(jax.random.key(0), model.param_specs())
    return cfg, model, params, jax.tree.map(np.asarray, params)


def _record_texts(monkeypatch, stages_mod, sink):
    orig = stages_mod.ScoreStage.run

    def run(self, art, session):
        sink.extend(art.texts)
        return orig(self, art, session)

    monkeypatch.setattr(stages_mod.ScoreStage, "run", run)


def _run_jax(monkeypatch, f32):
    if f32:
        build = jax_model_mod.build_model
        monkeypatch.setattr(jax_model_mod, "build_model",
                            lambda cfg, **kw: _JaxF32(build(cfg, **kw)))
    texts: list[str] = []
    _record_texts(monkeypatch, jax_stages, texts)
    task = JaxTask(
        task_id="slice",
        model=JaxModelConfig(provider="local", model_name="qwen3-4b",
                             reduced=True, seed=0, max_tokens=MAX_TOKENS),
        inference=InferenceConfig(cache_dir="", n_workers=2),
        metrics=(JaxMetric("exact_match"), JaxMetric("token_f1")),
        statistics=JaxStats(bootstrap_iterations=N_BOOT, ci_method="percentile",
                            backend="pallas"),
    ).with_streaming(max_memory_rows=CHUNK)
    with JaxSession(engine_kwargs={"n_slots": N_SLOTS, "max_len": MAX_LEN}) as s:
        result = s.run_task(jax_rows(N_ROWS, seed=0), task)
    return result, texts


def _run_port(monkeypatch, params, f32):
    if f32:
        monkeypatch.setattr(port_engines, "build_model", _PortF32)
    texts: list[str] = []
    _record_texts(monkeypatch, port_stages, texts)
    task = EvalTask(
        task_id="slice",
        model=EngineModelConfig(provider="torch_local", model_name="qwen3-4b",
                                reduced=True, seed=0, max_tokens=MAX_TOKENS),
        metrics=(MetricConfig("exact_match"), MetricConfig("token_f1")),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
    ).with_streaming(max_memory_rows=CHUNK)
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cpu", engine_kwargs=kw) as s:
        result = s.run_task(iter_qa_examples(N_ROWS, seed=0), task)
    return result, texts


def test_f32_slice_equals_jax(monkeypatch, jax_params):
    cfg, *_, tree = jax_params
    params = params_from_jax(tree, get_config("qwen3-4b").reduced(), device="cpu",
                             dtype=torch.float32)
    jres, jtexts = _run_jax(monkeypatch, f32=True)
    pres, ptexts = _run_port(monkeypatch, params, f32=True)
    assert len(ptexts) == N_ROWS and ptexts == jtexts
    assert pres.stream_stats.engine.stream_id() == "device-ref"
    for name in ("exact_match", "token_f1"):
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.value, p.n, p.n_unscored) == (j.value, j.n, j.n_unscored)
        # identical weights, f32 partials summed in another order: the
        # percentile bounds of the B replicate means agree to 1e-5
        np.testing.assert_allclose(p.ci, j.ci, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        pres.stream_stats.engine.sum_w, jres.stream_stats.engine.sum_w, rtol=0
    )


def _prompts():
    tok = JaxTokenizer(512)
    out = []
    for r in jax_rows(N_ROWS, seed=0):
        toks = tok.encode(r["question"])[: MAX_LEN // 2]
        out.append((toks, min(MAX_TOKENS, MAX_LEN - len(toks) - 1)))
    return out


def _top_two_gap(model, params, prompt, tokens, step):
    """The JAX bf16 model's top-two logit gap where it chose
    ``tokens[step]`` (teacher-forced along its own tokens, batch of one)."""
    specs = model.cache_specs(1, MAX_LEN, jnp.float32)
    cache = jax_pm.init_params(jax.random.key(1), specs)
    logits, cache = model.prefill(params, {"tokens": jnp.asarray([prompt], jnp.int32)},
                                  cache)
    for i in range(step):
        logits, cache = model.decode_step(
            params, jnp.asarray([[tokens[i]]], jnp.int32), cache,
            jnp.asarray([len(prompt) + i], jnp.int32),
        )
    row = np.sort(np.asarray(logits, np.float32)[0, :512])
    return float(row[-1] - row[-2])


def test_bf16_differences_sit_on_thin_logit_gaps(jax_params):
    """In bf16 the two frameworks round at different places, so a greedy
    token may flip where the top two logits nearly tie.  Every row whose
    tokens differ must first differ at a step where the JAX top-two gap is
    under the bf16 logit tolerance."""
    cfg, model, params, tree = jax_params
    work = _prompts()
    jsched = JaxBatcher(model, cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, eos_id=1)
    pcfg = get_config("qwen3-4b").reduced()
    psched = ContinuousBatcher(TransformerLM(pcfg), pcfg,
                               params_from_jax(tree, pcfg, device="cpu"),
                               n_slots=N_SLOTS, max_len=MAX_LEN, eos_id=1)
    for i, (toks, n_new) in enumerate(work):
        jsched.submit(JaxRequest(i, prompt_tokens=toks, max_new_tokens=n_new))
        psched.submit(Request(i, prompt_tokens=toks, max_new_tokens=n_new))
    jt = {c.request_id: c.tokens for c in jsched.run_to_completion()}
    pt = {c.request_id: c.tokens for c in psched.run_to_completion()}
    assert sorted(pt) == sorted(jt) == list(range(N_ROWS))
    n_same = 0
    for i, (toks, _) in enumerate(work):
        if pt[i] == jt[i]:
            n_same += 1
            continue
        step = next(t for t, (a, b) in enumerate(zip(pt[i], jt[i])) if a != b)
        gap = _top_two_gap(model, params, toks, jt[i], step)
        assert gap < BF16_LOGIT_TOL, (i, step, gap)
    assert n_same >= N_ROWS // 2
