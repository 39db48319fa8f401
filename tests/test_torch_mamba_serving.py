"""Mamba2 through the port's local engine, against the JAX package's: the
continuous batcher over the SSM cache (token streams equal the JAX
batcher's in f32), slot reuse, batch invariance, ``EvalSession.run_task``
with ``provider="torch_local"`` against ``LocalJaxEngine`` on the reduced
``mamba2-2.7b`` (the JAX engine's seed-0 weights, bridged), and paging
refused for the SSM family as the reference refuses it."""

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
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.models import params as jax_pm
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import (
    EngineModelConfig,
    EvalSession,
    EvalTask,
    InferenceConfig,
    MetricConfig,
    StatisticsConfig,
    TorchLocalEngine,
)
from repro_torch.data import iter_qa_examples
from repro_torch.models import MambaLM, params_from_jax
from repro_torch.serve import ContinuousBatcher, Request

ARCH = "mamba2-2.7b"
N_ROWS, CHUNK, N_BOOT, MAX_TOKENS = 24, 8, 200, 16
N_SLOTS, MAX_LEN = 4, 64
#: the model test's bf16 logit tolerance (tests/test_torch_ssm.py)
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


class _PortF32(MambaLM):
    def prefill(self, *a, **kw):
        return super().prefill(*a, dtype=torch.float32, **kw)

    def decode_step(self, *a, **kw):
        return super().decode_step(*a, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    """What the JAX engine builds: seed-0 params of the reduced model."""
    cfg = jax_get_config(ARCH).reduced()
    model = jax_model_mod.build_model(cfg, remat="none")
    params = jax_pm.init_params(jax.random.key(0), model.param_specs())
    return cfg, model, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def cfg():
    return get_config(ARCH).reduced()


def _params(ref, cfg, dtype):
    return params_from_jax(ref[3], cfg, device="cpu", dtype=dtype)


def _workload(seed, lengths=(1, 2, 3, 7, 12, 16, 9, 16, 2, 14)):
    """Prompts of the given lengths (at most one chunk of 16, which the
    JAX prefill accepts), 12 new tokens each."""
    rng = np.random.default_rng(seed)
    return [(i, [int(t) for t in rng.integers(4, 512, n)], 12)
            for i, n in enumerate(lengths)]


def _run_port(cfg, params, work, model_cls=_PortF32, n_slots=N_SLOTS):
    sched = ContinuousBatcher(model_cls(cfg), cfg, params, n_slots=n_slots,
                              max_len=MAX_LEN, eos_id=1)
    for rid, toks, n_new in work:
        sched.submit(Request(rid, prompt_tokens=toks, max_new_tokens=n_new))
    return sched, {c.request_id: (c.tokens, c.finished_reason)
                   for c in sched.run_to_completion()}


@pytest.mark.parametrize("seed", [11, 4])
def test_f32_token_streams_equal_jax_batcher(ref, cfg, seed):
    jcfg, model, params, _ = ref
    work = _workload(seed)
    sched = JaxBatcher(_JaxF32(model), jcfg, params, n_slots=N_SLOTS,
                       max_len=MAX_LEN, eos_id=1)
    for rid, toks, n_new in work:
        sched.submit(JaxRequest(rid, prompt_tokens=toks, max_new_tokens=n_new))
    want = {c.request_id: (c.tokens, c.finished_reason)
            for c in sched.run_to_completion()}
    _, got = _run_port(cfg, _params(ref, cfg, torch.float32), work)
    assert got == want


@pytest.mark.parametrize("short", [[7], [7, 9]])
def test_reused_slot_gives_a_fresh_engines_tokens(ref, cfg, short):
    """A slot that served a 40-token prompt and then takes a prompt shorter
    than the conv window: its prefill overwrites the window and the state,
    so the tokens, the window and the state equal a fresh batcher's."""
    params = _params(ref, cfg, torch.bfloat16)
    long = [int(t) for t in np.random.default_rng(9).integers(4, 512, 40)]
    sched = ContinuousBatcher(MambaLM(cfg), cfg, params, n_slots=2,
                              max_len=MAX_LEN, eos_id=1)
    sched.submit(Request(0, prompt_tokens=long, max_new_tokens=10))
    sched.run_to_completion()
    assert sched.cache.state[:, 0].abs().sum() > 0
    sched.submit(Request(1, prompt_tokens=short, max_new_tokens=10))
    sched.step()
    assert sched.slot_req[0].request_id == 1  # slot 0 is reused
    fresh = ContinuousBatcher(MambaLM(cfg), cfg, params, n_slots=2,
                              max_len=MAX_LEN, eos_id=1)
    fresh.submit(Request(1, prompt_tokens=short, max_new_tokens=10))
    fresh.step()
    assert torch.equal(sched.cache.conv[:, 0], fresh.cache.conv[:, 0])
    assert torch.equal(sched.cache.state[:, 0], fresh.cache.state[:, 0])
    (got,) = [c.tokens for c in sched.run_to_completion() if c.request_id == 1]
    (want,) = [c.tokens for c in fresh.run_to_completion()]
    assert got == want


def test_tokens_do_not_depend_on_the_batch(ref, cfg):
    """bf16, the serving default: each request's tokens are byte-equal
    alone in the batcher and among full slots."""
    params = _params(ref, cfg, torch.bfloat16)
    work = _workload(3, lengths=(5, 16, 1, 30, 12, 2, 22))
    _, together = _run_port(cfg, params, work, model_cls=MambaLM)
    for item in work[:4]:
        _, alone = _run_port(cfg, params, [item], model_cls=MambaLM)
        assert alone[item[0]] == together[item[0]]


@pytest.mark.parametrize("inference", [
    {"kv_page_size": 16},
    {"kv_page_size": 16, "kv_cache_dtype": "int8"},
    {"kv_page_size": 16, "prefix_cache": False},
])
def test_paging_and_int8_refused_for_mamba(ref, cfg, inference):
    """The port refuses paged and int8-paged caches for the SSM family
    with a ValueError, from the session down to the batcher, as the
    reference's batcher refuses them."""
    jcfg, model, params, _ = ref
    page = inference["kv_page_size"]
    with pytest.raises(ValueError, match="paged KV cache"):
        JaxBatcher(model, jcfg, params, n_slots=2, max_len=MAX_LEN, page_size=page)
    model_cfg = EngineModelConfig(provider="torch_local", model_name=ARCH,
                                  reduced=True, seed=0)
    with EvalSession(device="cpu") as session:
        with pytest.raises(ValueError, match="paged KV cache"):
            session.engine_for(model_cfg, InferenceConfig(**inference))
    with pytest.raises(ValueError, match="paged KV cache"):
        ContinuousBatcher(MambaLM(cfg), cfg, _params(ref, cfg, torch.bfloat16),
                          page_size=page, max_len=MAX_LEN,
                          kv_cache_dtype=inference.get("kv_cache_dtype", "bf16"))
    with pytest.raises(ValueError, match="requires a paged cache"):
        TorchLocalEngine(model_cfg, device="cpu", kv_cache_dtype="int8")


def test_engine_serves_mamba_through_build_model():
    model_cfg = EngineModelConfig(provider="torch_local", model_name=ARCH,
                                  reduced=True, seed=0, max_tokens=4)
    eng = TorchLocalEngine(model_cfg, n_slots=2, max_len=32, device="cpu")
    eng.initialize()
    assert isinstance(eng.batcher.model, MambaLM)
    assert eng.batcher.cache.state.shape == (2, 2, 8, 16, 16)


# -- run_task against the JAX session --------------------------------------------


def _record_texts(monkeypatch, stages_mod, sink):
    orig = stages_mod.ScoreStage.run

    def run(self, art, session):
        sink.extend(art.texts)
        return orig(self, art, session)

    monkeypatch.setattr(stages_mod.ScoreStage, "run", run)


def _run_jax_task(monkeypatch):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model",
                        lambda c, **kw: _JaxF32(build(c, **kw)))
    texts: list[str] = []
    _record_texts(monkeypatch, jax_stages, texts)
    task = JaxTask(
        task_id="mamba",
        model=JaxModelConfig(provider="local", model_name=ARCH, reduced=True,
                             seed=0, max_tokens=MAX_TOKENS),
        inference=JaxInference(cache_dir="", n_workers=2),
        metrics=(JaxMetric("exact_match"), JaxMetric("token_f1")),
        statistics=JaxStats(bootstrap_iterations=N_BOOT, ci_method="percentile",
                            backend="pallas"),
    ).with_streaming(max_memory_rows=CHUNK)
    with JaxSession(engine_kwargs={"n_slots": N_SLOTS, "max_len": MAX_LEN}) as s:
        result = s.run_task(jax_rows(N_ROWS, seed=0), task)
    return result, texts


def _run_port_task(monkeypatch, params):
    monkeypatch.setattr(port_engines, "build_model", _PortF32)
    texts: list[str] = []
    _record_texts(monkeypatch, port_stages, texts)
    task = EvalTask(
        task_id="mamba",
        model=EngineModelConfig(provider="torch_local", model_name=ARCH,
                                reduced=True, seed=0, max_tokens=MAX_TOKENS),
        metrics=(MetricConfig("exact_match"), MetricConfig("token_f1")),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
    ).with_streaming(max_memory_rows=CHUNK)
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cpu", engine_kwargs=kw) as s:
        result = s.run_task(iter_qa_examples(N_ROWS, seed=0), task)
    return result, texts


def test_f32_run_task_equals_jax(monkeypatch, ref, cfg):
    """The QA prompts render to 10-13 tokens, which the JAX prefill takes
    (one chunk of 16): the texts are equal, the metrics' values and counts
    equal, and the percentile bounds agree to 1e-5 (f32 partials summed in
    another order)."""
    jres, jtexts = _run_jax_task(monkeypatch)
    pres, ptexts = _run_port_task(monkeypatch, _params(ref, cfg, torch.float32))
    assert len(ptexts) == N_ROWS and ptexts == jtexts
    for name in ("exact_match", "token_f1"):
        j, p = jres.metrics[name], pres.metrics[name]
        assert (p.value, p.n, p.n_unscored) == (j.value, j.n, j.n_unscored)
        np.testing.assert_allclose(p.ci, j.ci, atol=1e-5, rtol=0)


def _top_two_gap(model, params, prompt, tokens, step):
    """The JAX bf16 model's top-two logit gap where it chose
    ``tokens[step]`` (teacher-forced along its own tokens, batch of one)."""
    cache = jax_pm.init_params(jax.random.key(1), model.cache_specs(1, MAX_LEN))
    logits, cache = model.prefill(params, {"tokens": jnp.asarray([prompt], jnp.int32)},
                                  cache)
    for i in range(step):
        logits, cache = model.decode_step(
            params, jnp.asarray([[tokens[i]]], jnp.int32), cache,
            jnp.asarray([len(prompt) + i], jnp.int32),
        )
    row = np.sort(np.asarray(logits, np.float32)[0, :512])
    return float(row[-1] - row[-2])


def test_bf16_differences_sit_on_thin_logit_gaps(ref, cfg):
    """In bf16 the two frameworks round at different places, so a greedy
    token may flip where the top two logits nearly tie: every QA row whose
    tokens differ first differs where the JAX top-two gap is under the bf16
    logit tolerance, and at least half the rows are equal."""
    jcfg, model, params, _ = ref
    tok = JaxTokenizer(512)
    work = []
    for r in jax_rows(N_ROWS, seed=0):
        toks = tok.encode(r["question"])[: MAX_LEN // 2]
        work.append((toks, min(MAX_TOKENS, MAX_LEN - len(toks) - 1)))
    jsched = JaxBatcher(model, jcfg, params, n_slots=N_SLOTS, max_len=MAX_LEN, eos_id=1)
    psched = ContinuousBatcher(MambaLM(cfg), cfg, _params(ref, cfg, torch.bfloat16),
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
