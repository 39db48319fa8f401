"""The port's continuous batcher and local engine against the JAX package's
``ContinuousBatcher`` in contiguous mode, and the port's own serving
invariants: batch-independent greedy tokens and stale slots at
``max_len``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core import EngineModelConfig, InferenceRequest, TorchLocalEngine
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.serve import ContinuousBatcher, Request

N_SLOTS, MAX_LEN = 4, 64


class _JaxF32:
    """Thin test-side wrapper: the JAX model with every call in f32."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def cache_specs(self, *a, **kw):
        return self.model.cache_specs(*a, **kw)

    def prefill(self, params, batch, cache):
        return self.model.prefill(params, batch, cache, dtype=jnp.float32)

    def decode_step(self, params, tokens, cache, positions):
        return self.model.decode_step(params, tokens, cache, positions,
                                      dtype=jnp.float32)


class _PortF32(TransformerLM):
    """The same wrapper on the port's side."""

    def prefill(self, *a, **kw):
        return super().prefill(*a, dtype=torch.float32, **kw)

    def decode_step(self, *a, **kw):
        return super().decode_step(*a, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    cfg = jax_get_config("qwen3-4b").reduced()
    model = JaxLM(cfg, remat="none")
    params = jax_pm.init_params(jax.random.key(1), model.param_specs())
    return cfg, model, params, jax.tree.map(np.asarray, params)


def _workload(vocab_size, seed, n=10):
    """tests/test_quantized_serving.py:47's workload: shared-prefix plus
    unique-tail prompts, 15-23 prompt tokens, 12 new tokens."""
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(2, vocab_size, 20))
    out = []
    for i in range(n):
        toks = shared[: 12 + (i % 5)] + list(rng.integers(2, vocab_size, 3 + i % 7))
        out.append((i, [int(t) for t in toks], 12))
    return out


def _run_jax(ref, work):
    cfg, model, params, _ = ref
    sched = JaxBatcher(_JaxF32(model), cfg, params, n_slots=N_SLOTS,
                       max_len=MAX_LEN, eos_id=1)
    for rid, toks, n_new in work:
        sched.submit(JaxRequest(rid, prompt_tokens=toks, max_new_tokens=n_new))
    return {c.request_id: (c.tokens, c.finished_reason)
            for c in sched.run_to_completion()}


def _run_port(params, work, model_cls=_PortF32, n_slots=N_SLOTS):
    cfg = get_config("qwen3-4b").reduced()
    sched = ContinuousBatcher(model_cls(cfg), cfg, params, n_slots=n_slots,
                              max_len=MAX_LEN, eos_id=1)
    for rid, toks, n_new in work:
        sched.submit(Request(rid, prompt_tokens=toks, max_new_tokens=n_new))
    return sched, {c.request_id: (c.tokens, c.finished_reason)
                   for c in sched.run_to_completion()}


def _port_params(ref, dtype):
    return params_from_jax(ref[3], get_config("qwen3-4b").reduced(),
                           device="cpu", dtype=dtype)


@pytest.mark.parametrize("seed", [11, 4])
def test_f32_token_streams_equal_jax_batcher(ref, seed):
    work = _workload(512, seed)
    want = _run_jax(ref, work)
    _, got = _run_port(_port_params(ref, torch.float32), work)
    assert got == want


def test_stale_and_active_slots_at_max_len_match_jax(ref):
    """Request 0 ends exactly at position max_len and then sits free with a
    stale position of max_len while request 1 keeps decoding; request 2
    decodes one step *at* max_len, where no cache row is written."""
    rng = np.random.default_rng(5)
    p = [[int(t) for t in rng.integers(4, 512, n)] for n in (20, 10, 30)]
    work = [(0, p[0], MAX_LEN - 20 + 1), (1, p[1], 50), (2, p[2], MAX_LEN - 30 + 2)]
    want = _run_jax(ref, work)
    sched, got = _run_port(_port_params(ref, torch.float32), work)
    assert got == want
    assert MAX_LEN in sched.slot_pos.tolist()


def test_tokens_do_not_depend_on_the_batch(ref):
    """Within the port (bf16, the serving default): each request's tokens
    are byte-equal alone in the batcher and among full slots."""
    params = _port_params(ref, torch.bfloat16)
    work = _workload(512, 11)
    _, together = _run_port(params, work, model_cls=TransformerLM)
    for item in work[:4]:
        _, alone = _run_port(params, [item], model_cls=TransformerLM)
        assert alone[item[0]] == together[item[0]]


def test_max_prefills_per_step_defers_admissions(ref):
    cfg = get_config("qwen3-4b").reduced()
    params = _port_params(ref, torch.bfloat16)
    sched = ContinuousBatcher(TransformerLM(cfg), cfg, params, n_slots=4,
                              max_len=MAX_LEN, max_prefills_per_step=1)
    for rid, toks, n_new in _workload(512, 3, n=6):
        sched.submit(Request(rid, prompt_tokens=toks, max_new_tokens=n_new))
    sched.step()
    assert sched.slots_busy == 1 and sched.stats.prefills_deferred == 3
    done = sched.run_to_completion()
    assert sorted(c.request_id for c in done) == list(range(6))


def test_truncated_completion_at_max_steps(ref):
    cfg = get_config("qwen3-4b").reduced()
    params = _port_params(ref, torch.bfloat16)
    sched = ContinuousBatcher(TransformerLM(cfg), cfg, params, n_slots=2,
                              max_len=MAX_LEN)
    sched.submit(Request(0, prompt_tokens=[2, 9, 10], max_new_tokens=20))
    (c,) = sched.run_to_completion(max_steps=3)
    assert c.finished_reason == "truncated" and len(c.tokens) == 4
    assert sched.slots_busy == 0


# -- the engine --------------------------------------------------------------------


def _engine(**kw):
    model = EngineModelConfig(provider="torch_local", reduced=True, seed=0,
                              max_tokens=8)
    return TorchLocalEngine(model, n_slots=3, max_len=32, device="cpu", **kw)


def test_engine_streaming_equals_infer_batch():
    prompts = [f"What is known about topic {i}?" for i in range(5)]
    reqs = [InferenceRequest(p, max_tokens=6) for p in prompts]
    batch = _engine().infer_batch(reqs)
    eng = _engine()
    rids = {eng.stream_submit(r): i for i, r in enumerate(reqs)}
    got = {}
    while eng.stream_pending():
        for rid, resp in eng.stream_pump():
            got[rids[rid]] = resp
    assert [got[i].text for i in range(5)] == [r.text for r in batch]
    assert all(r.output_tokens == 6 and r.error is None for r in batch)
    assert eng.serving_stats()["completions"] == 5


def test_engine_truncates_prompt_and_clamps_new_tokens():
    eng = _engine()
    long_prompt = " ".join(f"w{i}" for i in range(40))
    (resp,) = eng.infer_batch([InferenceRequest(long_prompt, max_tokens=100)])
    assert resp.input_tokens == 32 // 2
    assert resp.output_tokens == 32 - 16 - 1


def test_engine_refuses_sampling_and_foreign_providers():
    """Temperature sampling is ported (``tests/test_torch_temperature.py``):
    an engine at ``temperature`` > 0 builds and its batcher samples, and a
    request's own temperature is not read, as in the reference's engine.
    A provider other than the port's is still refused."""
    hot = TorchLocalEngine(EngineModelConfig(temperature=0.7), device="cpu")
    hot.initialize()
    assert hot.batcher.temperature == 0.7
    with pytest.raises(ValueError):
        TorchLocalEngine(EngineModelConfig(provider="local"), device="cpu")
    eng = _engine()
    (resp,) = eng.infer_batch([InferenceRequest("hi", temperature=1.0)])
    (greedy,) = eng.infer_batch([InferenceRequest("hi")])
    assert resp.error is None and resp.text == greedy.text


def test_engine_cancel_drops_a_queued_request():
    eng = _engine()
    rid = eng.stream_submit(InferenceRequest("a b c", max_tokens=4))
    assert eng.stream_cancel(rid)
    assert not eng.stream_pending()
