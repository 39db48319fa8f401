"""The VLM slice end to end on reduced paligemma-3b: the JAX package's
``ContinuousBatcher`` against the port's, both models in f32 with the JAX
seed-0 weights bridged, over 6 requests of different prompt lengths, each
with its own patch embeddings in ``Request.extras``, through 2 slots, so
that slots are reused and a slot's prefix rows are overwritten by the next
request's; greedy tokens equal for every request.  And the refusals the two
packages make: a paged VLM batcher, word for word, a suffix prefill, and
the local engines, which have no channel for patches (the reference fails
on the missing ``"patches"`` at its first prefill, the port refuses at
``initialize``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import EngineModelConfig as JaxModelConfig
from repro.core import InferenceRequest as JaxRequest
from repro.core.engines import LocalJaxEngine
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve.scheduler import Request as JaxReq
from repro_torch.configs import get_config
from repro_torch.core import EngineModelConfig, InferenceRequest, TorchLocalEngine
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.serve import ContinuousBatcher, Request

ARCH = "paligemma-3b"
N_SLOTS, MAX_LEN = 2, 48
#: prompt lengths and new-token budgets of the 6 requests (the longest
#: fills max_len: 8 patch rows, 24 prompt tokens and 16 new)
PROMPTS = ((5, 9), (12, 6), (1, 11), (8, 8), (24, 16), (3, 10))


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


def _jax_tree():
    model = JaxLM(jax_get_config(ARCH).reduced(), remat="none", attn_impl="naive")
    return model, jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(0),
                                                              model.param_specs()))


def _requests(cfg, req_cls):
    rng = np.random.default_rng(30)
    out = []
    for i, (n, new) in enumerate(PROMPTS):
        toks = [int(t) for t in rng.integers(3, cfg.vocab_size, n)]
        patches = (0.02 * rng.standard_normal((cfg.n_vision_tokens, cfg.d_model))).astype(
            np.float32)
        out.append(req_cls(request_id=i, prompt_tokens=toks, max_new_tokens=new,
                           extras={"patches": patches}))
    return out


def _tokens(completions):
    return {c.request_id: (c.tokens, c.finished_reason, c.prompt_len)
            for c in completions}


def _port_batcher(cfg, params):
    return ContinuousBatcher(_PortF32(cfg), cfg, params, n_slots=N_SLOTS,
                             max_len=MAX_LEN, eos_id=-1)


def test_f32_batcher_equals_jax_with_patches_and_reused_slots():
    jmodel, tree = _jax_tree()
    cfg = get_config(ARCH).reduced()
    params = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    jb = JaxBatcher(_JaxF32(jmodel), jmodel.cfg, jax.tree.map(jnp.asarray, tree),
                    n_slots=N_SLOTS, max_len=MAX_LEN, eos_id=-1)
    pb = _port_batcher(cfg, params)
    assert pb.prefix == jb.prefix == cfg.n_vision_tokens
    for jr, pr in zip(_requests(jmodel.cfg, JaxReq), _requests(cfg, Request)):
        jb.submit(jr)
        pb.submit(pr)
    want = _tokens(jb.run_to_completion())
    got = _tokens(pb.run_to_completion())
    assert len(got) == len(PROMPTS) and got == want
    assert all(reason == "length" for _, reason, _ in got.values())
    assert [len(t) for t, _, _ in (got[i] for i in range(len(PROMPTS)))] == [
        new for _, new in PROMPTS]
    # 6 requests through 2 slots: each slot held three in turn
    assert pb.stats.admissions == pb.stats.completions == len(PROMPTS)
    # a request's patches matter: other patches give other tokens somewhere
    swapped = _requests(cfg, Request)
    for r in swapped:
        r.extras = {"patches": np.roll(r.extras["patches"], 1, axis=0)}
    pb2 = _port_batcher(cfg, params)
    for r in swapped:
        pb2.submit(r)
    assert _tokens(pb2.run_to_completion()) != got


def test_request_alone_equals_among_others_and_positions_follow_the_prefix():
    """A request's tokens do not depend on the slot or the company it is
    served in; its patches may come as an array or a tensor, f64 narrowed
    to f32; its first decode position is the prefix plus the prompt."""
    _, tree = _jax_tree()
    cfg = get_config(ARCH).reduced()
    params = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    reqs = _requests(cfg, Request)
    pb = _port_batcher(cfg, params)
    for r in reqs:
        pb.submit(r)
    together = _tokens(pb.run_to_completion())
    last = reqs[-1]
    alone = _port_batcher(cfg, params)
    alone.submit(Request(99, last.prompt_tokens, last.max_new_tokens,
                         {"patches": torch.from_numpy(last.extras["patches"])}))
    alone.submit(Request(98, last.prompt_tokens, last.max_new_tokens,
                         {"patches": last.extras["patches"].astype(np.float64)}))
    alone.step()
    assert list(alone.slot_pos) == [cfg.n_vision_tokens + len(last.prompt_tokens) + 1] * 2
    out = _tokens(alone.run_to_completion())
    assert out[99][0] == out[98][0] == together[last.request_id][0]


def test_paged_vlm_batcher_and_suffix_prefill_raise_the_reference_errors():
    jmodel, tree = _jax_tree()
    with pytest.raises(ValueError) as jerr:
        JaxBatcher(jmodel, jmodel.cfg, jax.tree.map(jnp.asarray, tree), n_slots=2,
                   max_len=32, page_size=16)
    cfg = get_config(ARCH).reduced()
    params = params_from_jax(tree, cfg, device="cpu")
    with pytest.raises(ValueError) as perr:
        ContinuousBatcher(TransformerLM(cfg), cfg, params, n_slots=2, max_len=32,
                          page_size=16)
    assert str(perr.value) == str(jerr.value)
    assert str(perr.value) == ("paged KV cache supports GQA attention families "
                               "('dense', 'moe'), not vlm")
    patches = torch.zeros((1, cfg.n_vision_tokens, cfg.d_model))
    lm = TransformerLM(cfg)
    with pytest.raises(ValueError, match="^suffix prefill is not supported for VLM prompts$"):
        lm.prefill(params, torch.tensor([[5, 6]]), lm.init_cache(1, 32, "cpu"), 0,
                   start=16, patches=patches)


def test_local_engines_refuse_paligemma():
    """The reference's local engine builds, then fails at its first
    prefill on the patches its requests cannot carry; the port's refuses
    at ``initialize``, before any weights are made, with a ValueError that
    says why and what to use."""
    jengine = LocalJaxEngine(JaxModelConfig(provider="local", model_name=ARCH,
                                            reduced=True, max_tokens=4),
                             n_slots=2, max_len=32)
    with pytest.raises(KeyError, match="patches"):
        jengine.infer_batch([JaxRequest("a question", 4)])
    engine = TorchLocalEngine(EngineModelConfig(provider="torch_local", model_name=ARCH,
                                                reduced=True, max_tokens=4),
                              n_slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="cannot carry the patch embeddings"):
        engine.initialize()
    assert engine.batcher is None
    with pytest.raises(ValueError, match=r"Request\(extras=\{'patches'"):
        engine.infer_batch([InferenceRequest("a question", 4)])
