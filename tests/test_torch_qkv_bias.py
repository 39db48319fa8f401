"""The qkv-bias dense configs (qwen2.5-32b, qwen1.5-110b) in the port's
``TransformerLM`` against the JAX package's, on the CPU: reduced configs
and a G = 5 variant (10 query heads over 2 KV heads, qwen2.5-32b's 40 / 8
at reduced width), with the JAX model's weights carried across by the
bridge and the zero biases it initialises replaced by seeded nonzero ones
on both sides (a zero bias would hide a dropped add).  Inputs are made
with numpy from a seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro_torch.configs import get_config
from repro_torch.models import TransformerLM, init_params, params_from_jax
from repro_torch.models import params as port_params
from repro_torch.models.params import param_specs
from repro_torch.serve.steps import greedy_sample

MAX_LEN = 64
#: f32 on both sides, sums in other orders: the dense model test's tolerance
F32_LOGIT_TOL = 1e-4
#: bf16: 2^-5 of the row's largest |logit| (4 bf16 ulps of it), as the
#: untied-unembedding MoE test allows; bf16 rounds at other places in the
#: two frameworks
BF16_LOGIT_REL = 2.0**-5

VARIANTS = {
    "qwen2.5-32b": ("qwen2.5-32b", {}),
    "qwen1.5-110b": ("qwen1.5-110b", {}),
    # qwen2.5-32b's G = 5 (40 / 8) at reduced width
    "g5": ("qwen2.5-32b", {"n_heads": 10, "n_kv_heads": 2}),
}


@pytest.fixture(scope="module")
def models():
    """Per variant: (JAX cfg, JAX model, JAX params, numpy tree, port cfg),
    the biases drawn from a seed on both sides."""
    out = {}
    for i, (variant, (arch, kw)) in enumerate(VARIANTS.items()):
        cfg = jax_get_config(arch).reduced().replace(**kw)
        model = JaxLM(cfg, remat="none")
        tree = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(i),
                                                           model.param_specs()))
        rng = np.random.default_rng(10 + i)
        attn = tree["dense_layers"]["attn"]
        for w in ("wq", "wk", "wv"):
            assert not attn[w]["bias"].any()  # the reference inits zeros
            attn[w]["bias"] = (0.5 * rng.standard_normal(attn[w]["bias"].shape)
                               ).astype(np.float32)
        params = jax.tree.map(jnp.asarray, tree)
        out[variant] = (cfg, model, params, tree,
                        get_config(arch).reduced().replace(**kw))
    return out


def _jax_greedy(logits, vocab_size):
    row = np.asarray(logits)[0]
    return int(np.argmax(np.where(np.arange(row.size) < vocab_size, row, -np.inf)))


def _rollout(entry, prompt, n_steps, dtype_j, dtype_t):
    """Prefill one prompt, then greedy-decode ``n_steps`` tokens in both
    frameworks, each feeding back its own tokens."""
    cfg, jmodel, jparams, tree, pcfg = entry
    lm = TransformerLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=dtype_t)
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    jcache = jax_pm.init_params(jax.random.key(1),
                                jmodel.cache_specs(1, MAX_LEN, jnp.float32))
    toks = np.asarray(prompt, np.int64)[None]
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                                jcache, dtype=dtype_j)
    tl = lm.prefill(params, torch.from_numpy(toks), cache, 0, dtype=dtype_t)
    out = [(np.asarray(jl), tl.float().numpy())]
    jtok = _jax_greedy(jl, cfg.vocab_size)
    ttok = int(greedy_sample(tl, cfg.vocab_size)[0])
    toks_j, toks_t = [jtok], [ttok]
    for pos in range(len(prompt), len(prompt) + n_steps):
        jl, jcache = jmodel.decode_step(
            jparams, jnp.asarray([[jtok]], jnp.int32), jcache,
            jnp.asarray([pos], jnp.int32), dtype=dtype_j)
        tl = lm.decode_step(params, torch.tensor([[ttok]]), cache,
                            torch.tensor([pos]), dtype=dtype_t)
        out.append((np.asarray(jl), tl.float().numpy()))
        jtok = _jax_greedy(jl, cfg.vocab_size)
        ttok = int(greedy_sample(tl, cfg.vocab_size)[0])
        toks_j.append(jtok)
        toks_t.append(ttok)
    return out, toks_j, toks_t, jcache, cache


def _prompt(seed, n, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(4, vocab, n)]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed,n", [(0, 12), (1, 23)])
def test_f32_prefill_and_decode_match_jax(models, variant, seed, n):
    pcfg = models[variant][4]
    out, toks_j, toks_t, jcache, cache = _rollout(
        models[variant], _prompt(seed, n, pcfg.vocab_size), 8, jnp.float32,
        torch.float32)
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL)
    assert toks_t == toks_j
    # the biased K and V rows the port wrote in place equal the JAX cache
    for name, got in (("k", cache.k), ("v", cache.v)):
        want = np.asarray(jcache["dense_layers"][name])[:, 0]
        np.testing.assert_allclose(got[:, 0].numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_logits_within_tolerance_of_jax(models, variant):
    pcfg = models[variant][4]
    out, *_ = _rollout(models[variant], _prompt(3, 16, pcfg.vocab_size), 6,
                       jnp.bfloat16, torch.bfloat16)
    for jl, tl in out:
        scale = float(np.abs(jl).max())
        assert float(np.abs(tl - jl).max()) <= BF16_LOGIT_REL * scale


def test_dropping_the_bias_moves_the_logits(models):
    """The control: without the biases the port's logits leave the
    reference's by far more than the f32 tolerance, so the test above
    would see a dropped add."""
    cfg, jmodel, jparams, tree, pcfg = models["qwen2.5-32b"]
    prompt = np.asarray(_prompt(5, 12, pcfg.vocab_size), np.int64)[None]
    jcache = jax_pm.init_params(jax.random.key(1),
                                jmodel.cache_specs(1, MAX_LEN, jnp.float32))
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                           jcache, dtype=jnp.float32)
    lm = TransformerLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    for b in ("bq", "bk", "bv"):
        params["layers"]["attn"][b].zero_()
    tl = lm.prefill(params, torch.from_numpy(prompt), lm.init_cache(1, MAX_LEN, "cpu"),
                    0, dtype=torch.float32)
    assert float(np.abs(tl.numpy() - np.asarray(jl)).max()) > 100 * F32_LOGIT_TOL


def test_bridge_carries_biases_and_drops_the_qk_norms(models):
    *_, tree, pcfg = models["g5"]
    p = params_from_jax(tree, pcfg, device="cpu")
    attn = p["layers"]["attn"]
    assert "q_norm" not in attn and "k_norm" not in attn
    assert "unembed" in p  # untied, as the reference's qwen2.5
    hq, hk = pcfg.n_heads * pcfg.head_dim, pcfg.n_kv_heads * pcfg.head_dim
    for name, src, width in (("bq", "wq", hq), ("bk", "wk", hk), ("bv", "wv", hk)):
        assert attn[name].shape == (pcfg.n_layers, width)
        assert attn[name].dtype == torch.float32
        np.testing.assert_array_equal(attn[name].numpy(),
                                      tree["dense_layers"]["attn"][src]["bias"])


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "qwen1.5-110b"])
def test_published_configs_copied(arch):
    """The port's configs carry the reference's published numbers."""
    want, got = jax_get_config(arch), get_config(arch)
    for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "qkv_bias", "qk_norm",
                  "tie_embeddings", "rope_theta", "norm_eps", "padded_vocab"):
        assert getattr(got, field) == getattr(want, field), field


def test_init_draws_zero_biases_and_large_leaves_a_layer_at_a_time(monkeypatch):
    """Biases start at zeros, as the reference's; a leaf past
    ``WHOLE_DRAW`` elements is drawn a slice of its leading axis at a time
    from the same generator (qwen2.5-32b's MLP leaves are 36 GB in f32),
    the smaller ones whole, in the tree's order."""
    cfg = get_config("qwen2.5-32b").reduced()
    monkeypatch.setattr(port_params, "WHOLE_DRAW", cfg.d_model * cfg.d_ff)
    got = init_params(cfg, 5, device="cpu")
    assert not any(got["layers"]["attn"][b].any() for b in ("bq", "bk", "bv"))
    gen = torch.Generator().manual_seed(5)

    def check(spec, leaf, path):
        if isinstance(spec, dict):
            for k in spec:
                check(spec[k], leaf[k], path + (k,))
            return
        shape, kind = spec
        if kind in ("ones", "zeros"):
            return
        std = 1.0 / math.sqrt(max(shape[-2], 1))
        out = torch.bfloat16 if kind == "matrix" else torch.float32
        if math.prod(shape) <= port_params.WHOLE_DRAW:
            w = (torch.randn(shape, generator=gen) * std).to(out)
        else:
            w = torch.stack([(torch.randn(shape[1:], generator=gen) * std).to(out)
                             for _ in range(shape[0])])
        assert torch.equal(leaf, w), path

    specs = param_specs(cfg)
    assert math.prod(specs["layers"]["mlp"]["wi"][0]) > port_params.WHOLE_DRAW
    check(specs, got, ())
