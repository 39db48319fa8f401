"""The port's zamba2 ``HybridLM`` (``repro_torch.models``) against the JAX
package's, on the CPU: the reduced config (4 Mamba2 layers in 2 groups of
2, no tail) and ``reduced().replace(n_layers=5)`` (a tail of one), with
the JAX model's own weights carried across by the bridge.  The JAX model
runs its exact attention (``attn_impl="naive"``): its chunked path
scrambles query rows from 512 tokens on.  Also the plain versions of the
widened kernels at zamba2's full widths (prefill and decode attention at
head_dim 112, the SSD scan at state 64) against the JAX package's
references.  Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.kernels.ssd import ssd_ref as jax_ssd_ref
from repro.models import params as jax_pm
from repro.models.model import HybridLM as JaxHybrid
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.ssd import ssd_apply, ssd_ref
from repro_torch.models import (
    HybridCache,
    HybridLM,
    build_model,
    init_params,
    params_from_jax,
)
from repro_torch.models.params import param_specs
from repro_torch.serve.steps import greedy_sample

ARCH = "zamba2-7b"
MAX_LEN = 64
#: f32 on both sides, sums in other orders: the dense model test's tolerance
F32_LOGIT_TOL = 1e-4
#: the caches the prefill and decode wrote: f32 sums in other orders, taken
#: through the Mamba2 layers before them, so the logits' tolerance
F32_STATE_TOL = 1e-4
#: bf16: 2^-4 of the row's largest |logit| (8 bf16 ulps of it).  bf16 rounds
#: at other places in the two frameworks, four a Mamba2 layer and two more
#: a shared-block application (``out - normed``, then ``h +``) than a dense
#: block; one prompt here exceeds the dense tests' 2^-5 by 6%
BF16_LOGIT_REL = 2.0**-4
#: the variants: reduced (2 groups of 2), and 5 layers (2 groups and a tail)
VARIANTS = {"reduced": {}, "tail": {"n_layers": 5}}


@pytest.fixture(scope="module")
def models():
    """Per variant: (JAX cfg, JAX model, JAX params, numpy tree, port cfg)."""
    out = {}
    for variant, kw in VARIANTS.items():
        cfg = jax_get_config(ARCH).reduced().replace(**kw)
        model = JaxHybrid(cfg, remat="none", attn_impl="naive")
        params = jax_pm.init_params(jax.random.key(0), model.param_specs())
        out[variant] = (cfg, model, params, jax.tree.map(np.asarray, params),
                        get_config(ARCH).reduced().replace(**kw))
    return out


def _jax_greedy(logits, vocab_size):
    row = np.asarray(logits)[0]
    return int(np.argmax(np.where(np.arange(row.size) < vocab_size, row, -np.inf)))


def _jax_cache(model, max_len=MAX_LEN):
    return jax_pm.init_params(jax.random.key(1),
                              model.cache_specs(1, max_len, jnp.float32))


def _prompt(seed, n, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(4, vocab, n)]


def _rollout(entry, prompt, n_steps, dtype_j, dtype_t):
    """Prefill one prompt (at most one SSD chunk, or a multiple of it: the
    JAX prefill's limit), then greedy-decode ``n_steps`` tokens in both
    frameworks, each feeding back its own tokens."""
    cfg, jmodel, jparams, tree, pcfg = entry
    lm = HybridLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=dtype_t)
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    jcache = _jax_cache(jmodel)
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


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed,n", [(0, 12), (2, 32), (3, 1)])
def test_f32_prefill_and_decode_match_jax(models, variant, seed, n):
    pcfg = models[variant][4]
    out, toks_j, toks_t, jcache, cache = _rollout(
        models[variant], _prompt(seed, n, pcfg.vocab_size), 8, jnp.float32,
        torch.float32)
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL)
    assert toks_t == toks_j
    # every piece of state the port wrote in place equals the JAX cache's:
    # a KV cache per shared-block application, the conv window and SSD
    # state of every Mamba2 layer (groups, then the tail)
    g, k = pcfg.n_layers // pcfg.shared_attn_every, pcfg.shared_attn_every
    for name, got in (("k", cache.kv.k), ("v", cache.kv.v)):
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   np.asarray(jcache["attn"][name])[:, 0],
                                   atol=F32_STATE_TOL, rtol=F32_STATE_TOL)
    for name in ("conv", "state"):
        want = np.asarray(jcache["groups"][name])[:, :, 0].reshape(
            g * k, *getattr(cache.ssm, name).shape[2:])
        if "tail" in jcache:
            want = np.concatenate([want, np.asarray(jcache["tail"][name])[:, 0]])
        np.testing.assert_allclose(getattr(cache.ssm, name)[:, 0].numpy(), want,
                                   atol=F32_STATE_TOL, rtol=F32_STATE_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_logits_match_jax_forward_at_every_length(models, variant):
    """The reference's full-sequence ``forward`` over 16 tokens against the
    port's prefill of each prefix: position i's logits are prefill(i + 1)'s
    (f32)."""
    cfg, jmodel, jparams, tree, pcfg = models[variant]
    prompt = np.asarray(_prompt(7, 16, pcfg.vocab_size), np.int64)[None]
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                             dtype=jnp.float32)
    lm = HybridLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    for i in range(1, 17):
        got = lm.prefill(params, torch.from_numpy(prompt[:, :i]), cache, 0,
                         dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, i - 1],
                                   atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_logits_within_tolerance_of_jax(models, variant):
    pcfg = models[variant][4]
    out, *_ = _rollout(models[variant], _prompt(4, 16, pcfg.vocab_size), 6,
                       jnp.bfloat16, torch.bfloat16)
    for jl, tl in out:
        scale = float(np.abs(jl).max())
        assert float(np.abs(tl - jl).max()) <= BF16_LOGIT_REL * scale


def test_prefill_overwrites_a_reused_slot(models):
    """A slot that held a longer prompt and decoded past it gives, after a
    new prefill, what a fresh cache gives: nothing of the old request
    survives in the KV rows it reads or in the SSM state."""
    *_, tree, pcfg = models["tail"]
    lm = HybridLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    used, fresh = lm.init_cache(2, MAX_LEN, "cpu"), lm.init_cache(2, MAX_LEN, "cpu")
    old = torch.tensor([_prompt(8, 30, pcfg.vocab_size)])
    lm.prefill(params, old, used, 1, dtype=torch.float32)
    lm.decode_step(params, torch.tensor([[5], [6]]), used, torch.tensor([3, 30]),
                   dtype=torch.float32)
    new = torch.tensor([_prompt(9, 5, pcfg.vocab_size)])
    a = lm.prefill(params, new, used, 1, dtype=torch.float32)
    b = lm.prefill(params, new, fresh, 1, dtype=torch.float32)
    assert torch.equal(a, b)
    step = torch.tensor([[7], [7]])
    pos = torch.tensor([5, 5])
    a = lm.decode_step(params, step, used, pos, dtype=torch.float32)[1]
    b = lm.decode_step(params, step, fresh, pos, dtype=torch.float32)[1]
    assert torch.equal(a, b)


def test_nested_parameter_bridge(models):
    """The nested ``(G, K, ...)`` group stacks, the unstacked shared block,
    the per-application norms and the tail come across leaf for leaf, in
    f32 where the reference keeps f32 and in the compute dtype for the
    matmul weights; the hybrid has no ``unembed``."""
    cfg, _, _, tree, pcfg = models["tail"]
    p = params_from_jax(tree, pcfg, device="cpu")
    g, k = pcfg.n_layers // pcfg.shared_attn_every, pcfg.shared_attn_every
    assert "unembed" not in p and "layers" not in p
    assert p["groups"]["mixer"]["wxBC"].shape == (
        g, k, pcfg.d_model, pcfg.d_inner + 2 * pcfg.ssm_ngroups * pcfg.ssm_state)
    assert p["groups"]["mixer"]["wz"].dtype == torch.bfloat16
    assert p["groups"]["mixer"]["A_log"].dtype == torch.float32
    assert p["tail"]["ln"].shape == (1, pcfg.d_model)
    assert p["app_norms"].shape == (g, pcfg.d_model)
    np.testing.assert_array_equal(p["app_norms"].numpy(), tree["app_norms"]["scale"])
    np.testing.assert_array_equal(p["groups"]["mixer"]["conv_w"].numpy(),
                                  tree["groups"]["mixer"]["conv_w"])
    np.testing.assert_array_equal(p["tail"]["mixer"]["dt_bias"].numpy(),
                                  tree["tail"]["mixer"]["dt_bias"])
    want = np.asarray(jnp.asarray(tree["shared_attn"]["attn"]["wq"]["kernel"])
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(p["shared_attn"]["attn"]["wq"].float().numpy(), want)
    assert "bq" not in p["shared_attn"]["attn"]  # zamba2 has no qkv bias


def test_init_params_and_model_selection():
    cfg = get_config(ARCH).reduced()
    a, b = init_params(cfg, 3, device="cpu"), init_params(cfg, 3, device="cpu")
    assert torch.equal(a["groups"]["mixer"]["wz"], b["groups"]["mixer"]["wz"])
    assert not torch.equal(a["groups"]["mixer"]["wz"][0, 0],
                           a["groups"]["mixer"]["wz"][0, 1])
    assert a["shared_attn"]["attn"]["wq"].shape == (cfg.d_model,
                                                    cfg.n_heads * cfg.head_dim)
    assert isinstance(build_model(cfg), HybridLM)
    cache = build_model(cfg).init_cache(3, 32, "cpu")
    assert isinstance(cache, HybridCache)
    assert cache.kv.k.shape == (2, 3, 32, cfg.n_kv_heads, cfg.head_dim)
    assert cache.ssm.state.shape == (4, 3, cfg.ssm_nheads, cfg.ssm_head_dim,
                                     cfg.ssm_state)
    with pytest.raises(ValueError, match="not paged"):
        build_model(cfg).decode_step(a, torch.zeros((3, 1), dtype=torch.long), cache,
                                     torch.zeros(3, dtype=torch.long), pages=object())


def test_published_config_copied():
    want, got = jax_get_config(ARCH), get_config(ARCH)
    for field in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "ssm_state", "ssm_head_dim",
                  "ssm_expand", "ssm_ngroups", "ssm_chunk", "shared_attn_every",
                  "rope_theta", "tie_embeddings", "d_inner", "ssm_nheads"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.reduced() == get_config(ARCH).reduced()
    r = got.reduced()
    assert (r.n_layers, r.shared_attn_every, r.ssm_state, r.ssm_head_dim,
            r.ssm_chunk) == (4, 2, 16, 16, 16)
    assert param_specs(got)["groups"]["ln"][0] == (13, 6, got.d_model)
    assert param_specs(got)["tail"]["ln"][0] == (3, got.d_model)


# -- the plain versions at zamba2's widths ---------------------------------------


def _pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("sq,sk,off", [(12, 12, 0), (70, 70, 0), (5, 40, 35)])
def test_flash_plain_version_at_head_dim_112(sq, sk, off):
    """zamba2's shared attention: 32 heads of 112, G = 1 (f32, 1e-5)."""
    rng = np.random.default_rng(sq + sk)
    qj, qt = _pair(rng, (1, 32, sq, 112))
    kj, kt = _pair(rng, (1, 32, sk, 112))
    vj, vt = _pair(rng, (1, 32, sk, 112))
    ours = flash_attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                               vt.transpose(1, 2), q_offset=off).transpose(1, 2)
    want = jax_flash_ref(qj, kj, vj, causal=True, q_offset=off)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_decode_plain_version_at_head_dim_112():
    """zamba2's decode attention (32 heads of 112, G = 1) over ragged
    lengths of a 64-row f32 cache (f32, 1e-5)."""
    rng = np.random.default_rng(112)
    b, kh, s, d = 4, 32, 64, 112
    lens = [1, 11, 45, 64]
    qj, qt = _pair(rng, (b, kh, 1, d))
    kj, kt = _pair(rng, (b, kh, s, d))
    vj, vt = _pair(rng, (b, kh, s, d))
    ours = decode_attention_ref(qt.reshape(b, 1, kh, d), kt.transpose(1, 2),
                                vt.transpose(1, 2),
                                torch.tensor(lens, dtype=torch.int32))
    want = jax_decode_ref(qj, kj, vj, jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(ours.reshape(b, kh, 1, d).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("slen,chunk", [(12, 256), (40, 16), (48, 16)])
def test_ssd_plain_versions_at_state_64(slen, chunk):
    """zamba2's scan: heads of 64, one group, state 64 (8 heads here, the
    width of a head and of the state at full size); the chunked version
    and the sequential oracle against the JAX oracle on B and C repeated
    out to heads (f32, atol 5e-5, the JAX kernel test's)."""
    rng = np.random.default_rng(slen)
    h, p, n = 8, 64, 64
    x = (rng.standard_normal((1, slen, h, p)) * 0.5).astype(np.float32)
    dt = (np.abs(rng.standard_normal((1, slen, h))) * 0.5 + 0.1).astype(np.float32)
    a = (-np.abs(rng.standard_normal(h)) - 0.2).astype(np.float32)
    bm = (rng.standard_normal((1, slen, 1, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((1, slen, 1, n)) * 0.5).astype(np.float32)
    wy, ws = jax_ssd_ref(*(jnp.asarray(v) for v in (
        x, dt, a, np.repeat(bm, h, axis=2), np.repeat(cm, h, axis=2))))
    args = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    for gy, gs in (ssd_apply(*args, chunk=chunk), ssd_ref(*args)):
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=5e-5)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=5e-5)
