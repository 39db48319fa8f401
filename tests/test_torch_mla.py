"""MLA (multi-head latent attention: minicpm3-4b, deepseek-v2-236b) in the
port against the JAX package, on the CPU: the block's functions
(``mla_q``, ``mla_ckv``, the decompressed prefill, the absorbed decode)
against the reference's ``_mla_q``, ``_mla_ckv``, ``mla_full`` and
``mla_decode``; the parameter bridge; the whole reduced models, prefill
then greedy decode, against the JAX ``TransformerLM``; prefill-then-decode
logits against the JAX full forward (the port's counterpart of
``tests/test_decode_consistency.py``, deepseek dropless); and the prefill
kernel's plain version at a V width other than the Q/K width against the
reference's ``naive_attention``.  Inputs are made with numpy from a seed;
the norms' scales are drawn away from the ones the reference initialises,
so a dropped scale shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import (
    MLACache,
    TransformerLM,
    build_model,
    init_params,
    layers,
    params_from_jax,
)
from repro_torch.models import attention as attn
from repro_torch.models.params import param_specs
from repro_torch.serve.steps import greedy_sample

ARCHS = ("minicpm3-4b", "deepseek-v2-236b")
#: the block's variants: both reduced configs, and minicpm3 without the
#: query bottleneck (``q_lora_rank=0``: one ``wq``)
BLOCKS = {"minicpm3-4b": ("minicpm3-4b", {}),
          "deepseek-v2-236b": ("deepseek-v2-236b", {}),
          "no-q-lora": ("minicpm3-4b", {"q_lora_rank": 0})}
#: f32 on both sides, sums in other orders: the block's outputs
F32_TOL = 2e-5
#: the whole model in f32: the dense model tests' logit tolerance
F32_LOGIT_TOL = 1e-4
#: prefill-then-decode against the full forward, as the reference's
#: tests/test_decode_consistency.py bounds it
CONSISTENCY_TOL = 5e-5
#: bf16: 2^-5 of the row's largest |logit|, as the other families' tests
BF16_LOGIT_REL = 2.0**-5
MAX_LEN = 64


def _cfgs(block):
    arch, kw = BLOCKS[block]
    return jax_get_config(arch).reduced().replace(**kw), \
        get_config(arch).reduced().replace(**kw)


def _jax_block(jcfg, seed):
    """The JAX block's parameters with random norm scales, and the port's
    view of them (kernels and scales as f32 tensors)."""
    tree = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(seed),
                                                       jattn.mla_specs(jcfg)))
    rng = np.random.default_rng(seed)
    for name in ("q_a_norm", "kv_a_norm"):
        if name in tree:
            tree[name]["scale"] = (1 + 0.5 * rng.standard_normal(
                tree[name]["scale"].shape)).astype(np.float32)
    port = {k: torch.from_numpy(np.array(v.get("kernel", v.get("scale"))))
            for k, v in tree.items()}
    return jax.tree.map(jnp.asarray, tree), port


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rope(cfg, positions):
    return layers.rope_cos_sin(torch.as_tensor(positions), cfg.qk_rope_head_dim,
                               cfg.rope_theta)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_mla_q_and_ckv_match_the_reference(block):
    jcfg, pcfg = _cfgs(block)
    jp, pp = _jax_block(jcfg, 1)
    x = _x(2, (2, 9, pcfg.d_model))
    pos = np.arange(3, 12)[None, :].repeat(2, 0)
    want_q = jattn._mla_q(jp, jcfg, jnp.asarray(x))
    got_q = attn.mla_q(pp, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=F32_TOL,
                               atol=F32_TOL)
    want = jattn._mla_ckv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attn.mla_ckv(pp, pcfg, torch.from_numpy(x), _rope(pcfg, pos))
    assert got[0].shape == (2, 9, pcfg.kv_lora_rank)
    assert got[1].shape == (2, 9, pcfg.qk_rope_head_dim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("s", [1, 13, 40])
def test_mla_prefill_matches_mla_full(block, s):
    """The decompressed prefill through the kernel's plain version against
    the reference's ``mla_full`` (its exact attention: the chunked one
    scrambles rows from 512 tokens on); the slot's compressed rows equal
    ``_mla_ckv``'s and the other slots' rows stay zero."""
    jcfg, pcfg = _cfgs(block)
    jp, pp = _jax_block(jcfg, 3)
    x = _x(4 + s, (1, s, pcfg.d_model))
    want = jattn.mla_full(jp, jcfg, jnp.asarray(x), causal=True, impl="naive")
    c_cache = torch.zeros((3, MAX_LEN, pcfg.kv_lora_rank))
    r_cache = torch.zeros((3, MAX_LEN, pcfg.qk_rope_head_dim))
    got = attn.mla_prefill(pp, pcfg, torch.from_numpy(x), c_cache, r_cache, 1,
                           _rope(pcfg, np.arange(s)[None, :]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    ckv, krope = jattn._mla_ckv(jp, jcfg, jnp.asarray(x), jnp.arange(s)[None, :])
    np.testing.assert_allclose(c_cache[1, :s].numpy(), np.asarray(ckv)[0],
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(r_cache[1, :s].numpy(), np.asarray(krope)[0],
                               rtol=F32_TOL, atol=F32_TOL)
    assert not c_cache[[0, 2]].any() and not c_cache[1, s:].any()
    assert not r_cache[[0, 2]].any()


@pytest.mark.parametrize("block", list(BLOCKS))
def test_mla_decode_matches_the_absorbed_reference(block):
    """One decode step of 4 slots at ragged positions over a random
    compressed cache, a stale slot at ``max_len`` among them (it writes
    no row and attends over all of them): the output and the updated
    cache against the reference's ``mla_decode``."""
    jcfg, pcfg = _cfgs(block)
    jp, pp = _jax_block(jcfg, 5)
    s = 24
    x = _x(6, (4, 1, pcfg.d_model))
    c = _x(7, (4, s, pcfg.kv_lora_rank))
    r = _x(8, (4, s, pcfg.qk_rope_head_dim))
    pos = np.array([0, 7, s - 1, s])
    want, wcache = jattn.mla_decode(
        jp, jcfg, jnp.asarray(x), {"c_kv": jnp.asarray(c), "k_rope": jnp.asarray(r)},
        jnp.asarray(pos, jnp.int32))
    c_cache, r_cache = torch.from_numpy(c.copy()), torch.from_numpy(r.copy())
    positions = torch.from_numpy(pos)
    lengths = (positions + 1).clamp(max=s).to(torch.int32)
    got = attn.mla_decode(pp, pcfg, torch.from_numpy(x), c_cache, r_cache, positions,
                          lengths, _rope(pcfg, pos[:, None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(c_cache.numpy(), np.asarray(wcache["c_kv"]),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(r_cache.numpy(), np.asarray(wcache["k_rope"]),
                               rtol=F32_TOL, atol=F32_TOL)
    assert np.array_equal(c_cache[3].numpy(), c[3])  # the stale slot wrote nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,q_offset", [(1, 0), (4, 0), (2, 9)])
def test_prefill_plain_version_at_a_narrower_v(dtype, g, q_offset):
    """``flash_attention_ref`` with V narrower than Q and K (MLA's reduced
    24 / 16; minicpm3's 96 / 64 at full width) against the reference's
    ``naive_attention`` at scale ``d_qk ** -0.5``, causal from
    ``q_offset``: (B, Sq, H, d_v) out."""
    b, sq, kh, dqk, dv = 2, 11, 2, 24, 16
    sk = sq + q_offset
    q = _x(9, (b, sq, kh * g, dqk))
    k = _x(10, (b, sk, kh, dqk))
    v = _x(11, (b, sk, kh, dv))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, q_offset=q_offset)
    assert got.shape == (b, sq, kh * g, dv) and got.dtype == dtype
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    mask = jattn.make_causal_mask(sq, sk, q_offset=q_offset)
    want = jattn.naive_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), mask,
                                 dqk**-0.5)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        # bf16 P V in both, summed in other orders: 2 bf16 ulps of the row
        scale = np.abs(want).max(axis=-1, keepdims=True)
        assert (np.abs(got.float().numpy() - want) <= 2**-7 * scale).all()


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX cfg, JAX model, JAX params, numpy tree, port cfg);
    deepseek dropless (every expert takes every token), as the reference's
    consistency test runs MoE archs; the norm scales random."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, pcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        if jcfg.n_experts:
            cf = float(jcfg.n_experts) / jcfg.n_experts_per_token
            jcfg, pcfg = jcfg.replace(capacity_factor=cf), pcfg.replace(
                capacity_factor=cf)
        model = JaxLM(jcfg, remat="none")
        tree = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(i),
                                                           model.param_specs()))
        rng = np.random.default_rng(20 + i)
        for stack in ("dense_layers", "moe_layers"):
            for name in ("q_a_norm", "kv_a_norm"):
                if stack in tree:
                    sc = tree[stack]["attn"][name]["scale"]
                    tree[stack]["attn"][name]["scale"] = (
                        1 + 0.5 * rng.standard_normal(sc.shape)).astype(np.float32)
        out[arch] = (jcfg, model, jax.tree.map(jnp.asarray, tree), tree, pcfg)
    return out


def _prompt(seed, n, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(4, vocab, n)]


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,n", [(0, 12), (1, 23)])
def test_f32_prefill_and_decode_match_jax(models, arch, seed, n):
    """The whole reduced model: a prompt's prefill and 8 greedy decode
    steps, logits within the f32 tolerance, the tokens equal, and the
    compressed rows the port wrote in place equal to the JAX cache's."""
    pcfg = models[arch][4]
    out, toks_j, toks_t, jcache, cache = _rollout(
        models[arch], _prompt(seed, n, pcfg.vocab_size), 8, jnp.float32,
        torch.float32)
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL)
    assert toks_t == toks_j
    assert isinstance(cache, MLACache)
    want = {name: np.concatenate([np.asarray(jcache[st][name])[:, 0]
                                  for st in ("dense_layers", "moe_layers")
                                  if st in jcache])
            for name in ("c_kv", "k_rope")}
    for name, got in (("c_kv", cache.c_kv), ("k_rope", cache.k_rope)):
        np.testing.assert_allclose(got[:, 0].numpy(), want[name], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_tolerance_of_jax(models, arch):
    pcfg = models[arch][4]
    out, *_ = _rollout(models[arch], _prompt(3, 16, pcfg.vocab_size), 6,
                       jnp.bfloat16, torch.bfloat16)
    for jl, tl in out:
        scale = float(np.abs(jl).max())
        assert float(np.abs(tl - jl).max()) <= BF16_LOGIT_REL * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(models, arch):
    """The port's counterpart of the reference's
    ``test_prefill_decode_matches_forward``: two sequences of 16 tokens,
    the first 12 prefilled into their slots, the last 4 decoded together;
    every logit row within 5e-5 of the JAX full forward's, and of the
    port's own full prefill of the prefix."""
    jcfg, jmodel, jparams, tree, pcfg = models[arch]
    b, s, split = 2, 16, 12
    toks = np.random.default_rng(30).integers(0, pcfg.vocab_size, (b, s))
    full, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                             dtype=jnp.float32)
    full = np.asarray(full)
    lm = TransformerLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    cache = lm.init_cache(b, 24, "cpu")
    errs = []
    for row in range(b):
        lg = lm.prefill(params, torch.from_numpy(toks[row : row + 1, :split]), cache,
                        row, dtype=torch.float32)
        errs.append(np.abs(lg[0].numpy() - full[row, split - 1]).max())
    for t in range(split, s):
        lg = lm.decode_step(params, torch.from_numpy(toks[:, t : t + 1]), cache,
                            torch.full((b,), t), dtype=torch.float32)
        errs.append(np.abs(lg.numpy() - full[:, t]).max())
        own = lm.prefill(params, torch.from_numpy(toks[1:2, : t + 1]),
                         lm.init_cache(1, 24, "cpu"), 0, dtype=torch.float32)
        errs.append(np.abs(lg[1].numpy() - own[0].numpy()).max())
    assert max(errs) < CONSISTENCY_TOL, f"{arch}: max err {max(errs):.2e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_mla_leaves(models, arch):
    """``params_from_jax`` takes every MLA leaf at its JAX path and shape:
    the query bottleneck, the KV latent's projection and norm, ``wkv_b``
    kept f32 (the absorbed decode reads it in f32), the output; the trees
    of the bridge and of ``init_params`` have one shape and dtype a leaf."""
    *_, tree, pcfg = models[arch]
    p = params_from_jax(tree, pcfg, device="cpu")
    drawn = init_params(pcfg, 0, device="cpu")
    stacks = [k for k in ("layers", "moe_layers") if k in p]
    assert stacks == (["layers", "moe_layers"] if pcfg.n_experts else ["layers"])
    for stack in stacks:
        jstack = "dense_layers" if stack == "layers" else stack
        a = p[stack]["attn"]
        assert sorted(a) == ["kv_a_norm", "q_a_norm", "wkv_a", "wkv_b", "wo",
                             "wq_a", "wq_b"]
        for name, leaf in a.items():
            src = tree[jstack]["attn"][name]
            want = np.array(src["scale"] if "scale" in src else src["kernel"],
                            np.float32)
            if leaf.dtype == torch.bfloat16:
                want = torch.from_numpy(want).bfloat16().float().numpy()
            np.testing.assert_array_equal(leaf.float().numpy(), want)
            assert leaf.dtype == (torch.float32 if name in (
                "wkv_b", "q_a_norm", "kv_a_norm") else torch.bfloat16), name
            assert drawn[stack]["attn"][name].shape == leaf.shape
            assert drawn[stack]["attn"][name].dtype == leaf.dtype
    h, nope, dv = pcfg.n_heads, pcfg.qk_nope_head_dim, pcfg.v_head_dim
    assert p["layers"]["attn"]["wkv_b"].shape[1:] == (pcfg.kv_lora_rank,
                                                      h * (nope + dv))


def test_bridge_without_the_query_bottleneck():
    jcfg, pcfg = _cfgs("no-q-lora")
    model = JaxLM(jcfg, remat="none")
    tree = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(4),
                                                       model.param_specs()))
    p = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    a = p["layers"]["attn"]
    assert "wq_a" not in a and "q_a_norm" not in a
    np.testing.assert_array_equal(a["wq"].numpy(),
                                  tree["dense_layers"]["attn"]["wq"]["kernel"])
    assert param_specs(pcfg)["layers"]["attn"]["wq"][0] == (
        pcfg.n_layers, pcfg.d_model,
        pcfg.n_heads * (pcfg.qk_nope_head_dim + pcfg.qk_rope_head_dim))


@pytest.mark.parametrize("arch", ARCHS)
def test_published_configs_copied(arch):
    """The port's MLA configs carry the reference's published numbers, and
    its reduced rule."""
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "tie_embeddings", "rope_theta", "norm_eps",
              "padded_vocab", "use_mla", "q_lora_rank", "kv_lora_rank",
              "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "n_experts",
              "n_experts_per_token", "n_shared_experts", "moe_d_ff",
              "first_k_dense", "dense_d_ff", "capacity_factor")
    for want, got in ((jax_get_config(arch), get_config(arch)),
                      (jax_get_config(arch).reduced(), get_config(arch).reduced())):
        for field in fields:
            assert getattr(got, field) == getattr(want, field), field
        assert got.name == want.name


def test_mla_caches_refuse_suffix_prefill_and_paging():
    """Suffix prefill raises the reference's error; an MLA model has no
    paged cache; the contiguous one holds the compressed rows."""
    cfg = get_config("minicpm3-4b").reduced()
    lm = build_model(cfg)
    assert isinstance(lm, TransformerLM)
    cache = lm.init_cache(2, 32, "cpu")
    assert cache.c_kv.shape == (cfg.n_layers, 2, 32, cfg.kv_lora_rank)
    assert cache.k_rope.shape == (cfg.n_layers, 2, 32, cfg.qk_rope_head_dim)
    assert cache.c_kv.dtype == torch.float32 and not cache.c_kv.any()
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="suffix prefill is not supported for MLA"):
        lm.prefill(params, torch.tensor([[5, 6]]), cache, 0, start=16)
    with pytest.raises(ValueError, match="does not page"):
        lm.init_paged_cache(8, 16, "cpu")
