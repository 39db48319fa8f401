"""The port's MoE family (``repro_torch.models.moe`` and the MoE
``TransformerLM``) against the JAX package's, on the CPU, on the reduced
qwen3-moe-30b-a3b config (8 experts, top 2) with the JAX model's own
weights carried across by the bridge.  Inputs are made with numpy from a
seed."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro_torch.configs import get_config
from repro_torch.models import TransformerLM, init_params, moe, params_from_jax
from repro_torch.models.params import param_specs
from repro_torch.serve.steps import greedy_sample

ARCH = "qwen3-moe-30b-a3b"
MAX_LEN = 64
#: the dense model test's f32 tolerance (tests/test_torch_model.py)
F32_LOGIT_TOL = 1e-4
#: bf16: 2^-5 of the row's largest |logit|, 4 bf16 ulps of it.  The untied
#: unembedding gives logits of 3-5 here (the dense test's tied ones are
#: O(0.5)), and the expert path rounds to bf16 at more places
BF16_LOGIT_REL = 2.0**-5
#: a row whose k-th and (k+1)-th router probabilities lie this close may
#: route either way in another summation order
NEAR_TIE = 1e-6
#: a bf16 routing gap under which the two frameworks' roundings (~2^-8 of
#: the hidden state) can flip a token's expert
BF16_ROUTE_GAP = 1e-2
#: ``chip_smoke.py`` phase 10 (d)'s tolerance of the bf16 block against
#: the f32 naive version: 2^-6 of the value plus 2^-6 of the row's largest
NAIVE_RTOL = NAIVE_ROW = 2.0**-6

VARIANTS = {
    "reduced": {},
    # the deepseek wiring: a leading dense layer and a shared expert
    "shared-first-dense": {"first_k_dense": 1, "n_shared_experts": 1},
}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (jax_get_config(ARCH).reduced().replace(**kw),
            get_config(ARCH).reduced().replace(**kw))


@pytest.fixture(scope="module")
def models():
    """Per variant: (JAX cfg, JAX model, JAX params, numpy tree, port cfg)."""
    out = {}
    for variant in VARIANTS:
        cfg, pcfg = _cfgs(variant)
        model = JaxLM(cfg, remat="none")
        params = jax_pm.init_params(jax.random.key(0), model.param_specs())
        out[variant] = (cfg, model, params, jax.tree.map(np.asarray, params), pcfg)
    return out


def _layer(tree, i=0):
    """MoE layer ``i``'s routed-expert parameters: the JAX ones and the
    bridged f32 port ones."""
    jp = jax.tree.map(lambda a: a[i], tree["moe_layers"]["moe"])
    return jp, {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()
                if k != "shared"}


def _hidden(seed, b, s, d):
    """Hidden states sharing one direction, as a layer's inputs do, so that
    the router favours some experts and their queues overflow."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d))
            + 2.0 * rng.standard_normal(d)).astype(np.float32)


def _jax_routing(jp, cfg, x):
    """The reference's probabilities, mask and kept set (``moe.py:88-104``)."""
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"]),
                           axis=-1)
    _, mask = jax_moe._top_k_mask(probs, cfg.n_experts_per_token)
    pos = jnp.cumsum(mask.astype(jnp.int32), axis=1) - 1
    keep = mask & (pos < jax_moe.expert_capacity(cfg, x.shape[1]))
    return np.asarray(probs), np.asarray(mask), np.asarray(keep)


def _near_ties(probs, k):
    top = -np.sort(-probs, axis=-1)
    return np.abs(top[..., k - 1] - top[..., k]) < NEAR_TIE  # (B, S)


@pytest.mark.parametrize("s", [12, 40])
def test_moe_block_f32_matches_jax(models, s):
    cfg, _, _, tree, pcfg = models["reduced"]
    jp, tp = _layer(tree)
    x = _hidden(s, 2, s, cfg.d_model)
    want, _ = jax_moe.moe_block(jp, cfg, jnp.asarray(x))
    got = moe.moe_block(tp, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    _, _, mask, keep, _ = moe.route(tp, pcfg, torch.from_numpy(x))
    assert int((mask & ~keep).sum()) > 0  # the drops were exercised


@pytest.mark.parametrize("s", [12, 40])
def test_routing_mask_and_kept_set_equal_jax(models, s):
    """Mask and kept set equal exactly, but on rows whose k-th and (k+1)-th
    probabilities nearly tie (counted; a batch row holding one has its
    kept set exempt too, since a token's queue position counts the tokens
    before it)."""
    cfg, _, _, tree, pcfg = models["reduced"]
    jp, tp = _layer(tree)
    x = _hidden(100 + s, 4, s, cfg.d_model)
    probs, jmask, jkeep = _jax_routing(jp, cfg, x)
    _, _, mask, keep, _ = moe.route(tp, pcfg, torch.from_numpy(x))
    ties = _near_ties(probs, cfg.n_experts_per_token)
    print(f"near-tie rows: {int(ties.sum())} of {ties.size}")
    np.testing.assert_array_equal(mask.numpy()[~ties], jmask[~ties])
    clean = ~ties.any(axis=1)
    assert clean.sum() >= 3
    np.testing.assert_array_equal(keep.numpy()[clean], jkeep[clean])
    assert (jmask & ~jkeep).any()


def test_zero_router_admits_every_expert_as_jax(models):
    """A zero router ties every expert: all are admitted at weight 1/E, and
    the capacity decides which tokens each keeps."""
    cfg, _, _, tree, pcfg = models["reduced"]
    jp, tp = _layer(tree)
    jp = {**jp, "router": np.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _hidden(7, 2, 12, cfg.d_model)
    want, _ = jax_moe.moe_block(jp, cfg, jnp.asarray(x))
    got = moe.moe_block(tp, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    _, weights, mask, keep, _ = moe.route(tp, pcfg, torch.from_numpy(x))
    assert bool(mask.all())
    torch.testing.assert_close(weights, torch.full_like(weights, 1 / cfg.n_experts))
    # capacity 4 of 12 tokens: each expert keeps the first 4 of each row
    assert bool(keep[:, :4].all()) and not bool(keep[:, 4:].any())


@pytest.mark.parametrize("s", [12, 40])
def test_moe_block_equals_the_naive_version(models, s):
    """The fixed-shape block against the token-by-token loop that
    ``chip_smoke.py`` phase 10 (d) also holds it to, in f32."""
    cfg, _, _, tree, pcfg = models["reduced"]
    _, tp = _layer(tree, 1)
    x = torch.from_numpy(_hidden(200 + s, 2, s, cfg.d_model))
    got = moe.moe_block(tp, pcfg, x)
    want, nmask, nkeep = moe.moe_block_naive(tp, pcfg, x)
    _, _, mask, keep, _ = moe.route(tp, pcfg, x)
    assert torch.equal(mask, nmask) and torch.equal(keep, nkeep)
    assert bool((nmask & ~nkeep).any())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_block_within_the_chip_gate_tolerance_of_naive():
    """In bf16 at wider widths (32 experts, top 8, d_model 256, 96 expert
    hidden), with drops: the same routing, and the output within phase 10
    (d)'s tolerance of the f32 naive version with a third of it to spare."""
    cfg = get_config(ARCH).replace(d_model=256, moe_d_ff=96, n_experts=32)
    g = torch.Generator().manual_seed(0)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def normal(*shape):
        return torch.randn(shape, generator=g) / math.sqrt(shape[-2])

    p = {"router": normal(d, e), "wi": normal(e, d, f).bfloat16(),
         "wg": normal(e, d, f).bfloat16(), "wo": normal(e, f, d).bfloat16()}
    x = torch.from_numpy(_hidden(3, 1, 96, d)).bfloat16()
    got = moe.moe_block(p, cfg, x).float()
    want, nmask, nkeep = moe.moe_block_naive(p, cfg, x)
    _, _, mask, keep, _ = moe.route(p, cfg, x)
    assert torch.equal(mask, nmask) and torch.equal(keep, nkeep)
    assert bool((nmask & ~nkeep).any())
    allow = NAIVE_RTOL * want.abs() + NAIVE_ROW * want.abs().amax(-1, keepdim=True)
    assert float(((got - want).abs() / allow).max()) <= 2 / 3


def _jax_cache(model, max_len=MAX_LEN):
    return jax_pm.init_params(jax.random.key(1),
                              model.cache_specs(1, max_len, jnp.float32))


def _jax_greedy(logits, vocab_size):
    row = np.asarray(logits, np.float32)[0]
    return int(np.argmax(np.where(np.arange(row.size) < vocab_size, row, -np.inf)))


def _rollout(entry, prompt, n_steps, dtype_j, dtype_t, after_call=lambda: None):
    """Prefill one prompt and greedy-decode ``n_steps`` tokens in both
    frameworks, each feeding back its own tokens; ``after_call`` runs after
    each call.  Returns per-step logits of both, both token lists and both
    caches."""
    cfg, jmodel, jparams, tree, pcfg = entry
    lm = TransformerLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=dtype_t)
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    jcache = _jax_cache(jmodel)
    toks = np.asarray(prompt, np.int64)[None]
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                                jcache, dtype=dtype_j)
    tl = lm.prefill(params, torch.from_numpy(toks), cache, 0, dtype=dtype_t)
    after_call()
    out = [(np.asarray(jl, np.float32), tl.float().numpy())]
    toks_j = [_jax_greedy(jl, cfg.vocab_size)]
    toks_t = [int(greedy_sample(tl, cfg.vocab_size)[0])]
    for i in range(n_steps):
        pos = len(prompt) + i
        jl, jcache = jmodel.decode_step(
            jparams, jnp.asarray([[toks_j[-1]]], jnp.int32), jcache,
            jnp.asarray([pos], jnp.int32), dtype=dtype_j)
        tl = lm.decode_step(params, torch.tensor([[toks_t[-1]]]), cache,
                            torch.tensor([pos]), dtype=dtype_t)
        after_call()
        out.append((np.asarray(jl, np.float32), tl.float().numpy()))
        toks_j.append(_jax_greedy(jl, cfg.vocab_size))
        toks_t.append(int(greedy_sample(tl, cfg.vocab_size)[0]))
    return out, toks_j, toks_t, jcache, cache


def _prompt(seed, n, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(4, vocab, n)]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seed,n", [(0, 12), (1, 23)])
def test_f32_prefill_and_decode_match_jax(models, variant, seed, n):
    entry = models[variant]
    pcfg = entry[-1]
    out, toks_j, toks_t, jcache, cache = _rollout(
        entry, _prompt(seed, n, pcfg.vocab_size), 8, jnp.float32, torch.float32)
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL)
    assert toks_t == toks_j
    # the cache's layer axis runs over the dense stack, then the MoE stack
    jk = np.concatenate([np.asarray(jcache[key]["k"])[:, 0]
                         for key in ("dense_layers", "moe_layers") if key in jcache])
    np.testing.assert_allclose(cache.k[:, 0].numpy(), jk, atol=1e-5, rtol=1e-5)


def test_suffix_prefill_matches_jax(models):
    """Prefill at ``start`` > 0 after a prefix already in the cache: the
    port's paged suffix prefill against the JAX ``prefill(start=...)``.
    The suffix's MoE capacity follows its own length in both."""
    cfg, jmodel, jparams, tree, pcfg = models["shared-first-dense"]
    prompt = _prompt(5, 40, pcfg.vocab_size)
    start, ps = 32, 16
    jcache = _jax_cache(jmodel)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray([prompt[:start]])},
                               jcache, dtype=jnp.float32)
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray([prompt[start:]])},
                           jcache, dtype=jnp.float32, start=start)
    lm = TransformerLM(pcfg)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    cache = lm.init_paged_cache(4, ps, "cpu")
    pages = torch.tensor([2, 0, 3])
    lm.prefill(params, torch.tensor([prompt[:start]]), cache, pages[:2],
               dtype=torch.float32)
    tl = lm.prefill(params, torch.tensor([prompt[start:]]), cache, pages,
                    start=start, dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_LOGIT_TOL,
                               rtol=F32_LOGIT_TOL)
    assert moe.expert_capacity(pcfg, len(prompt) - start) != moe.expert_capacity(
        pcfg, len(prompt))


def test_bf16_differences_sit_on_thin_logit_or_routing_gaps(models, monkeypatch):
    """In bf16 the two frameworks round at other places, so an expert may
    flip where two router probabilities nearly tie, and a greedy token
    where the top two logits do.  Both frameworks' routing masks are
    recorded layer by layer.  Each rollout must stay within the bf16 logit
    tolerance with equal tokens, or depart first at a step whose JAX
    top-two logit gap is under that tolerance or in or after a call whose
    masks differ.  Every token whose mask differs has a port routing gap
    under ``BF16_ROUTE_GAP``; half of the rollouts stay."""
    entry = models["reduced"]
    pcfg = entry[-1]
    k = pcfg.n_experts_per_token
    jmasks: list[np.ndarray] = []
    tmasks: list[np.ndarray] = []
    gaps: list[np.ndarray] = []
    top_k_mask, route = jax_moe._top_k_mask, moe.route

    def recording_top_k_mask(probs, kk):
        weights, mask = top_k_mask(probs, kk)
        jax.debug.callback(lambda m: jmasks.append(np.asarray(m)), mask,
                           ordered=True)
        return weights, mask

    def recording_route(p, cfg, x):
        probs, weights, mask, keep, pos = route(p, cfg, x)
        top = torch.sort(probs, dim=-1, descending=True).values
        tmasks.append(mask.numpy().copy())
        gaps.append((top[..., k - 1] - top[..., k]).numpy())
        return probs, weights, mask, keep, pos

    monkeypatch.setattr(jax_moe, "_top_k_mask", recording_top_k_mask)
    monkeypatch.setattr(moe, "route", recording_route)
    n_rows, n_clean = 8, 0
    for seed in range(n_rows):
        for record in (jmasks, tmasks, gaps):
            record.clear()
        marks: list[int] = []
        out, toks_j, toks_t, *_ = _rollout(
            entry, _prompt(10 + seed, 16, pcfg.vocab_size), 8, jnp.bfloat16,
            torch.bfloat16, after_call=lambda: marks.append(len(tmasks)))
        assert len(jmasks) == len(tmasks) == marks[-1]
        flipped = []  # per MoE call: the tokens whose masks differ
        for jm, tm, gap in zip(jmasks, tmasks, gaps):
            assert jm.shape == tm.shape
            flipped.append((jm != tm).any(-1))
            assert (gap[flipped[-1]] < BF16_ROUTE_GAP).all(), (seed, gap[flipped[-1]])
        tols = [BF16_LOGIT_REL * np.abs(jl).max() for jl, _ in out]
        bad = next((i for i, (jl, tl) in enumerate(out)
                    if np.abs(tl - jl).max() > tols[i]
                    or toks_t[i] != toks_j[i]), None)
        if bad is None:
            n_clean += 1
            continue
        row = np.sort(out[bad][0][0, :pcfg.vocab_size])
        logit_gap = float(row[-1] - row[-2])
        flip_before = any(f.any() for f in flipped[: marks[bad]])
        assert logit_gap < tols[bad] or flip_before, (seed, bad, logit_gap)
    assert n_clean >= n_rows // 2


def test_bridge_layout_and_dtypes(models):
    cfg, *_, tree, pcfg = models["shared-first-dense"]
    p = params_from_jax(tree, pcfg, device="cpu")
    n_moe = pcfg.n_layers - pcfg.first_k_dense
    d, e, f = pcfg.d_model, pcfg.n_experts, pcfg.moe_d_ff
    m = p["moe_layers"]["moe"]
    assert m["router"].shape == (n_moe, d, e) and m["router"].dtype == torch.float32
    assert m["wi"].shape == m["wg"].shape == (n_moe, e, d, f)
    assert m["wo"].shape == (n_moe, e, f, d) and m["wo"].dtype == torch.bfloat16
    assert m["shared"]["wo"].shape == (n_moe, f, d)
    assert p["layers"]["mlp"]["wi"].shape == (1, d, pcfg.dense_d_ff)
    assert p["unembed"].shape == (d, pcfg.padded_vocab)
    assert p["unembed"].dtype == torch.bfloat16
    assert p["moe_layers"]["attn"]["k_norm"].dtype == torch.float32
    # the router keeps its f32 bits; experts round as the reference's
    # per-use astype(bf16) does
    np.testing.assert_array_equal(m["router"].numpy(),
                                  tree["moe_layers"]["moe"]["router"])
    want = np.asarray(jnp.asarray(tree["moe_layers"]["moe"]["wg"])
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(m["wg"].float().numpy(), want)


def test_init_params_seeded_fan_in_scaled():
    port = get_config(ARCH).reduced()
    a = init_params(port, 3, device="cpu")
    b = init_params(port, 3, device="cpu")
    c = init_params(port, 4, device="cpu")
    m = a["moe_layers"]["moe"]
    assert torch.equal(m["wi"], b["moe_layers"]["moe"]["wi"])
    assert not torch.equal(m["wi"], c["moe_layers"]["moe"]["wi"])
    assert m["router"].dtype == torch.float32 and m["wo"].dtype == torch.bfloat16
    for w, fan_in in ((m["router"], port.d_model), (m["wo"], port.moe_d_ff),
                      (a["unembed"], port.d_model)):
        assert abs(float(w.float().std()) - fan_in**-0.5) < 0.1 * fan_in**-0.5
    # the layers of a stack are drawn apart, not copies of one draw
    assert not torch.equal(m["wi"][0], m["wi"][1])
    assert "layers" not in a  # no leading dense layer


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-2.7b"])
def test_init_params_dense_and_mamba_draws_unchanged(arch):
    """The dense and Mamba2 families still draw each leaf whole, in the
    tree's order, from one generator."""
    cfg = get_config(arch).reduced()
    got = init_params(cfg, 5, device="cpu")
    gen = torch.Generator().manual_seed(5)

    def check(spec, leaf, path):
        if isinstance(spec, dict):
            for k in spec:
                check(spec[k], leaf[k], path + (k,))
            return
        shape, kind = spec
        if kind in ("ones", "zeros"):
            return
        w = torch.randn(shape, generator=gen) * (1.0 / math.sqrt(max(shape[-2], 1)))
        w = w.to(torch.bfloat16 if kind == "matrix" else torch.float32)
        assert torch.equal(leaf, w), path

    check(param_specs(cfg), got, ())
