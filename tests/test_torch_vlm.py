"""The VLM family (paligemma-3b) in the port against the JAX package, on the
CPU: the prefill kernel's plain version under the prefix-LM mask against
the reference's ``naive_attention`` with ``make_causal_mask(S, S, P)`` at P
in {0, 1, 8, S} and G in {1, 4, 8}; the gated MLP with gemma's tanh gelu
(and SwiGLU, unchanged) against the reference's ``gated_mlp``; the
embedding scale, ``sqrt(d_model)`` rounded to bf16 before the product; the
parameter bridge, which takes every leaf of the JAX VLM; and the reduced
model (2 layers, d 64, 4 heads over 1 KV head of 16, 8 patch positions)
against the JAX ``TransformerLM`` with ``attn_impl="naive"``: prefill with
patches and 4 decode steps in f32, to the reference's decode-consistency
bound, prefill-then-decode against the reference's full ``forward``, and
bf16 near it.  Inputs (tokens, patches) are made with numpy from a seed,
patches at the reference tests' scale of 0.02."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import params as jax_pm
from repro.models.model import TransformerLM as JaxLM
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_bshd, flash_attention_ref
from repro_torch.models import TransformerLM, build_model, init_params, layers, params_from_jax
from repro_torch.models.params import param_specs

ARCH = "paligemma-3b"
#: the reference's tests/test_decode_consistency.py bound, f32 logits
LOGIT_TOL = 5e-5
#: the plain functions in f32: the same math in another summation order
F32_TOL = 2e-6
#: bf16: 2^-5 of the row's largest |logit|, as the other families' tests
BF16_LOGIT_REL = 2.0**-5
DECODE_STEPS = 4
MAX_LEN = 48


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# -- the prefill kernel's plain version under the prefix-LM mask -----------------


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("prefix", [0, 1, 8, 24])
def test_flash_ref_prefix_mask_matches_reference(prefix, group):
    """P = 24 is the whole sequence: every row sees every key."""
    b, s, kh, d = 2, 24, 2, 16
    q = _x(prefix + group, (b, s, kh * group, d))
    k = _x(prefix + group + 1, (b, s, kh, d))
    v = _x(prefix + group + 2, (b, s, kh, d))
    want = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jattn.make_causal_mask(s, s, prefix), d**-0.5)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    # the model-facing entry takes the plain version on the CPU
    assert torch.equal(flash_attention_bshd(tq, tk, tv, prefix_len=prefix), got)
    plain = flash_attention_ref(tq, tk, tv)
    if prefix <= 1:  # a prefix of one position is the causal mask
        assert torch.equal(got, plain)
    else:  # the prefix rows see later prefix keys; the rows after it do not move
        assert not torch.equal(got[:, : prefix - 1], plain[:, : prefix - 1])
        assert torch.equal(got[:, prefix:], plain[:, prefix:])


# -- config, layers, the embedding scale, the bridge ----------------------------------


def test_config_matches_the_reference():
    fields = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "padded_vocab", "act", "n_vision_tokens",
              "embed_scale", "tie_embeddings", "rope_theta", "norm_eps", "qkv_bias",
              "qk_norm", "pos_emb")
    for got, want in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_config(ARCH).reduced(), jax_get_config(ARCH).reduced())):
        for field in fields:
            assert getattr(got, field) == getattr(want, field), field
        assert got.name == want.name
    full, red = get_config(ARCH), get_config(ARCH).reduced()
    assert (full.head_dim, full.n_heads // full.n_kv_heads, full.n_vision_tokens) == (
        256, 8, 256)
    assert (red.head_dim, red.n_heads // red.n_kv_heads, red.n_vision_tokens) == (
        16, 4, 8)
    assert isinstance(build_model(full), TransformerLM)
    with pytest.raises(ValueError, match="n_vision_tokens"):
        build_model(full.replace(n_vision_tokens=0))


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_gated_mlp_matches_reference(act):
    x = _x(3, (2, 7, 64))
    jp = {"wi": {"kernel": _x(4, (64, 128), 0.125)}, "wg": {"kernel": _x(5, (64, 128), 0.125)},
          "wo": {"kernel": _x(6, (128, 64), 0.09)}}
    want = jlayers.gated_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), act)
    got = layers.gated_mlp({k: torch.from_numpy(v["kernel"]) for k, v in jp.items()},
                           torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_embed_scale_rounds_to_the_compute_dtype_first():
    """bf16: the scale is 45.25 (sqrt(2,048) rounded to bf16), not 45.2548,
    bit for bit the reference's ``_embed_tokens``; f32 keeps sqrt(2,048)."""
    cfg = get_config(ARCH).replace(n_layers=1, vocab_size=512)
    table = _x(8, (cfg.padded_vocab, cfg.d_model))
    toks = np.random.default_rng(8).integers(0, 512, (1, 9))
    jmodel = JaxLM(jax_get_config(ARCH).replace(n_layers=1, vocab_size=512), remat="none")
    lm = TransformerLM(cfg)
    assert float(torch.tensor(math.sqrt(cfg.d_model), dtype=torch.bfloat16)) == 45.25
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = jmodel._embed_tokens({"embed": {"table": jnp.asarray(table)}},
                                    jnp.asarray(toks, jnp.int32), jdt)
        got = lm._embed({"embed": torch.from_numpy(table)}, torch.from_numpy(toks), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    exact = (torch.from_numpy(table)[torch.from_numpy(toks)].to(torch.bfloat16).float()
             * math.sqrt(cfg.d_model)).to(torch.bfloat16)
    assert not torch.equal(exact, lm._embed({"embed": torch.from_numpy(table)},
                                            torch.from_numpy(toks), torch.bfloat16))


def _jax_tree(seed=0, perturb=True):
    """The reduced JAX VLM's parameters as numpy arrays; with ``perturb``
    the RMSNorm scales drawn away from the reference's ones, so a dropped
    or misplaced leaf shows."""
    model = JaxLM(jax_get_config(ARCH).reduced(), remat="none", attn_impl="naive")
    tree = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(seed),
                                                       model.param_specs()))
    if perturb:
        rng = np.random.default_rng(seed + 100)

        def walk(node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v)
                elif k == "scale":
                    node[k] = (1 + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)

        walk(tree)
    return model, tree


def test_params_from_jax_takes_every_vlm_leaf():
    _, tree = _jax_tree()
    cfg = get_config(ARCH).reduced()
    params = params_from_jax(tree, cfg, device="cpu")
    specs = param_specs(cfg)
    assert set(params) == set(specs) == {"embed", "final_norm", "layers"}
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  tree["embed"]["table"].astype(np.float32)
                                  .astype(jnp.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(params["layers"]["mlp"]["wg"].float().numpy(),
                                  np.asarray(jnp.asarray(tree["dense_layers"]["mlp"]["wg"]
                                                         ["kernel"], jnp.bfloat16)
                                             .astype(jnp.float32)))
    np.testing.assert_array_equal(params["layers"]["ln2"].numpy(),
                                  tree["dense_layers"]["ln2"]["scale"])
    tree["dense_layers"]["attn"]["extra"] = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="does not take"):
        params_from_jax(tree, cfg, device="cpu")
    init = init_params(cfg, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in init["layers"]["attn"].items()} == {
        k: tuple(v.shape) for k, v in params["layers"]["attn"].items()}


# -- the model ---------------------------------------------------------------------


def _models(perturb=True):
    jmodel, tree = _jax_tree(perturb=perturb)
    cfg = get_config(ARCH).reduced()
    return jmodel, tree, TransformerLM(cfg), params_from_jax(tree, cfg, device="cpu",
                                                             dtype=torch.float32)


def _jcache(jmodel):
    return jax_pm.init_params(jax.random.key(1), jmodel.cache_specs(1, MAX_LEN,
                                                                    jnp.float32))


@pytest.mark.parametrize("prompt_len,slot", [(7, 0), (1, 2), (13, 1)])
def test_prefill_and_decode_match_jax(prompt_len, slot):
    """The port's prefill with patches into one slot of a 3-slot cache,
    then 4 decode steps of every slot (the others at stale positions, as in
    the batcher), against the JAX model on a 1-row cache: slot ``slot``'s
    logits within the reference's decode-consistency bound, greedy tokens
    equal, the cache rows over the prefix and the prompt equal."""
    jmodel, tree, lm, params = _models()
    cfg = lm.cfg
    jparams = jax.tree.map(jnp.asarray, tree)
    patches = _x(40 + prompt_len, (1, cfg.n_vision_tokens, cfg.d_model), 0.02)
    toks = np.random.default_rng(prompt_len).integers(3, cfg.vocab_size, (1, prompt_len))
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                          "patches": jnp.asarray(patches)},
                                _jcache(jmodel), dtype=jnp.float32)
    cache = lm.init_cache(3, MAX_LEN, "cpu")
    pl = lm.prefill(params, torch.from_numpy(toks), cache, slot,
                    patches=torch.from_numpy(patches), dtype=torch.float32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    n = cfg.n_vision_tokens + prompt_len
    np.testing.assert_allclose(cache.k[:, slot, :n].numpy(),
                               np.asarray(jcache["dense_layers"]["k"][:, 0, :n]), atol=1e-5)
    assert not cache.k[:, slot, n:].any()
    nxt = int(np.asarray(jl).argmax(-1)[0])
    assert int(pl.argmax(-1)[0]) == nxt
    positions = torch.tensor([5, 9, 3])
    positions[slot] = n
    for _ in range(DECODE_STEPS):
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray([[nxt]], jnp.int32), jcache,
                                        jnp.asarray([int(positions[slot])], jnp.int32),
                                        dtype=jnp.float32)
        step = torch.full((3, 1), 4, dtype=torch.long)
        step[slot, 0] = nxt
        pl = lm.decode_step(params, step, cache, positions, dtype=torch.float32)
        np.testing.assert_allclose(pl[slot].numpy(), np.asarray(jl)[0],
                                   atol=LOGIT_TOL, rtol=0)
        nxt = int(np.asarray(jl).argmax(-1)[0])
        assert int(pl[slot].argmax()) == nxt
        positions = positions + 1


def test_prefill_then_decode_match_the_reference_forward():
    """The reference's full ``forward`` over the patches, the prompt and the
    tokens fed after it: the port's prefill logits at the prompt's last
    position and each decode step's at the next."""
    jmodel, tree, lm, params = _models()
    cfg = lm.cfg
    p = cfg.n_vision_tokens
    patches = _x(50, (1, p, cfg.d_model), 0.02)
    seq = np.random.default_rng(7).integers(3, cfg.vocab_size, (1, 9 + DECODE_STEPS))
    full, _ = jmodel.forward(jax.tree.map(jnp.asarray, tree),
                             {"tokens": jnp.asarray(seq, jnp.int32),
                              "patches": jnp.asarray(patches)}, dtype=jnp.float32)
    full = np.asarray(full)[0]
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    got = [lm.prefill(params, torch.from_numpy(seq[:, :9]), cache, 0,
                      patches=torch.from_numpy(patches), dtype=torch.float32)[0]]
    for i in range(DECODE_STEPS - 1):
        got.append(lm.decode_step(params, torch.from_numpy(seq[:, 9 + i: 10 + i]), cache,
                                  torch.tensor([p + 9 + i]), dtype=torch.float32)[0])
    np.testing.assert_allclose(torch.stack(got).numpy(), full[p + 8:p + 8 + DECODE_STEPS],
                               atol=LOGIT_TOL, rtol=0)


def test_bf16_prefill_and_decode_near_jax():
    """The compute dtype of the card: bf16 weights, patches and activations
    on both sides, the logits within 2^-5 of the row's largest."""
    jmodel, tree, lm, _ = _models()
    cfg = lm.cfg
    params = params_from_jax(tree, cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    patches = _x(60, (1, cfg.n_vision_tokens, cfg.d_model), 0.02)
    toks = np.random.default_rng(60).integers(3, cfg.vocab_size, (1, 10))
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                          "patches": jnp.asarray(patches)}, _jcache(jmodel))
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    pl = lm.prefill(params, torch.from_numpy(toks), cache, 0,
                    patches=torch.from_numpy(patches))
    rows = [(pl[0], np.asarray(jl)[0])]
    n = cfg.n_vision_tokens + 10
    for i in range(3):
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray([[7 + i]], jnp.int32), jcache,
                                        jnp.asarray([n + i], jnp.int32))
        pl = lm.decode_step(params, torch.tensor([[7 + i]]), cache, torch.tensor([n + i]))
        rows.append((pl[0], np.asarray(jl)[0]))
    for got, want in rows:
        assert np.abs(got.numpy() - want).max() <= BF16_LOGIT_REL * np.abs(want).max()


def test_prefill_refusals():
    """A suffix prefill in the reference's words; a prefill without its
    patches, with patches of another shape, or patches given to a model
    of another family; a prompt whose prefix and tokens pass max_len."""
    jmodel, tree, lm, params = _models(perturb=False)
    cfg = lm.cfg
    patches = torch.zeros((1, cfg.n_vision_tokens, cfg.d_model))
    cache = lm.init_cache(1, 16, "cpu")
    jcache = _jcache(jmodel)
    with pytest.raises(ValueError) as jerr:
        jmodel.prefill(jax.tree.map(jnp.asarray, tree),
                       {"tokens": jnp.zeros((1, 3), jnp.int32),
                        "patches": jnp.zeros((1, cfg.n_vision_tokens, cfg.d_model))},
                       jcache, start=4)
    with pytest.raises(ValueError) as perr:
        lm.prefill(params, torch.tensor([[5, 6, 7]]), cache, 0, start=4, patches=patches)
    assert str(perr.value) == str(jerr.value)
    for bad in (None, patches[:, 1:]):
        with pytest.raises(ValueError, match="patches"):
            lm.prefill(params, torch.tensor([[5, 6]]), cache, 0, patches=bad)
    with pytest.raises(ValueError, match="exceeds max_len"):
        lm.prefill(params, torch.tensor([[5] * 9]), cache, 0, patches=patches)
    lm.prefill(params, torch.tensor([[5] * 8]), cache, 0, patches=patches)
    dense = get_config("qwen3-4b").reduced()
    with pytest.raises(ValueError, match="only the vlm family"):
        TransformerLM(dense).prefill(init_params(dense, 0, device="cpu"),
                                     torch.tensor([[5, 6]]),
                                     TransformerLM(dense).init_cache(1, 16, "cpu"), 0,
                                     patches=patches)
