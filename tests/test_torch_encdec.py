"""The enc-dec family (whisper-large-v3) in the port against the JAX package,
on the CPU: the layers it adds (LayerNorm with a bias, the tanh gelu, the
biased two-layer MLP) against ``repro.models.layers``; the prefill
kernel's plain version without the causal mask against the Pallas kernel
in interpret mode and the reference's unmasked ``naive_attention``, with
Sq = Sk and Sq != Sk; the decode kernel's plain version at ``lengths = S``
against the reference's cross decode; the parameter bridge, which takes
every leaf of the JAX tree and refuses one it has no place for; and the
reduced model (2 + 2 layers, d 64, 4 heads of 16, 32 frames) against the
JAX ``EncDecLM`` with ``attn_impl="naive"``: ``encode``, ``prefill`` and 6
``decode_step``s, all in f32, to the reference's own decode-consistency
bound, and prefill-then-decode against the reference's full ``forward``.
Inputs are made with numpy from a seed, frames at 0.02 scale as the
reference's tests draw them; the LayerNorms' scales and biases and the
projections' biases are drawn away from the ones and zeros the reference
initialises, so a dropped or misplaced leaf shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import params as jax_pm
from repro.models.model import EncDecLM as JaxEncDec
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_bshd, flash_attention_ref
from repro_torch.models import (
    EncDecCache,
    EncDecLM,
    build_model,
    init_params,
    layers,
    params_from_jax,
)
from repro_torch.models.params import MAX_LEARNED_POS, param_specs

ARCH = "whisper-large-v3"
#: the reference's tests/test_decode_consistency.py bound, f32 logits
LOGIT_TOL = 5e-5
#: the plain functions in f32: the same math in another summation order
F32_TOL = 2e-6
#: bf16: 2^-5 of the row's largest |logit|, as the other families' tests
BF16_LOGIT_REL = 2.0**-5
DECODE_STEPS = 6
MAX_LEN = 32


def _cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _jax_tree(seed=0, perturb=True):
    """The JAX model's parameters as numpy arrays; with ``perturb``, every
    LayerNorm scale and bias and every projection bias drawn from a seed
    in place of the reference's ones and zeros."""
    jcfg, _ = _cfgs()
    model = JaxEncDec(jcfg, remat="none", attn_impl="naive")
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
                elif k == "bias":
                    node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)

        walk(tree)
    return model, tree


# -- the layers ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_norm_matches_reference(dtype):
    x = _x(0, (2, 5, 64), 3.0) + 1.5
    p = {"scale": _x(1, (64,)) + 1, "bias": _x(2, (64,))}
    want = jlayers.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x, dtype), 1e-5)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = layers.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(np.asarray(jnp.asarray(x, dtype)
                                                        .astype(jnp.float32))).to(tdtype),
                            1e-5)
    assert got.dtype == tdtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    else:
        # f32 inside, one rounding to bf16 at the end on both sides
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8, atol=2**-8)


def test_gelu_is_the_reference_tanh_form():
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jlayers.activation("gelu", jnp.asarray(x)))
    got = layers.activation("gelu", torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    # the exact erf form is not the reference's: it differs by ~10x the bound
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4
    silu = layers.activation("silu", torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(silu, np.asarray(jlayers.activation("silu", jnp.asarray(x))),
                               atol=2e-6, rtol=2e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        layers.activation("relu", torch.from_numpy(x))


def test_biased_mlp_matches_reference():
    x = _x(3, (2, 7, 64))
    jp = {"wi": {"kernel": _x(4, (64, 128), 0.125), "bias": _x(5, (128,), 0.1)},
          "wo": {"kernel": _x(6, (128, 64), 0.09), "bias": _x(7, (64,), 0.1)}}
    want = jlayers.mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), "gelu")
    pp = {"wi": torch.from_numpy(jp["wi"]["kernel"]), "bi": torch.from_numpy(jp["wi"]["bias"]),
          "wo": torch.from_numpy(jp["wo"]["kernel"]), "bo": torch.from_numpy(jp["wo"]["bias"])}
    got = layers.mlp(pp, torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- the kernels' plain versions without the causal mask -----------------------------


@pytest.mark.parametrize("b,h,kh,sq,sk,d", [
    (2, 4, 4, 32, 32, 16),   # the reduced encoder (Sq = Sk = encoder_seq)
    (1, 4, 4, 12, 32, 16),   # the reduced cross-attention prefill
    (1, 4, 4, 64, 64, 64),   # whisper's head width
    (1, 8, 2, 16, 128, 64),  # G = 4, Sq much smaller than Sk
])
def test_noncausal_flash_ref_matches_pallas_and_naive(b, h, kh, sq, sk, d):
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)))
    ours = flash_attention_ref(*(torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)),
                               causal=False).transpose(1, 2).numpy()
    kernel = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                       block_q=min(sq, 16), block_k=min(sk, 16), interpret=True)
    naive = jattn.naive_attention(*(jnp.asarray(t).transpose(0, 2, 1, 3) for t in (q, k, v)),
                                  None, d**-0.5).transpose(0, 2, 1, 3)
    for want in (kernel, naive):
        np.testing.assert_allclose(ours, np.asarray(want), atol=1e-5, rtol=1e-5)
    # the dispatch takes the flag to the plain version on the CPU
    bshd = flash_attention_bshd(*(torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)),
                                causal=False).transpose(1, 2).numpy()
    np.testing.assert_array_equal(bshd, ours)
    # and not causal is not causal: Sq = Sk with the mask differs
    causal = flash_attention_ref(*(torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)),
                                 q_offset=sk - sq).transpose(1, 2).numpy()
    if sq == 1:
        np.testing.assert_allclose(causal, ours, atol=1e-6)
    else:
        assert np.abs(causal - ours).max() > 1e-3


def test_noncausal_equals_causal_at_the_last_offset():
    """Every query at position Sk - 1 sees all keys: the same function."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 12, 4, 16), (1, 32, 4, 16), (1, 32, 4, 16)))
    a = flash_attention_ref(q, k, v, causal=False)
    # q_offset = Sk - 1 puts query 0 at the last key: every query sees all
    b = flash_attention_ref(q, k, v, q_offset=31)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_decode_ref_matches_reference_unmasked(dtype):
    """One token a slot over every row of an f32 cross cache: the plain
    decode at ``lengths = S`` is the reference's ``naive_attention(q, ck,
    cv, None, scale)``."""
    b, h, t, dh = 3, 4, 32, 16
    q = _x(20, (b, 1, h, dh))
    ck, cv = _x(21, (b, t, h, dh)), _x(22, (b, t, h, dh))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    qj = jnp.asarray(q, jdtype)
    want = jattn.naive_attention(qj, jnp.asarray(ck), jnp.asarray(cv), None, dh**-0.5)
    qt = torch.from_numpy(np.asarray(qj.astype(jnp.float32))).to(dtype)
    got = decode_attention_ref(qt, torch.from_numpy(ck), torch.from_numpy(cv),
                               torch.full((b,), t, dtype=torch.int32))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2**-8
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# -- parameters ----------------------------------------------------------------------


def test_bridge_takes_every_leaf_and_refuses_an_extra_one():
    _, tree = _jax_tree(perturb=False)
    _, pcfg = _cfgs()
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    n_jax = sum(a.size for a in jax.tree.leaves(tree))
    n_port = sum(t.numel() for t in jax.tree.leaves(params))
    assert n_port == n_jax
    # the layer norms' biases and the MLP's come across where they belong
    assert torch.equal(params["decoder"]["ln_cross"]["bias"],
                       torch.from_numpy(tree["decoder"]["ln_cross"]["bias"]))
    assert torch.equal(params["encoder"]["mlp"]["bo"],
                       torch.from_numpy(tree["encoder"]["mlp"]["wo"]["bias"]))
    assert torch.equal(params["dec_pos"], torch.from_numpy(tree["dec_pos"]["table"]))
    # a leaf the port has no place for (a bias on the output projection)
    tree["decoder"]["cross"]["wo"]["bias"] = np.zeros(
        (pcfg.n_layers, pcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="decoder/cross/wo/bias"):
        params_from_jax(tree, pcfg, device="cpu")


def test_init_params_follow_the_reference_specs():
    jcfg, pcfg = _cfgs()
    specs = JaxEncDec(jcfg).param_specs()
    jshapes = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   specs, is_leaf=jax_pm.is_spec)[0]}
    params = init_params(pcfg, 0, device="cpu")
    assert params["dec_pos"].shape == (MAX_LEARNED_POS, pcfg.d_model)
    assert params["enc_pos"].shape == (pcfg.encoder_seq, pcfg.d_model)
    assert sum(t.numel() for t in jax.tree.leaves(params)) == sum(
        int(np.prod(s)) for s in jshapes.values())
    for name in ("ln1", "ln2", "ln_cross"):
        assert torch.equal(params["decoder"][name]["scale"],
                           torch.ones_like(params["decoder"][name]["scale"]))
        assert not params["decoder"][name]["bias"].any()
    assert not params["encoder"]["attn"]["bq"].any()
    assert not params["decoder"]["mlp"]["bi"].any()
    assert params["decoder"]["cross"]["wq"].dtype == torch.bfloat16
    assert params["decoder"]["cross"]["bk"].dtype == torch.float32
    assert set(param_specs(pcfg)) == set(specs)


def test_published_config_copied():
    fields = ("family", "n_layers", "n_encoder_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab_size", "padded_vocab", "act",
              "qkv_bias", "pos_emb", "norm_eps", "encoder_seq", "tie_embeddings")
    for want, got in ((jax_get_config(ARCH), get_config(ARCH)),
                      (jax_get_config(ARCH).reduced(), get_config(ARCH).reduced())):
        for field in fields:
            assert getattr(got, field) == getattr(want, field), field
        assert got.name == want.name
    full = get_config(ARCH)
    assert (full.encoder_seq, full.head_dim, full.padded_vocab) == (1500, 64, 51_968)
    assert isinstance(build_model(full), EncDecLM)


# -- the model ---------------------------------------------------------------------


def _models(perturb=True):
    jmodel, tree = _jax_tree(perturb=perturb)
    _, pcfg = _cfgs()
    return jmodel, tree, EncDecLM(pcfg), params_from_jax(tree, pcfg, device="cpu",
                                                         dtype=torch.float32)


def test_cache_layout_and_frame_checks():
    _, pcfg = _cfgs()
    lm = EncDecLM(pcfg)
    cache = lm.init_cache(3, MAX_LEN, "cpu")
    assert isinstance(cache, EncDecCache) and cache.max_len == MAX_LEN
    assert cache.self_kv.k.shape == (pcfg.n_layers, 3, MAX_LEN, pcfg.n_kv_heads,
                                     pcfg.head_dim)
    assert cache.cross.v.shape == (pcfg.n_layers, 3, pcfg.encoder_seq,
                                   pcfg.n_kv_heads, pcfg.head_dim)
    assert cache.cross.k.dtype == torch.float32 and not cache.cross.k.any()
    params = init_params(pcfg, 0, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="frames must be"):
        lm.prefill(params, torch.tensor([[5, 6]]), cache, 0,
                   frames=torch.zeros((1, pcfg.encoder_seq - 1, pcfg.d_model)))
    with pytest.raises(ValueError, match="not paged"):
        lm.decode_step(params, torch.zeros((3, 1), dtype=torch.long), cache,
                       torch.zeros(3, dtype=torch.long), pages=object())
    with pytest.raises(ValueError, match="learned positions"):
        EncDecLM(pcfg.replace(pos_emb="rope"))


def test_encoder_matches_jax():
    jmodel, tree, lm, params = _models()
    frames = _x(30, (1, lm.cfg.encoder_seq, lm.cfg.d_model), 0.02)
    want = jmodel.encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(frames), jnp.float32)
    got = lm.encode(params, torch.from_numpy(frames), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("prompt_len,slot", [(7, 0), (1, 2), (13, 1)])
def test_prefill_and_decode_match_jax(prompt_len, slot):
    """The port's prefill into one slot of a 3-slot cache, then 6 decode
    steps of every slot (the others at stale positions, as in the
    batcher), against the JAX model on a 1-row cache: slot ``slot``'s
    logits within the reference's decode-consistency bound, greedy tokens
    equal."""
    jmodel, tree, lm, params = _models()
    cfg = lm.cfg
    jparams = jax.tree.map(jnp.asarray, tree)
    frames = _x(40 + prompt_len, (1, cfg.encoder_seq, cfg.d_model), 0.02)
    toks = np.random.default_rng(prompt_len).integers(3, cfg.vocab_size,
                                                      (1, prompt_len))
    jcache = jax_pm.init_params(jax.random.key(1), jmodel.cache_specs(1, MAX_LEN,
                                                                      jnp.float32))
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                          "frames": jnp.asarray(frames)},
                                jcache, dtype=jnp.float32)
    cache = lm.init_cache(3, MAX_LEN, "cpu")
    pl = lm.prefill(params, torch.from_numpy(toks), cache, slot,
                    frames=torch.from_numpy(frames), dtype=torch.float32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    # the cross rows hold the whole encoder projection, in f32
    np.testing.assert_allclose(cache.cross.k[:, slot].numpy(),
                               np.asarray(jcache["cross"]["k"][:, 0]), atol=1e-5)
    nxt = int(np.asarray(jl).argmax(-1)[0])
    assert int(pl.argmax(-1)[0]) == nxt
    positions = torch.tensor([5, 9, 3])
    positions[slot] = prompt_len
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
    """The reference's full ``forward`` over the prompt and the tokens fed
    after it: the port's prefill logits at the prompt's last position and
    each decode step's at the next (the port's counterpart of
    tests/test_decode_consistency.py)."""
    jmodel, tree, lm, params = _models()
    cfg = lm.cfg
    rng = np.random.default_rng(7)
    frames = _x(50, (1, cfg.encoder_seq, cfg.d_model), 0.02)
    seq = rng.integers(3, cfg.vocab_size, (1, 9 + DECODE_STEPS))
    full, _ = jmodel.forward(jax.tree.map(jnp.asarray, tree),
                             {"tokens": jnp.asarray(seq, jnp.int32),
                              "frames": jnp.asarray(frames)}, dtype=jnp.float32)
    full = np.asarray(full)[0]
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    got = [lm.prefill(params, torch.from_numpy(seq[:, :9]), cache, 0,
                      frames=torch.from_numpy(frames), dtype=torch.float32)[0]]
    for i in range(DECODE_STEPS - 1):
        got.append(lm.decode_step(params, torch.from_numpy(seq[:, 9 + i: 10 + i]), cache,
                                  torch.tensor([9 + i]), dtype=torch.float32)[0])
    np.testing.assert_allclose(torch.stack(got).numpy(), full[8:8 + DECODE_STEPS],
                               atol=LOGIT_TOL, rtol=0)


def test_bf16_prefill_and_decode_near_jax():
    """The compute dtype of the card: bf16 weights and activations on both
    sides, the logits within 2^-5 of the row's largest."""
    jmodel, tree, lm, _ = _models()
    cfg = lm.cfg
    params = params_from_jax(tree, cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    frames = _x(60, (1, cfg.encoder_seq, cfg.d_model), 0.02)
    toks = np.random.default_rng(60).integers(3, cfg.vocab_size, (1, 10))
    jcache = jax_pm.init_params(jax.random.key(1), jmodel.cache_specs(1, MAX_LEN,
                                                                      jnp.float32))
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                          "frames": jnp.asarray(frames)}, jcache)
    cache = lm.init_cache(1, MAX_LEN, "cpu")
    pl = lm.prefill(params, torch.from_numpy(toks), cache, 0,
                    frames=torch.from_numpy(frames))
    rows = [(pl[0], np.asarray(jl)[0])]
    for i in range(3):
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray([[7 + i]], jnp.int32), jcache,
                                        jnp.asarray([10 + i], jnp.int32))
        pl = lm.decode_step(params, torch.tensor([[7 + i]]), cache, torch.tensor([10 + i]))
        rows.append((pl[0], np.asarray(jl)[0]))
    for got, want in rows:
        assert np.abs(got.numpy() - want).max() <= BF16_LOGIT_REL * np.abs(want).max()
