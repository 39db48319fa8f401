"""The port's Mamba2 pieces against the JAX package's, on the CPU: the SSD
scan (the port's plain chunked version and its oracle against JAX's
``ssd_chunked``, the Pallas ``ssd`` in interpret mode and ``ssd_ref``),
the grouped B/C form against the repeated one, and the reduced
``mamba2-2.7b`` ``MambaLM`` with the JAX model's own weights bridged.
Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd import ssd as jax_ssd_pallas
from repro.kernels.ssd import ssd_ref as jax_ssd_ref
from repro.models import params as jax_pm
from repro.models import ssm as jax_ssm
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ssd, ssd_apply, ssd_ref
from repro_torch.models import MambaLM, build_model, init_params, params_from_jax
from repro_torch.models.ssm import _depthwise_causal_conv, _segsum, ssd_chunked
from repro_torch.serve.steps import greedy_sample

ARCH = "mamba2-2.7b"


def _ssd_inputs(rng, b, slen, h, p, n, g=None):
    """The JAX kernel test's draws (``tests/test_kernels.py``), with B and
    C per group (``g`` groups; per head when ``g`` is None)."""
    g = h if g is None else g
    x = (rng.randn(b, slen, h, p) * 0.5).astype(np.float32)
    dt = (np.abs(rng.randn(b, slen, h)) * 0.5 + 0.1).astype(np.float32)
    a = (-np.abs(rng.randn(h)) - 0.2).astype(np.float32)
    bm = (rng.randn(b, slen, g, n) * 0.5).astype(np.float32)
    cm = (rng.randn(b, slen, g, n) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize(
    "b,slen,h,p,n,chunk",
    [(2, 64, 2, 16, 8, 16), (1, 128, 4, 32, 16, 32), (2, 32, 1, 8, 128, 32)],
)
def test_ssd_matches_jax(b, slen, h, p, n, chunk, rng):
    """At the JAX kernel test's shapes: the port's chunked version and its
    oracle against JAX's chunked version, the Pallas kernel in interpret
    mode and the oracle, all f32, atol 5e-5 (the JAX test's own)."""
    arrs = _ssd_inputs(rng, b, slen, h, p, n)
    want = {
        "ssd_ref": jax_ssd_ref(*_j(*arrs)),
        "ssd_chunked": jax_ssm.ssd_chunked(*_j(*arrs), chunk),
        "ssd_pallas": jax_ssd_pallas(*_j(*arrs), chunk=chunk, interpret=True),
    }
    got = {
        "chunked": ssd_chunked(*_t(*arrs), chunk),
        "ref": ssd_ref(*_t(*arrs)),
    }
    for (gname, (gy, gs)), (wname, (wy, ws)) in (
        (g, w) for g in got.items() for w in want.items()
    ):
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=5e-5,
                                   err_msg=f"y: {gname} vs {wname}")
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=5e-5,
                                   err_msg=f"state: {gname} vs {wname}")


@pytest.mark.parametrize("slen,chunk", [(40, 16), (17, 16), (100, 32), (33, 32)])
def test_ragged_lengths_match_jax_ssd_ref(slen, chunk, rng):
    """Lengths past one chunk that are no multiple of it: the reference's
    chunked version refuses them (its assert), its oracle defines them, and
    the port's padded last chunk matches the oracle (f32, atol 5e-5)."""
    arrs = _ssd_inputs(rng, 2, slen, 4, 16, 8)
    with pytest.raises(AssertionError):
        jax_ssm.ssd_chunked(*_j(*arrs), chunk)
    wy, ws = jax_ssd_ref(*_j(*arrs))
    for gy, gs in (ssd_chunked(*_t(*arrs), chunk),
                   ssd_apply(*_t(*arrs), chunk=chunk)):
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=5e-5)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=5e-5)


@pytest.mark.parametrize("g,slen", [(1, 40), (2, 40), (4, 12)])
def test_grouped_form_equals_repeated_form(g, slen, rng):
    """B and C per group give what the reference's repeat out to heads
    gives (head h reads group h // (H / G)); f32, atol 1e-6: the same
    products in another einsum layout."""
    h = 8
    x, dt, a, bm, cm = _ssd_inputs(rng, 2, slen, h, 16, 8, g=g)
    rep_b, rep_c = (np.repeat(m, h // g, axis=2) for m in (bm, cm))
    for fn in (lambda *t: ssd_chunked(*t, 16), ssd_ref):
        gy, gs = fn(*_t(x, dt, a, bm, cm))
        ry, rs = fn(*_t(x, dt, a, rep_b, rep_c))
        np.testing.assert_allclose(gy.numpy(), ry.numpy(), atol=1e-6)
        np.testing.assert_allclose(gs.numpy(), rs.numpy(), atol=1e-6)
    wy, ws = jax_ssd_ref(*_j(x, dt, a, rep_b, rep_c))
    gy, gs = ssd_chunked(*_t(x, dt, a, bm, cm), 16)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=5e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=5e-5)


def _split_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An f32 operand as the kernel feeds it to the bf16 tensor cores: hi =
    bf16(v), lo = bf16(v - hi), both back in f32 (their products with a
    bf16 value are exact in f32)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _ssd_passes(x, dt, a, b_mat, c_mat, chunk):
    """Test-only mirror of the four passes of ``csrc/ssd.cu`` in f32: each
    chunk padded to a multiple of 16 rows with dt = 0; (1) the running sums
    and each chunk's own state from the split operand x dt exp(cum_last -
    cum); (2) C B^T once per (sequence, chunk, group); (3) the state
    recurrence across chunks, keeping the state entering each one; (4) y =
    (C B^T o exp(cum_i - cum_j) o dt_j)(split) x + exp(cum_i) C s_in(split).
    Returns y (f32) and the final state."""
    bsz, slen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    heads = torch.arange(h) // (h // g)
    q = min(chunk, slen)
    nc, qp = -(-slen // q), -(-q // 16) * 16

    def chunks(t):  # (B, L, ...) -> (B, nc, qp, ...), zero past each chunk
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, nc * q - slen))
        t = t.unflatten(1, (nc, q))
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 3) + (0, qp - q))

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(b_mat), chunks(c_mat)
    # pass 1
    cum = torch.cumsum(dtc * a.float(), dim=2)            # (B, nc, qp, H)
    last = cum[:, :, -1]                                  # (B, nc, H)
    xw = xc * (dtc * torch.exp(last[:, :, None] - cum))[..., None]
    local = sum(torch.einsum("bcjhp,bcjhn->bchpn", part, bc[:, :, :, heads])
                for part in _split_bf16(xw))
    # pass 2
    cbt = torch.einsum("bcign,bcjgn->bcgij", cc, bc)      # (B, nc, G, qp, qp)
    # pass 3
    state = torch.zeros((bsz, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + local[:, c]
    s_in = torch.stack(entering, dim=1)                   # (B, nc, H, P, N)
    # pass 4
    ch = cum.permute(0, 1, 3, 2)                          # (B, nc, H, qp)
    causal = torch.tril(torch.ones((qp, qp), dtype=torch.bool))
    diff = ch[..., :, None] - ch[..., None, :]
    decay = torch.exp(diff.masked_fill(~causal, -torch.inf))
    smat = cbt[:, :, heads] * decay * dtc.permute(0, 1, 3, 2)[..., None, :]
    y = sum(torch.einsum("bchij,bcjhp->bcihp", part, xc) for part in _split_bf16(smat))
    y_off = sum(torch.einsum("bcihn,bchpn->bcihp", cc[:, :, :, heads], part)
                for part in _split_bf16(s_in))
    y = y + y_off * torch.exp(cum)[..., None]
    return y[:, :, :q].flatten(1, 2)[:, :slen], state


def _bf16_exact(*arrs):
    """The kernel's x, B and C are bf16: the same values in f32."""
    return [np.asarray(torch.from_numpy(a).bfloat16().float()) for a in arrs]


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize(
    "slen,chunk",
    # one, two and three chunks; a chunk of 12 rows (padded to 16 in the
    # kernel); lengths the Pallas kernel refuses: a ragged last chunk
    [(16, 16), (32, 16), (48, 16), (12, 16), (36, 12), (40, 16), (30, 12)],
)
def test_ssd_kernel_passes_match_jax(slen, chunk, g, rng):
    """The four-pass algorithm of the CUDA kernel, C B^T once per group and
    f32 factors as split bf16 operands, against the JAX Pallas ``ssd`` in
    interpret mode (lengths that are a multiple of the chunk) and JAX's
    ``ssd_ref`` (all), on B and C repeated out to heads for JAX, under the
    chip's gates (``chip_smoke.py``): y within 2^-7 of the value plus 1e-3
    of the row's largest, the state within 2^-10 plus 1e-4.  The split
    operands carry ~16 bits; a dropped chunk or head block moves either by
    whole units of the row's scale."""
    h = 4
    x, dt, a, bm, cm = _ssd_inputs(rng, 2, slen, h, 16, 32, g=g)
    x, bm, cm = _bf16_exact(x, bm, cm)
    rep_b, rep_c = (np.repeat(m, h // g, axis=2) for m in (bm, cm))
    gy, gs = _ssd_passes(*_t(x, dt, a, bm, cm), chunk)
    wants = [jax_ssd_ref(*_j(x, dt, a, rep_b, rep_c))]
    if slen % min(chunk, slen) == 0:
        wants.append(jax_ssd_pallas(*_j(x, dt, a, rep_b, rep_c), chunk=chunk,
                                    interpret=True))
    for wy, ws in wants:
        for got, want, rtol, row_frac in ((gy, wy, 2**-7, 1e-3),
                                          (gs, ws, 2**-10, 1e-4)):
            want = torch.from_numpy(np.array(want))
            allow = rtol * want.abs() + row_frac * want.abs().amax(-1, keepdim=True)
            assert bool(((got - want).abs() <= allow).all())


def test_ssd_dispatch_by_device(rng):
    """CPU tensors take the plain version and launch nothing; the kernel
    binding takes CUDA tensors only; another device raises."""
    arrs = _t(*_ssd_inputs(rng, 1, 20, 2, 64, 128))
    before = ssd.launches
    y, s = ssd_apply(*arrs, chunk=16)
    assert y.shape == (1, 20, 2, 64) and s.shape == (1, 2, 64, 128)
    assert ssd.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd(arrs[0].bfloat16(), *arrs[1:3], arrs[3].bfloat16(), arrs[4].bfloat16())
    meta = [t.to("meta") for t in arrs]
    with pytest.raises(ValueError, match="no SSD scan"):
        ssd_apply(*meta, chunk=16)


def test_segsum_masks_above_the_diagonal_to_exact_zero():
    x = torch.tensor([[-50.0, 60.0, -70.0, 80.0]])
    lmat = torch.exp(_segsum(x))[0]
    assert torch.equal(torch.triu(lmat, 1), torch.zeros(4, 4))
    assert bool(torch.isfinite(lmat).all())
    np.testing.assert_allclose(lmat[3, 1].item(), np.exp(-70.0 + 80.0), rtol=1e-6)


@pytest.mark.parametrize("slen", [1, 2, 9])
def test_depthwise_conv_matches_jax(slen, rng):
    """The sum of 4 shifted f32 products against XLA's depthwise conv, in
    f32 (atol 1e-6) and cast to bf16 (equal up to one bf16 rounding)."""
    x = rng.randn(2, slen, 24).astype(np.float32)
    w = rng.randn(4, 24).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    want = jax_ssm._depthwise_causal_conv(*_j(x, w, bias))
    got = _depthwise_causal_conv(*_t(x, w, bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    xb = x.astype(jnp.bfloat16)
    want_b = jax_ssm._depthwise_causal_conv(jnp.asarray(xb), *_j(w, bias))
    got_b = _depthwise_causal_conv(torch.from_numpy(x).bfloat16(), *_t(w, bias))
    np.testing.assert_allclose(got_b.float().numpy(),
                               np.asarray(want_b, np.float32), rtol=2**-7, atol=1e-6)


# -- the model -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    cfg = jax_get_config(ARCH).reduced()
    model = jax_build(cfg, remat="none")
    params = jax_pm.init_params(jax.random.key(0), model.param_specs())
    return cfg, model, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port():
    return get_config(ARCH).reduced()


def _jax_cache(model):
    return jax_pm.init_params(jax.random.key(1), model.cache_specs(1, 64, jnp.float32))


def _argmax(logits, vocab):
    return int(np.argmax(np.asarray(logits, np.float32)[0, :vocab]))


def _prompt(seed, n, vocab):
    return [int(t) for t in np.random.default_rng(seed).integers(4, vocab, n)]


def _rollout(ref, port_cfg, prompt, n_steps, dtype_j, dtype_t, slot=1):
    """Prefill one prompt, then greedy-decode ``n_steps`` tokens, in both
    frameworks (the port's prompt in ``slot`` of a 3-slot cache, the other
    slots decoding token 0 beside it); each side feeds back its own
    tokens.  Returns per-step logits, both token streams and both caches."""
    _, jmodel, jparams, tree = ref
    lm = MambaLM(port_cfg)
    params = params_from_jax(tree, port_cfg, device="cpu", dtype=dtype_t)
    cache = lm.init_cache(3, 64, "cpu")
    jcache = _jax_cache(jmodel)
    toks = np.asarray(prompt, np.int64)[None]
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                                jcache, dtype=dtype_j)
    tl = lm.prefill(params, torch.from_numpy(toks), cache, slot, dtype=dtype_t)
    out = [(np.asarray(jl), tl.numpy())]
    vocab = port_cfg.vocab_size
    toks_j = [_argmax(jl, vocab)]
    toks_t = [int(greedy_sample(tl, vocab)[0])]
    for s in range(n_steps):
        pos = len(prompt) + s
        jl, jcache = jmodel.decode_step(
            jparams, jnp.asarray([[toks_j[-1]]], jnp.int32), jcache,
            jnp.asarray([pos], jnp.int32), dtype=dtype_j,
        )
        batch = torch.zeros((3, 1), dtype=torch.int64)
        batch[slot, 0] = toks_t[-1]
        tl = lm.decode_step(params, batch, cache, torch.full((3,), pos),
                            dtype=dtype_t)[slot : slot + 1]
        out.append((np.asarray(jl), tl.numpy()))
        toks_j.append(_argmax(jl, vocab))
        toks_t.append(int(greedy_sample(tl, vocab)[0]))
    return out, toks_j, toks_t, jcache, cache


@pytest.mark.parametrize("n", [1, 2, 12, 16])
def test_f32_prefill_and_decode_match_jax(ref, port, n):
    """Prompt lengths the JAX model accepts (1 and 2 are shorter than the
    conv window): f32 logits within 1e-4 (the same math in another
    summation order), greedy tokens equal, and the slot's conv window and
    state equal to the JAX cache after the last step."""
    out, toks_j, toks_t, jcache, cache = _rollout(
        ref, port, _prompt(n, n, port.vocab_size), 8, jnp.float32, torch.float32
    )
    for jl, tl in out:
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert toks_t == toks_j
    jl = jcache["layers"]
    np.testing.assert_allclose(cache.conv[:, 1].numpy(), np.asarray(jl["conv"])[:, 0],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cache.state[:, 1].numpy(),
                               np.asarray(jl["state"])[:, 0], atol=1e-5, rtol=1e-5)


def test_bf16_logits_within_tolerance_of_jax(ref, port):
    out, *_ = _rollout(
        ref, port, _prompt(3, 12, port.vocab_size), 6, jnp.bfloat16, torch.bfloat16
    )
    worst = max(float(np.abs(tl - jl).max()) for jl, tl in out)
    # bf16 rounds at other places in the two frameworks; the logits are
    # O(1) here, so 2e-2 is a few bf16 ulps (the dense model test's bound)
    assert worst <= 2e-2, worst


@pytest.mark.parametrize("n", [20, 37, 45])
def test_ragged_prefill_matches_jax_decode(ref, port, n):
    """At lengths the JAX prefill refuses (past one chunk of 16, no
    multiple of it): the port's prefill of all ``n`` tokens against the
    JAX model prefilling the first 16 and decoding the rest one token at a
    time, f32, logits within 1e-4 and the state within 1e-5."""
    _, jmodel, jparams, tree = ref
    prompt = _prompt(n, n, port.vocab_size)
    with pytest.raises(AssertionError):
        jmodel.prefill(jparams, {"tokens": jnp.asarray([prompt], jnp.int32)},
                       _jax_cache(jmodel), dtype=jnp.float32)
    jl, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray([prompt[:16]], jnp.int32)},
        _jax_cache(jmodel), dtype=jnp.float32)
    for pos in range(16, n):
        jl, jcache = jmodel.decode_step(
            jparams, jnp.asarray([[prompt[pos]]], jnp.int32), jcache,
            jnp.asarray([pos], jnp.int32), dtype=jnp.float32)
    lm = MambaLM(port)
    params = params_from_jax(tree, port, device="cpu", dtype=torch.float32)
    cache = lm.init_cache(1, 64, "cpu")
    tl = lm.prefill(params, torch.tensor([prompt]), cache, 0, dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(cache.state[:, 0].numpy(),
                               np.asarray(jcache["layers"]["state"])[:, 0],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 17, 33, 40])
def test_prefill_then_decode_consistency(ref, port, n):
    """The cache hand-off inside the port, as ``tests/test_decode_consistency.py``
    holds the reference to it: the logits of ``prefill(n)`` equal those of
    ``prefill(n - k)`` followed by ``k`` decode steps, in f32 within 5e-5,
    at ragged lengths and at the short-window lengths 2 and 3."""
    *_, tree = ref
    lm = MambaLM(port)
    params = params_from_jax(tree, port, device="cpu", dtype=torch.float32)
    prompt = torch.tensor([_prompt(100 + n, n, port.vocab_size)])
    full = lm.prefill(params, prompt, lm.init_cache(1, 64, "cpu"), 0,
                      dtype=torch.float32)
    for k in (1, min(n - 1, 5)):
        cache = lm.init_cache(1, 64, "cpu")
        logits = lm.prefill(params, prompt[:, : n - k], cache, 0, dtype=torch.float32)
        for pos in range(n - k, n):
            logits = lm.decode_step(params, prompt[:, pos : pos + 1], cache,
                                    torch.tensor([pos]), dtype=torch.float32)
        err = float((logits - full).abs().max())
        assert err < 5e-5, (n, k, err)


def test_bridge_layout_and_dtypes(ref, port):
    *_, tree = ref
    p = params_from_jax(tree, port, device="cpu")
    mixer = p["layers"]["mixer"]
    conv_dim = port.d_inner + 2 * port.ssm_ngroups * port.ssm_state
    assert p["embed"].shape == (port.padded_vocab, port.d_model)
    assert mixer["wxBC"].shape == (port.n_layers, port.d_model, conv_dim)
    assert mixer["out_proj"].shape == (port.n_layers, port.d_inner, port.d_model)
    assert mixer["wz"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm"):
        assert mixer[name].dtype == torch.float32, name
    np.testing.assert_array_equal(mixer["conv_w"].numpy(),
                                  tree["layers"]["mixer"]["conv_w"])
    assert p["layers"]["ln"].dtype == torch.float32


def test_init_params_kinds_and_seed(port):
    a = init_params(port, 3, device="cpu")
    b = init_params(port, 3, device="cpu")
    m = a["layers"]["mixer"]
    assert torch.equal(m["wz"], b["layers"]["mixer"]["wz"])
    assert m["conv_w"].dtype == torch.float32
    assert abs(float(m["conv_w"].std()) - 0.5) < 0.05  # fan-in ssm_conv = 4
    assert torch.equal(m["A_log"], torch.ones_like(m["A_log"]))
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert torch.equal(m["dt_bias"], torch.zeros_like(m["dt_bias"]))
    assert torch.equal(m["conv_b"], torch.zeros_like(m["conv_b"]))


def test_configs_match_the_reference():
    fields = ("n_layers", "d_model", "vocab_size", "padded_vocab", "ssm_state",
              "ssm_conv", "ssm_expand", "ssm_head_dim", "ssm_ngroups", "ssm_chunk",
              "d_inner", "ssm_nheads", "norm_eps", "tie_embeddings", "family")
    for full in (False, True):
        j = jax_get_config(ARCH) if full else jax_get_config(ARCH).reduced()
        t = get_config(ARCH) if full else get_config(ARCH).reduced()
        for f in fields:
            assert getattr(t, f) == getattr(j, f), f
    full = get_config(ARCH)
    assert (full.d_inner, full.ssm_nheads, full.padded_vocab) == (5120, 80, 50_432)
    assert isinstance(build_model(full), MambaLM)
    with pytest.raises(ValueError, match="family"):
        build_model(full.replace(family="hybrid"))
