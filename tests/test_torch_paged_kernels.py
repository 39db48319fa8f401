"""The plain versions of the port's paged decode kernels against the JAX
package's Pallas kernels, run in interpret mode as ``tests/test_kernels.py``
runs them, and against the JAX ``ref.py`` oracles, on the same numpy
inputs.  The port's pool is in the model layout (P, ps, K, d); the test
transposes it to the kernels' (P, K, ps, d).  The CUDA kernels are held
against these plain versions on the card (``tests/test_torch_kernels_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import paged_decode_attention as jax_paged
from repro.kernels.decode_attention import (
    quant_paged_decode_attention as jax_quant_paged,
)
from repro.kernels.decode_attention.quant import (
    dequantize_pages as jax_dequantize_pages,
)
from repro.kernels.decode_attention.quant import quantize_pages as jax_quantize_pages
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref,
)
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_ref,
)
from repro.kernels.decode_attention.ref import (
    quant_paged_decode_attention_ref as jax_quant_paged_ref,
)
from repro_torch.kernels.decode_attention import (
    dequantize_pages,
    paged_decode_attention_bshd,
    paged_decode_attention_ref,
    quant_paged_decode_attention_bshd,
    quant_paged_decode_attention_ref,
)
from repro_torch.kernels.decode_attention.decode_attention import SPAN as F32_SPAN
from repro_torch.kernels.decode_attention.decode_attention import workspace
from repro_torch.kernels.decode_attention.paged_quant import SPAN
from repro_torch.kernels.decode_attention.ref import gather_pages

#: f32 throughout: the same math summed in another order
TOL = 1e-5


def _case(rng, b, kh, g, n_p, ps, d):
    """q, a pool whose first n_p // 2 pages every sequence shares (aliased),
    shuffled private pages, tables padded with 0 past each length, and
    lengths 1, n_p * ps, a page boundary and ragged values."""
    n_shared = n_p // 2
    n_pool = n_shared + b * n_p
    q = rng.standard_normal((b, kh, g, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, kh, ps, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, kh, ps, d)).astype(np.float32)
    tables = (n_shared + rng.permutation(b * n_p)).reshape(b, n_p)
    tables[:, :n_shared] = np.arange(n_shared)
    s = n_p * ps
    lens = np.array([1, s, ps, 2 * ps + 3, s - 1, n_shared * ps + 1][:b], np.int32)
    used = -(-lens // ps)
    tables[np.arange(n_p)[None, :] >= used[:, None]] = 0  # padding entries
    return q, k, v, tables.astype(np.int32), lens


def _port(q, pool_kernel_layout):
    """(B, K, G, d) -> (B, 1, H, d); (P, K, ps, d) -> (P, ps, K, d)."""
    b, kh, g, d = q.shape
    pool = np.array(pool_kernel_layout)  # a writable copy
    return (torch.from_numpy(q).reshape(b, 1, kh * g, d),
            torch.from_numpy(pool).transpose(1, 2).contiguous())


def _back(out, q):
    return out.reshape(q.shape).numpy()


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_plain_matches_jax_kernel_and_oracle(g, ps):
    rng = np.random.default_rng(10 * g + ps)
    b, kh, n_p, d = 6, 2, 64 // ps, 32
    q, k, v, tables, lens = _case(rng, b, kh, g, n_p, ps, d)
    qt, kt = _port(q, k)
    _, vt = _port(q, v)
    ours = _back(paged_decode_attention_bshd(
        qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(lens)), q)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
            jnp.asarray(lens))
    for want in (jax_paged(*args, interpret=True), jax_paged_ref(*args)):
        np.testing.assert_allclose(ours, np.asarray(want), atol=TOL, rtol=TOL)


def _quant_case(rng, g, ps):
    b, kh, n_p, d = 6, 2, 64 // ps, 32
    q, k, v, tables, lens = _case(rng, b, kh, g, n_p, ps, d)
    kq, ks = jax_quantize_pages(jnp.asarray(k))
    vq, vs = jax_quantize_pages(jnp.asarray(v))
    return q, (kq, vq, ks, vs), tables, lens


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_quant_paged_plain_matches_jax_kernel_and_oracle(g, ps):
    rng = np.random.default_rng(100 + 10 * g + ps)
    q, (kq, vq, ks, vs), tables, lens = _quant_case(rng, g, ps)
    qt, kqt = _port(q, np.asarray(kq))
    _, vqt = _port(q, np.asarray(vq))
    ours = _back(quant_paged_decode_attention_bshd(
        qt, kqt, vqt, torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)),
        torch.from_numpy(tables), torch.from_numpy(lens)), q)
    args = (jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(tables), jnp.asarray(lens))
    for want in (jax_quant_paged(*args, interpret=True), jax_quant_paged_ref(*args)):
        np.testing.assert_allclose(ours, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("g", [1, 4])
def test_fresh_row_form_is_dequantize_overwrite_then_paged(g):
    """With the current token's rows, the int8 plain version equals: the
    whole pool dequantized, row ``new_pos`` of each sequence's pages
    overwritten, then the f32 paged plain version.  A ``new_pos`` at the
    length replaces nothing."""
    rng = np.random.default_rng(7 + g)
    q, (kq, vq, ks, vs), tables, lens = _quant_case(rng, g, 8)
    qt, kqt = _port(q, np.asarray(kq))
    _, vqt = _port(q, np.asarray(vq))
    kst, vst = torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs))
    b, kh, d = q.shape[0], q.shape[1], q.shape[3]
    k_new = torch.from_numpy(rng.standard_normal((b, kh, d)).astype(np.float32))
    v_new = torch.from_numpy(rng.standard_normal((b, kh, d)).astype(np.float32))
    tab, ln = torch.from_numpy(tables), torch.from_numpy(lens)
    new_pos = ln - 1
    new_pos[2] = ln[2]
    got = quant_paged_decode_attention_ref(
        qt, kqt, vqt, kst, vst, tab, ln, (k_new, v_new, new_pos))

    ps = kqt.shape[1]
    for i in range(b):
        kd, vd = dequantize_pages(kqt, kst), dequantize_pages(vqt, vst)
        if new_pos[i] < ln[i]:
            page = tab[i, new_pos[i] // ps]
            kd[page, new_pos[i] % ps] = k_new[i]
            vd[page, new_pos[i] % ps] = v_new[i]
        # a whole batch per sequence: an overwrite of a shared page (row 0
        # of sequence 0) must not reach the others
        want = paged_decode_attention_ref(qt, kd, vd, tab, ln)
        assert torch.equal(got[i], want[i]), i
    unchanged = quant_paged_decode_attention_ref(qt, kqt, vqt, kst, vst, tab, ln)
    assert torch.equal(got[2], unchanged[2])
    assert not torch.equal(got[1], unchanged[1])


def _span_split_combine(q, k, v, lens, tables=None, scales=None, new_rows=None,
                        span=SPAN):
    """Test-only mirror of the CUDA span split in f32: the f32 kernels'
    (``csrc/split_decode.cuh``, over a contiguous cache or an f32 pool) and
    the int8 kernel's (``csrc/quant_paged_decode_attention.cu``).  Per
    (sequence, KV head) the positions in spans of ``span``; a span's rows
    read from the contiguous cache (B, S, K, d) where ``tables`` is None,
    else looked up through the table in the pool (P, ps, K, d); its scores
    q . k (times k_scale (q . k_int) for int8 pages, ``scales = (ks, vs)``;
    the fresh row's from ``k_new``), its max m, sum of exps l and
    unnormalised P V (V dequantized for int8, the fresh row's from
    ``v_new``); then the spans combined in order, sum_s acc_s e^(m_s - M)
    / sum_s l_s e^(m_s - M).  Port layouts: q (B, 1, H, d)."""
    b, _, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    limit = k.shape[1] if tables is None else tables.shape[1] * k.shape[1]
    out = torch.zeros((b, 1, h, d))
    for i in range(b):
        n = min(int(lens[i]), limit)
        for kk in range(kh):
            qg = q[i, 0, kk * g:(kk + 1) * g].float()
            parts = []
            for p0 in range(0, n, span):
                pos = torch.arange(p0, min(p0 + span, n))
                if tables is None:
                    kf, vf = k[i, pos, kk].float(), v[i, pos, kk].float()
                    s = qg @ kf.T
                else:
                    ps = k.shape[1]
                    page, row = tables[i, pos // ps].long(), pos % ps
                    kf, vf = k[page, row, kk].float(), v[page, row, kk].float()
                    s = qg @ kf.T
                    if scales is not None:
                        s = s * scales[0][page, kk]
                        vf = vf * scales[1][page, kk][:, None]
                s = s * d**-0.5
                if new_rows is not None and p0 <= int(new_rows[2][i]) < p0 + len(pos):
                    f = int(new_rows[2][i]) - p0
                    s[:, f] = (qg @ new_rows[0][i, kk]) * d**-0.5
                    vf[f] = new_rows[1][i, kk]
                m = s.max(dim=1, keepdim=True).values
                pe = torch.exp(s - m)
                parts.append((m, pe.sum(dim=1, keepdim=True), pe @ vf))
            big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            l_tot = sum(l * torch.exp(m - big_m) for m, l, _ in parts)
            acc = sum(a * torch.exp(m - big_m) for m, _, a in parts)
            out[i, 0, kk * g:(kk + 1) * g] = acc / l_tot
    return out


def _span_case(rng, g, ps, lens, quantize=True):
    """q and a pool with the first pages shared by every sequence, tables
    padded with 0, at the given lengths; d = 32, 2 KV heads.  The pool is
    quantized to int8 pages and scales, or (``quantize=False``) left f32."""
    b, kh, d = len(lens), 2, 32
    n_p = -(-max(lens) // ps)
    n_shared = n_p // 2
    n_pool = n_shared + b * n_p
    q = rng.standard_normal((b, kh, g, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, kh, ps, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, kh, ps, d)).astype(np.float32)
    tables = (n_shared + rng.permutation(b * n_p)).reshape(b, n_p)
    tables[:, :n_shared] = np.arange(n_shared)
    lens = np.array(lens, np.int32)
    tables[np.arange(n_p)[None, :] >= -(-lens // ps)[:, None]] = 0
    if not quantize:
        return q, (k, v), tables.astype(np.int32), lens
    kq, ks = jax_quantize_pages(jnp.asarray(k))
    vq, vs = jax_quantize_pages(jnp.asarray(v))
    return q, (kq, vq, ks, vs), tables.astype(np.int32), lens


#: lengths around the span: one position, exactly one span, one past it,
#: exactly two spans, and a ragged third span
SPAN_LENS = [1, SPAN, SPAN + 1, 2 * SPAN, 2 * SPAN + 45, SPAN - 1]


#: 16 and 32: span boundaries on page boundaries (a span across several
#: pages); 48 and 256: span boundaries inside a page
SPAN_PAGE_SIZES = [16, 32, 48, 256]


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ps", SPAN_PAGE_SIZES)
def test_span_split_matches_jax_quant_kernel_and_oracle(g, ps):
    """The CUDA int8 kernel's algorithm, spans of ``SPAN`` positions each
    reduced alone then combined in span order, against the JAX Pallas
    kernel in interpret mode and its oracle on the same int8 pages, f32,
    within 1e-5 (the same products summed in another order)."""
    rng = np.random.default_rng(300 + 10 * g + ps)
    q, (kq, vq, ks, vs), tables, lens = _span_case(rng, g, ps, SPAN_LENS)
    qt, kqt = _port(q, np.asarray(kq))
    _, vqt = _port(q, np.asarray(vq))
    ours = _back(_span_split_combine(
        qt, kqt, vqt, torch.from_numpy(lens), torch.from_numpy(tables),
        (torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)))), q)
    args = (jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(tables), jnp.asarray(lens))
    for want in (jax_quant_paged(*args, interpret=True), jax_quant_paged_ref(*args)):
        np.testing.assert_allclose(ours, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("ps", [16, 48])
def test_span_split_fresh_row_on_a_span_boundary(ps):
    """The current token's rows on a span's first and last position (and
    at the length, where they replace nothing): the mirror against JAX's
    f32 paged oracle over the dequantized pool with those rows written in,
    f32 within 1e-5, and against the port's plain int8 version."""
    rng = np.random.default_rng(400 + ps)
    lens = [SPAN + 1, 2 * SPAN, SPAN + 7, SPAN]
    q, (kq, vq, ks, vs), tables, lens = _span_case(rng, 4, ps, lens)
    qt, kqt = _port(q, np.asarray(kq))
    _, vqt = _port(q, np.asarray(vq))
    kst, vst = torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs))
    tab, ln = torch.from_numpy(tables), torch.from_numpy(lens)
    b, kh, _, d = q.shape
    k_new = torch.from_numpy(rng.standard_normal((b, kh, d)).astype(np.float32))
    v_new = torch.from_numpy(rng.standard_normal((b, kh, d)).astype(np.float32))
    # first row of span 1, last row of span 1, last row of span 0, none
    new_pos = torch.tensor([SPAN, 2 * SPAN - 1, SPAN - 1, SPAN], dtype=torch.int32)
    rows = (k_new, v_new, new_pos)
    ours = _span_split_combine(qt, kqt, vqt, ln, tab, (kst, vst), rows)
    np.testing.assert_allclose(
        ours.numpy(), quant_paged_decode_attention_ref(qt, kqt, vqt, kst, vst, tab,
                                                       ln, rows).numpy(),
        atol=TOL, rtol=TOL)
    kd = np.array(jax_dequantize_pages(kq, ks))  # (P, K, ps, d)
    vd = np.array(jax_dequantize_pages(vq, vs))
    want = []
    for i in range(b):  # one sequence at a time: its rows must not reach others
        kdi, vdi = kd.copy(), vd.copy()
        if new_pos[i] < ln[i]:
            page, r = tables[i, new_pos[i] // ps], int(new_pos[i]) % ps
            kdi[page, :, r] = k_new[i].numpy()
            vdi[page, :, r] = v_new[i].numpy()
        want.append(np.asarray(jax_paged_ref(
            jnp.asarray(q[i:i + 1]), jnp.asarray(kdi), jnp.asarray(vdi),
            jnp.asarray(tables[i:i + 1]), jnp.asarray(lens[i:i + 1])))[0])
    np.testing.assert_allclose(_back(ours, q), np.stack(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ps", SPAN_PAGE_SIZES)
def test_span_split_f32_matches_jax_kernels_and_oracles(g, ps):
    """Kernels 2 and 3's algorithm (``csrc/split_decode.cuh``: spans of
    the f32 kernels' ``SPAN`` positions, each reduced alone, then combined
    in span order) over an f32 pool with aliased pages, read through the
    tables, and over the same rows gathered into a contiguous cache: the
    two forms give the same bits (the CUDA kernels differ only in a row's
    address); the paged form against the Pallas ``paged_decode_attention``
    in interpret mode and its oracle, the contiguous form against the
    Pallas ``decode_attention`` in interpret mode and its oracle, f32
    within 1e-5 (the same products summed in another order)."""
    rng = np.random.default_rng(500 + 10 * g + ps)
    q, (k, v), tables, lens = _span_case(rng, g, ps, SPAN_LENS, quantize=False)
    qt, kt = _port(q, k)
    _, vt = _port(q, v)
    tab, ln = torch.from_numpy(tables), torch.from_numpy(lens)
    paged = _span_split_combine(qt, kt, vt, ln, tab, span=F32_SPAN)
    kc, vc = gather_pages(kt, tab), gather_pages(vt, tab)  # (B, nP * ps, K, d)
    contiguous = _span_split_combine(qt, kc, vc, ln, span=F32_SPAN)
    assert torch.equal(paged, contiguous)
    ours = _back(paged, q)
    qj, lj = jnp.asarray(q), jnp.asarray(lens)
    args = (qj, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), lj)
    for want in (jax_paged(*args, interpret=True), jax_paged_ref(*args)):
        np.testing.assert_allclose(ours, np.asarray(want), atol=TOL, rtol=TOL)
    # the kernels' cache layout (B, K, S, d)
    kj, vj = (jnp.asarray(t.transpose(1, 2).numpy()) for t in (kc, vc))
    for want in (jax_decode(qj, kj, vj, lj, interpret=True),
                 jax_decode_ref(qj, kj, vj, lj)):
        np.testing.assert_allclose(ours, np.asarray(want), atol=TOL, rtol=TOL)


def test_f32_decode_workspace_grows_and_keeps_its_counters():
    """The f32 decode kernels' scratch: (B, K, ceil(S / SPAN), G) partials
    of d + 2 floats and B * K arrival counters, one workspace per (device,
    stream), grown to the largest call, its counters zero when allocated
    (the kernels leave them zero), reused while big enough."""
    q = torch.zeros((2, 1, 8, 16))  # B = 2, H = 8, d = 16
    first = workspace(q, -7, 3 * F32_SPAN, 2)
    assert first[0].numel() == 2 * 8 * 3 * 18 and first[0].dtype == torch.float32
    assert first[1].numel() == 4 and not first[1].any()
    assert all(a is b for a, b in zip(workspace(q, -7, 1, 2), first))
    grown = workspace(torch.zeros((5, 1, 8, 16)), -7, 1, 4)
    assert grown[0].numel() == first[0].numel()  # 5 * 8 * 1 * 18 fits
    assert grown[1].numel() == 20 and not grown[1].any()
    assert workspace(q, -8, 1, 1)[0] is not grown[0]
