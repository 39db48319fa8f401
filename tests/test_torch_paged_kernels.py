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

from repro.kernels.decode_attention import paged_decode_attention as jax_paged
from repro.kernels.decode_attention import (
    quant_paged_decode_attention as jax_quant_paged,
)
from repro.kernels.decode_attention.quant import quantize_pages as jax_quantize_pages
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
