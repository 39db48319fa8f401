"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, over a shape grid at head_dim 128 (the only one the kernels are
built for): G in {1, 4, 8}, ragged tails, ``q_offset``, strided views,
lengths 1 and ``max_len``, the flash kernel's rows bit-equal between a
full and a suffix prefill, the bootstrap partials over more than 8
metrics (each column bit-equal to a call on it alone); and the paged
kernels over page sizes 8, 16 and 64 with aliased pages and padding
entries, the f32 one bit-equal to
the contiguous kernel on the same rows; and the SSD scan at Mamba2's
head_dim 64 and state 128 over G in {1, 2} and ragged lengths, its output
and final state against the plain chunked version and the sequential
oracle; BERTScore (kernel 7) over ragged token counts, widths 64 and 256,
the sentinel edges and batch invariance; and the bootstrap means (kernel 5)
at any replicate count.  The SSD scan and the int8 paged decode kernel
are also held at full width (mamba2-2.7b's 80 heads; phase 3's 16
sequences of 8 KV heads, G in {4, 8}): batch-invariant and repeatable bit
for bit, the int8 kernel bit-equal across page sizes over the same
values, and none of their device kernels spilling.  The f32 decode
kernels 2 and 3 (one span-split design) are held at the span's edge
lengths: a sequence alone against among 16, repeatable, independent of
the cache length beyond the sequence's, kernel 3 bit-equal to kernel 2 at
page sizes 8, 16 and 64, the span constant agreeing with the wrapper, and
no spill.  The bootstrap partials (kernel 6) are also held at the
default streaming chunk of 1,024 rows with seven metrics and past 64
tiles of 64 rows, and BERTScore (kernel 7) at width 1,024 with 512 tokens
a side and at width 37 (its 4-byte staging); both repeat bit for bit and
spill nowhere.  Every case carries the ``gpu``
marker and skips where there is no CUDA device.  The file imports no JAX,
so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.bertscore import bertscore, bertscore_pr, bertscore_ref
from repro_torch.kernels.bertscore.ref import f1_from_pr
from repro_torch.kernels.bootstrap import (
    bootstrap_means,
    bootstrap_means_ref,
    bootstrap_partials,
    bootstrap_partials_ref,
)
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
    quant_paged_decode_attention,
    quant_paged_decode_attention_ref,
    quantize_pages,
)
from repro_torch.kernels.decode_attention.decode_attention import SPAN
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.ssd import ssd, ssd_ref
from repro_torch.models.attention import cache_update
from repro_torch.models.ssm import ssd_chunked


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rowwise_ok(out, ref, rtol, row_frac):
    o, r = out.float(), ref.float()
    allow = rtol * r.abs() + row_frac * r.abs().amax(dim=-1, keepdim=True)
    return bool(torch.isfinite(o).all()) and bool(((o - r).abs() <= allow).all())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "h,kh,sq,sk,off,kv_view,suffix",
    [(4, 4, 37, 37, 0, False, 0), (32, 8, 100, 100, 0, False, 0),
     (32, 8, 64, 300, 236, False, 0), (8, 2, 1, 1, 0, False, 0),
     (8, 8, 129, 129, 0, False, 0), (32, 8, 5, 513, 508, False, 0),
     # Sq not a multiple of the 128-row tile, G = 8, K/V views of one
     # fused tensor, q_offset > 0
     (32, 4, 200, 200, 0, True, 0), (16, 2, 70, 330, 260, True, 0),
     (8, 8, 257, 257, 0, True, 0), (32, 8, 12, 12, 0, True, 0),
     # the last rows of a full prefill against a suffix prefill of them
     # after a prefix-cache hit (phase 3's 478 tokens, 464 shared): bit-equal
     (32, 8, 478, 478, 0, False, 14), (32, 4, 300, 300, 0, True, 45)],
)
def test_flash_kernel_matches_plain_version(cuda, h, kh, sq, sk, off, kv_view,
                                            suffix):
    d = 128
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    # q is a strided view, as in a fused projection
    q = torch.randn((2, sq, 2, h, d), generator=g, device=cuda).to(torch.bfloat16)
    q = q[:, :, 1]
    if kv_view:
        kv = torch.randn((2, sk, 2, kh, d), generator=g, device=cuda)
        k, v = kv.to(torch.bfloat16).unbind(2)
    else:
        k = torch.randn((2, sk, kh, d), generator=g, device=cuda).to(torch.bfloat16)
        v = torch.randn((2, sk, kh, d), generator=g, device=cuda).to(torch.bfloat16)
    got = flash_attention(q, k, v, q_offset=off)
    ref = flash_attention_ref(q, k, v, q_offset=off)
    # bf16 P (unnormalised) in the kernel vs normalised in the plain version
    assert _rowwise_ok(got, ref, 2**-7, 1e-2)
    if suffix:
        # a row's bits do not depend on its tile, on Sq or on q_offset
        tail = flash_attention(q[:, sq - suffix :], k, v,
                               q_offset=off + sq - suffix)
        assert torch.equal(tail, got[:, sq - suffix :])


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads", [1, 4, 8])
def test_decode_kernel_matches_plain_version(cuda, g_heads):
    s, kh, d = 512, 8 // max(1, g_heads // 4), 128
    # the old 32-row tile's edges, and the span's
    lens = torch.tensor([1, s, 31, 32, 33, 200, SPAN - 1, SPAN, SPAN + 1, 2 * SPAN,
                         2 * SPAN + 45], dtype=torch.int32, device=cuda)
    b = lens.numel()
    gen = torch.Generator(device=cuda).manual_seed(g_heads)
    q = torch.randn((b, 1, kh * g_heads, d), generator=gen, device=cuda)
    q = q.to(torch.bfloat16)
    kc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
    vc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
    got = decode_attention(q, kc, vc, lens)
    ref = decode_attention_ref(q, kc, vc, lens)
    assert _rowwise_ok(got, ref, 2**-7, 1e-3)
    # a result does not depend on the batch around it
    alone = decode_attention(q[2:3], kc[2:3], vc[2:3], lens[2:3])
    assert torch.equal(alone, got[2:3])


@pytest.mark.gpu
def test_decode_kernel_refuses_a_cache_that_is_not_f32(cuda):
    q = torch.randn((1, 1, 4, 128), device=cuda).to(torch.bfloat16)
    kc = torch.randn((1, 8, 1, 128), device=cuda).to(torch.bfloat16)
    with pytest.raises(TypeError):
        decode_attention(q, kc, kc, torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,m,start",
    [(1, 1, 0), (1000, 2, 5), (3000, 4, 2**32 - 1500), (2000, 13, 77),
     (1500, 8, 3), (700, 9, 0),
     # the default streaming chunk with phase 5's seven metrics; a main-path
     # chunk of 16 at its offset; past 64 tiles of 64 rows, where a row
     # block takes tiles k, k + 64, ..., with the counter wrapping
     (1024, 7, 0), (16, 2, 48), (10_000, 3, 2**32 - 5_000)],
)
def test_bootstrap_kernel_matches_plain_version(cuda, n, m, start):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.rand((n, m), generator=gen, device=cuda)
    x[::7, 0] = float("nan")
    bootstrap_partials.launches = 0
    got = bootstrap_partials(x, 11, start, n_boot=300)
    # one launch per group of at most 8 columns
    assert bootstrap_partials.launches == -(-m // 8)
    ref = bootstrap_partials_ref(x, 11, start, n_boot=300)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)  # same weights
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
    # a column's bits are those of a call on that column alone
    for j in range(m):
        alone = bootstrap_partials(x[:, j : j + 1].contiguous(), 11, start,
                                   n_boot=300)
        assert torch.equal(alone[0][:, 0], got[0][:, j])
        assert torch.equal(alone[1][:, 0], got[1][:, j])


@pytest.mark.gpu
def test_stale_slot_at_max_len_on_the_card(cuda):
    """A free slot whose stale position is max_len: its cache write is
    dropped (no store reaches index max_len) and decode attends over all
    max_len rows, as in the reference's masked select."""
    b, s, kh, d = 3, 64, 2, 128
    cache = torch.randn((b, s, kh, d), device=cuda)
    before = cache.clone()
    new = torch.randn((b, 1, kh, d), device=cuda)
    pos = torch.tensor([s, 5, s - 1], device=cuda)
    cache_update(cache, new, pos)
    torch.cuda.synchronize()
    assert torch.equal(cache[0], before[0])
    assert torch.equal(cache[1, 5], new[1, 0])
    assert torch.equal(cache[2, s - 1], new[2, 0])
    lens = (pos + 1).clamp(max=s).to(torch.int32)
    q = torch.randn((b, 1, kh * 4, d), device=cuda).to(torch.bfloat16)
    got = decode_attention(q, cache, cache, lens)
    assert _rowwise_ok(got, decode_attention_ref(q, cache, cache, lens), 2**-7, 1e-3)


def _paged_case(cuda, b, kh, g_heads, ps, n_p, seed):
    """q, an f32 pool with an aliased shared prefix, shuffled tables padded
    with 0 past each length, and lengths from 1 to nP * ps."""
    d = 128
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n_shared = n_p // 4
    n_pool = n_shared + b * n_p + 1
    q = torch.randn((b, 1, kh * g_heads, d), generator=gen, device=cuda)
    k = torch.randn((n_pool, ps, kh, d), generator=gen, device=cuda)
    v = torch.randn((n_pool, ps, kh, d), generator=gen, device=cuda)
    order = torch.randperm(n_pool - n_shared, generator=gen, device=cuda) + n_shared
    tables = order[: b * n_p].view(b, n_p).to(torch.int32)
    tables[:, :n_shared] = torch.arange(n_shared, device=cuda, dtype=torch.int32)
    s = n_p * ps
    lens = torch.tensor([1, s, ps, ps + 1, n_shared * ps, s - 1][:b],
                        dtype=torch.int32, device=cuda)
    n_used = (lens + ps - 1) // ps
    pad = torch.arange(n_p, device=cuda)[None, :] >= n_used[:, None]
    tables[pad] = 0
    return q.to(torch.bfloat16), k, v, tables, lens


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads", [1, 4])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_paged_kernel_matches_plain_and_is_bit_equal_to_contiguous(cuda, g_heads, ps):
    q, k, v, tables, lens = _paged_case(cuda, 6, 8 // g_heads * 2, g_heads, ps,
                                        256 // ps, ps + g_heads)
    got = paged_decode_attention(q, k, v, tables, lens)
    ref = paged_decode_attention_ref(q, k, v, tables, lens)
    assert _rowwise_ok(got, ref, 2**-7, 1e-3)
    # the same rows laid out contiguously: the contiguous kernel's bits
    kc = k[tables.long()].flatten(1, 2)
    vc = v[tables.long()].flatten(1, 2)
    assert torch.equal(got, decode_attention(q, kc, vc, lens))


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads", [1, 4])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_quant_paged_kernel_matches_plain_version(cuda, g_heads, ps):
    q, k, v, tables, lens = _paged_case(cuda, 6, 8 // g_heads * 2, g_heads, ps,
                                        256 // ps, 7 * ps + g_heads)
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    # both read the same int8 * scale rows in f32; only the sum order and
    # the final bf16 rounding differ
    got = quant_paged_decode_attention(q, kq, vq, ks, vs, tables, lens)
    ref = quant_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lens)
    assert _rowwise_ok(got, ref, 2**-7, 1e-3)
    b, kh = q.shape[0], k.shape[2]
    gen = torch.Generator(device=cuda).manual_seed(ps)
    k_new = torch.randn((b, kh, 128), generator=gen, device=cuda)
    v_new = torch.randn((b, kh, 128), generator=gen, device=cuda)
    new_pos = lens - 1
    new_pos[0] = lens[0]  # at the length: no row is replaced
    rows = (k_new, v_new, new_pos)
    got = quant_paged_decode_attention(q, kq, vq, ks, vs, tables, lens, rows)
    ref = quant_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lens, rows)
    assert _rowwise_ok(got, ref, 2**-7, 1e-3)


@pytest.mark.gpu
def test_paged_stale_slot_with_an_all_zero_table_at_max_len(cuda):
    """A free slot in the paged batcher: its table is all zeros (page 0 in
    every entry) and its length is max_len; it reads page 0 over and over
    and must agree with the plain version, beside a live slot."""
    b, kh, ps, n_p, d = 2, 8, 16, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(3)
    k = torch.randn((n_p + 2, ps, kh, d), generator=gen, device=cuda)
    v = torch.randn((n_p + 2, ps, kh, d), generator=gen, device=cuda)
    q = torch.randn((b, 1, kh * 4, d), generator=gen, device=cuda).to(torch.bfloat16)
    tables = torch.zeros((b, n_p), dtype=torch.int32, device=cuda)
    tables[1] = torch.arange(1, n_p + 1, dtype=torch.int32, device=cuda)
    lens = torch.tensor([n_p * ps, 37], dtype=torch.int32, device=cuda)
    got = paged_decode_attention(q, k, v, tables, lens)
    assert _rowwise_ok(got, paged_decode_attention_ref(q, k, v, tables, lens),
                       2**-7, 1e-3)
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    got = quant_paged_decode_attention(q, kq, vq, ks, vs, tables, lens)
    ref = quant_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lens)
    assert _rowwise_ok(got, ref, 2**-7, 1e-3)


def _ssd_case(cuda, b, slen, h, g, seed):
    """x, B and C as column views of one fused xBC row, as the model slices
    them (P = 64, N = 128); dt post-softplus; a in [-e, -1]."""
    p, n = 64, 128
    gen = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn((b, slen, h * p + 2 * g * n), generator=gen, device=cuda)
    xbc = xbc.to(torch.bfloat16)
    x = xbc[..., : h * p].unflatten(-1, (h, p))
    bm = xbc[..., h * p : h * p + g * n].unflatten(-1, (g, n))
    cm = xbc[..., h * p + g * n :].unflatten(-1, (g, n))
    dt = F.softplus(torch.randn((b, slen, h), generator=gen, device=cuda))
    a = -torch.exp(torch.rand((h,), generator=gen, device=cuda))
    return x, dt, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("slen", [1, 12, 256, 478, 1000])
def test_ssd_kernel_matches_plain_version(cuda, g, slen):
    """y within 2^-7 of the value plus 1e-3 of the row's largest (f32 on
    both sides until the bf16 rounding), the final state within 2^-10 plus
    1e-4 (f32 sums in other orders); against the chunked plain version and
    the sequential oracle; one sequence alone gives its bits in the batch."""
    args = _ssd_case(cuda, 2, slen, 8, g, slen + g)
    y, state = ssd(*args, chunk=256)
    for ry, rstate in (ssd_chunked(*args, 256), ssd_ref(*args)):
        assert _rowwise_ok(y, ry, 2**-7, 1e-3)
        assert _rowwise_ok(state, rstate, 2**-10, 1e-4)
    x, dt, a, bm, cm = args
    y1, state1 = ssd(x[1:], dt[1:], a, bm[1:], cm[1:], chunk=256)
    assert torch.equal(y1, y[1:]) and torch.equal(state1, state[1:])


@pytest.mark.gpu
def test_ssd_kernel_at_a_smaller_chunk_and_its_refusals(cuda):
    args = _ssd_case(cuda, 1, 200, 4, 1, 5)
    y, state = ssd(*args, chunk=64)  # three chunks and a ragged fourth
    ry, rstate = ssd_chunked(*args, 64)
    assert _rowwise_ok(y, ry, 2**-7, 1e-3)
    assert _rowwise_ok(state, rstate, 2**-10, 1e-4)
    x, dt, a, bm, cm = args
    with pytest.raises(ValueError):
        ssd(*args, chunk=512)
    with pytest.raises(TypeError):
        ssd(x.float(), dt, a, bm, cm)
    with pytest.raises(ValueError):
        ssd(x[..., :32], dt, a, bm, cm)  # head_dim 32


def _bert_case(cuda, b, lc, lr, d, seed):
    """Random embeddings with prefix masks of random length; the first
    four examples (where there are four) are the edges: an empty candidate,
    an empty reference, both empty, and one pair at cosine -0.995."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cand = torch.randn((b, lc, d), generator=g, device=cuda)
    ref = torch.randn((b, lr, d), generator=g, device=cuda)
    nc = torch.randint(1, lc + 1, (b,), generator=g, device=cuda)
    nr = torch.randint(1, lr + 1, (b,), generator=g, device=cuda)
    if b >= 4:
        nc[0], nr[1], nc[2], nr[2], nc[3], nr[3] = 0, 0, 0, 0, 1, 1
        cand[3, 0].zero_()
        ref[3, 0].zero_()
        cand[3, 0, 0] = 1.0
        ref[3, 0, 0], ref[3, 0, 1] = -0.995, (1 - 0.995**2) ** 0.5
    cm = (torch.arange(lc, device=cuda)[None, :] < nc[:, None]).float()
    rm = (torch.arange(lr, device=cuda)[None, :] < nr[:, None]).float()
    return cand, ref, cm, rm


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 256, 1024, 37])
@pytest.mark.parametrize("lc,lr", [(64, 64), (64, 37), (5, 64), (512, 512)])
@pytest.mark.parametrize("b", [1, 16, 1024])
def test_bertscore_kernel_matches_plain_version(cuda, b, lc, lr, d):
    """P and R within 1e-5 of the value plus 1e-6 (3xTF32 products, ~2^-21
    of the value each, scaled by the rows' inverse norms, against a
    normalised einsum); D = 37 takes the 4-byte staging; F1 is the epilogue on
    the kernel's P and R (ill-conditioned where p + r nears 0, so not held
    to the plain version's); the -1e30 sentinel and F1's -0.0 and ~2e9 at
    the edges, as the plain version gives."""
    args = _bert_case(cuda, b, lc, lr, d, b + lc + lr + d)
    before = bertscore_pr.launches
    got = bertscore(*args)
    assert bertscore_pr.launches == before + 1
    want = bertscore_ref(*args)
    for a, r in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[2], f1_from_pr(got[0], got[1]))
    if b >= 4:
        p, r, f1 = got
        assert float(r[0]) < -0.9e30 and f1[0] == 0 and torch.signbit(f1[0])
        assert float(p[1]) < -0.9e30 and torch.signbit(f1[1])
        assert (float(p[2]), float(r[2]), float(f1[2])) == (0.0, 0.0, 0.0)
        assert 1.9e9 < float(f1[3]) < 2.1e9


@pytest.mark.gpu
def test_bertscore_kernel_is_batch_invariant_and_takes_its_limits(cuda):
    """An example's P and R are the same bits alone as among 16; 512
    tokens a side and width 1,024 run, one more of either raises."""
    args = _bert_case(cuda, 16, 64, 37, 256, 3)
    p, r = bertscore_pr(*args)
    for i in (0, 5, 15):
        pi, ri = bertscore_pr(*(t[i:i + 1].contiguous() for t in args))
        assert torch.equal(pi, p[i:i + 1]) and torch.equal(ri, r[i:i + 1])
    big = _bert_case(cuda, 2, 512, 300, 1024, 4)
    for a, b in zip(bertscore_pr(*big), bertscore_ref(*big)[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for lc, lr, d in ((513, 8, 8), (8, 513, 8), (8, 8, 1025)):
        with pytest.raises(ValueError, match="takes"):
            bertscore_pr(*_bert_case(cuda, 1, lc, lr, d, 5))
    cand, ref, cm, rm = args
    with pytest.raises(TypeError):
        bertscore_pr(cand.double(), ref, cm, rm)
    with pytest.raises(ValueError, match="disagree"):
        bertscore_pr(cand, ref[:, :, :8].contiguous(), cm, rm)


@pytest.mark.gpu
def test_bootstrap_and_bertscore_kernels_repeat_and_do_not_spill(cuda):
    """Kernels 6 and 7: a second call gives the same bits (no atomics on
    values; the arrival counters are left at zero), and no instantiation
    spills to local memory (partials for 1..8 columns, BERTScore with 16-
    and 4-byte staging)."""
    import ctypes

    from repro_torch.kernels import _cuda

    gen = torch.Generator(device=cuda).manual_seed(4)
    for n, m in ((1024, 7), (16, 2), (10_000, 3)):
        x = torch.rand((n, m), generator=gen, device=cuda)
        x[::5, -1] = float("nan")
        first = bootstrap_partials(x, 3, 2**32 - 100, n_boot=1000)
        again = bootstrap_partials(x, 3, 2**32 - 100, n_boot=1000)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    for d in (256, 37):
        args = _bert_case(cuda, 64, 64, 37, d, 9)
        first, again = bertscore_pr(*args), bertscore_pr(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    lib = _cuda.library()
    for fn, whichs in (("repro_bootstrap_kernel_info", range(1, 9)),
                       ("repro_bertscore_kernel_info", range(2))):
        for which in whichs:
            vals = [ctypes.c_int() for _ in range(4)]
            assert getattr(lib, fn)(which, *(ctypes.byref(v) for v in vals)) == 0
            assert vals[1].value == 0 and vals[3].value >= 1, (fn, which)


@pytest.mark.gpu
@pytest.mark.parametrize("n_boot", [1, 1000, 1024])
@pytest.mark.parametrize("n", [1, 1000, 1025, 100_000])
def test_bootstrap_means_kernel_matches_plain_version(cuda, n, n_boot):
    """Identical weights, f32 sums in two fixed orders: 2e-6 of the value
    (a dropped 1,024-row tile moves a mean by W_T (mean - m_T) / sum w,
    ~1e-4 at n = 100,000); a NaN makes every mean NaN, as in the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(n + n_boot)
    x = torch.rand((n,), generator=gen, device=cuda)
    before = bootstrap_means.launches
    got = bootstrap_means(x, 21, n_boot=n_boot)
    assert bootstrap_means.launches == before + 1
    torch.testing.assert_close(got, bootstrap_means_ref(x, n_boot, 21),
                               rtol=2e-6, atol=0)
    x[n // 2] = float("nan")
    assert torch.isnan(bootstrap_means(x, 21, n_boot=n_boot)).all()
    assert torch.isnan(bootstrap_means_ref(x, n_boot, 21)).all()


# -- the redesigned SSD (kernel 8) and int8 paged decode (kernel 4) ------------


def _full_ssd(cuda, b, slen, seed):
    """mamba2-2.7b's SSD geometry (80 heads of 64, state 128, one group)."""
    return _ssd_case(cuda, b, slen, 80, 1, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("slen", [12, 478, 2048])
def test_ssd_kernel_at_full_width_is_batch_invariant_and_repeatable(cuda, slen):
    """At ``chip_smoke.py``'s shapes: y and the final state within the
    gates of the plain chunked version (y 2^-7 of the value plus 1e-3 of
    the row's largest, state 2^-10 plus 1e-4); a sequence alone gives the
    bits it gives in a batch of 16; a second call gives the same bits (no
    atomics, fixed sums)."""
    x, dt, a, bm, cm = _full_ssd(cuda, 16 if slen < 2048 else 4, slen, 7 + slen)
    y, state = ssd(x, dt, a, bm, cm, chunk=256)
    ry, rstate = ssd_chunked(x[:2], dt[:2], a, bm[:2], cm[:2], 256)
    assert _rowwise_ok(y[:2], ry, 2**-7, 1e-3)
    assert _rowwise_ok(state[:2], rstate, 2**-10, 1e-4)
    y1, s1 = ssd(x[3:4], dt[3:4], a, bm[3:4], cm[3:4], chunk=256)
    assert torch.equal(y1, y[3:4]) and torch.equal(s1, state[3:4])
    y2, s2 = ssd(x, dt, a, bm, cm, chunk=256)
    assert torch.equal(y2, y) and torch.equal(s2, state)


@pytest.mark.gpu
def test_ssd_kernel_counts_one_launch_a_call_and_reports_no_spills(cuda):
    """A call runs three device kernels and counts one launch; none of the
    three spills to local memory."""
    import ctypes

    from repro_torch.kernels import _cuda

    before = ssd.launches
    ssd(*_full_ssd(cuda, 1, 300, 1))
    assert ssd.launches == before + 1
    for which in range(3):
        vals = [ctypes.c_int() for _ in range(4)]
        assert _cuda.library().repro_ssd_kernel_info(
            which, *(ctypes.byref(v) for v in vals)) == 0
        assert vals[1].value == 0 and vals[3].value >= 1


def _quant_full(cuda, lens, ps, g_heads=4, seed=0):
    """Phase 3's int8 geometry (8 KV heads of 128) over ``lens``: K/V
    positions drawn once and laid into a pool of ``ps``-row pages under
    shuffled page ids, one scale per KV head for every page, so the values
    a position reads do not depend on the page size."""
    kh, d = 8, 128
    b, s = len(lens), max(lens)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, 1, kh * g_heads, d), generator=gen, device=cuda)
    kv = torch.randint(-127, 128, (2, b, s, kh, d), generator=gen, device=cuda)
    scales = torch.rand((2, kh), generator=gen, device=cuda) / 64
    k_new = torch.randn((b, kh, d), generator=gen, device=cuda)
    v_new = torch.randn((b, kh, d), generator=gen, device=cuda)
    n_p = -(-s // ps)
    kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, n_p * ps - s))
    pages = kv.reshape(2, b * n_p, ps, kh, d).to(torch.int8)
    order = torch.randperm(b * n_p, generator=gen, device=cuda)
    pool = torch.empty((2, b * n_p + 1, ps, kh, d), dtype=torch.int8, device=cuda)
    pool[:, order + 1] = pages
    pool[:, 0] = 0
    tables = (order + 1).view(b, n_p).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    used = (lens_t + ps - 1) // ps
    tables[torch.arange(n_p, device=cuda)[None, :] >= used[:, None]] = 0
    sc = scales[:, None, :].expand(2, b * n_p + 1, kh).contiguous()
    return (q.to(torch.bfloat16), pool[0], pool[1], sc[0], sc[1], tables, lens_t,
            (k_new, v_new, lens_t - 1))


#: 16 sequences at phase 3's main-path lengths, and ragged ones around the span
MAIN_LENS = [479 + 2 * i for i in range(16)]
RAGGED_LENS = [1, 127, 128, 129, 256, 300, 1024, 5, 640, 641, 17, 999, 384, 2, 700, 128]


@pytest.mark.gpu
@pytest.mark.parametrize("lens", [MAIN_LENS, RAGGED_LENS], ids=["main", "ragged"])
@pytest.mark.parametrize("g_heads", [4, 8])
def test_quant_paged_kernel_full_width_invariances(cuda, lens, g_heads):
    """Against the plain version (2^-7 of the value plus 1e-3 of the row's
    largest) with and without fresh rows; a sequence alone gives the bits
    it gives among 16 of other lengths; page sizes 8, 16 and 64 over the
    same positions' values give the same bits; a second call gives the
    same bits."""
    outs = []
    for ps in (8, 16, 64):
        args = _quant_full(cuda, lens, ps, g_heads)
        q, kq, vq, ks, vs, tables, ln, rows = args
        got = quant_paged_decode_attention(*args)
        ref = quant_paged_decode_attention_ref(*args)
        assert _rowwise_ok(got, ref, 2**-7, 1e-3)
        plain = quant_paged_decode_attention(*args[:7])
        assert _rowwise_ok(plain, quant_paged_decode_attention_ref(*args[:7]),
                           2**-7, 1e-3)
        i = 5
        alone = quant_paged_decode_attention(
            q[i:i + 1], kq, vq, ks, vs, tables[i:i + 1].contiguous(), ln[i:i + 1],
            tuple(t[i:i + 1].contiguous() for t in rows))
        assert torch.equal(alone, got[i:i + 1])
        assert torch.equal(quant_paged_decode_attention(*args), got)
        outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.gpu
def test_quant_paged_kernel_span_and_limits(cuda):
    """The span the CUDA source is built with is the wrapper's (its
    scratch size); a call counts one launch; no kernel of the three
    spills."""
    import ctypes

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.decode_attention.paged_quant import SPAN

    lib = _cuda.library()
    assert lib.repro_quant_paged_span() == SPAN
    before = quant_paged_decode_attention.launches
    quant_paged_decode_attention(*_quant_full(cuda, [300, 1], 16))
    assert quant_paged_decode_attention.launches == before + 1
    for which in range(3):
        vals = [ctypes.c_int() for _ in range(4)]
        assert lib.repro_quant_paged_kernel_info(
            which, *(ctypes.byref(v) for v in vals)) == 0
        assert vals[1].value == 0 and vals[3].value >= 1


# -- the redesigned f32 decode kernels 2 and 3 (one span split) ---------------------


def _f32_full(cuda, lens, g_heads, s, seed):
    """q and a contiguous f32 cache of ``s`` rows at full width (8 KV heads
    of 128; 4 at G = 8) over ``lens``."""
    kh, d, b = 8 if g_heads < 8 else 4, 128, len(lens)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, 1, kh * g_heads, d), generator=gen, device=cuda)
    kc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
    vc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
    return (q.to(torch.bfloat16), kc, vc,
            torch.tensor(lens, dtype=torch.int32, device=cuda))


def _paged_from(cuda, kc, vc, lens, ps, seed):
    """The cache's rows laid into a pool of ``ps``-row pages under shuffled
    page ids (page 0 the padding target), tables padded with 0."""
    b, s = kc.shape[:2]
    n_p = -(-s // ps)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    order = torch.randperm(b * n_p, generator=gen, device=cuda) + 1
    pools = []
    for t in (kc, vc):
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n_p * ps - s))
        pool = torch.zeros((b * n_p + 1, ps, *t.shape[2:]), device=cuda)
        pool[order] = t.reshape(b * n_p, ps, *t.shape[2:])
        pools.append(pool)
    tables = order.view(b, n_p).to(torch.int32)
    used = (lens + ps - 1) // ps
    tables[torch.arange(n_p, device=cuda)[None, :] >= used[:, None]] = 0
    return pools[0], pools[1], tables


#: the span's edges, S, and ragged lengths: 16 sequences
F32_LENS = [1, SPAN - 1, SPAN, SPAN + 1, 2 * SPAN, 2 * SPAN + 45, 512,
            5, 17, 300, 400, 64, 200, 33, 511, 384]


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads", [1, 4, 8])
def test_f32_decode_kernels_full_width_invariances(cuda, g_heads):
    """Kernels 2 and 3 at S = 512 over the span's edge lengths: within the
    plain version's gate (2^-7 of the value plus 1e-3 of the row's
    largest); a sequence alone gives the bits it gives among 16; a second
    call gives the same bits; a cache of 1,024 rows holding the same first
    512 gives the same bits (nothing depends on S beyond the length); and
    kernel 3 over the same rows in pages of 8, 16 and 64 gives kernel 2's
    bits, alone and among 16, and with tables of twice the entries."""
    s = 512
    q, kc, vc, lens = _f32_full(cuda, F32_LENS, g_heads, 2 * s, 11 + g_heads)
    kc5, vc5 = kc[:, :s].contiguous(), vc[:, :s].contiguous()
    got = decode_attention(q, kc5, vc5, lens)
    assert _rowwise_ok(got, decode_attention_ref(q, kc5, vc5, lens), 2**-7, 1e-3)
    assert torch.equal(decode_attention(q, kc5, vc5, lens), got)
    assert torch.equal(decode_attention(q, kc, vc, lens), got)
    assert torch.equal(decode_attention(q, kc[:, :s], vc[:, :s], lens), got)
    for i in (0, 5, 6, 9):
        alone = decode_attention(q[i:i + 1], kc5[i:i + 1], vc5[i:i + 1], lens[i:i + 1])
        assert torch.equal(alone, got[i:i + 1])
    for ps in (8, 16, 64):
        kp, vp, tables = _paged_from(cuda, kc5, vc5, lens, ps, ps)
        paged = paged_decode_attention(q, kp, vp, tables, lens)
        assert torch.equal(paged, got), ps
        assert torch.equal(paged_decode_attention(q, kp, vp, tables, lens), got)
        for i in (0, 5, 6):
            alone = paged_decode_attention(q[i:i + 1], kp, vp,
                                           tables[i:i + 1].contiguous(), lens[i:i + 1])
            assert torch.equal(alone, got[i:i + 1])
    # twice the table entries (nP * ps = 1,024) over the same positions
    assert torch.equal(paged_decode_attention(q, *_paged_from(cuda, kc, vc, lens, 16, 3),
                                              lens), got)


@pytest.mark.gpu
def test_f32_decode_kernels_span_and_limits(cuda):
    """The span the CUDA source is built with is the wrappers' (their
    scratch size); a call counts one launch, however many spans it has;
    none of the four split kernels (contiguous and paged, G <= 4 and
    G <= 8) spills."""
    import ctypes

    from repro_torch.kernels import _cuda

    lib = _cuda.library()
    assert lib.repro_decode_span() == SPAN
    q, kc, vc, lens = _f32_full(cuda, [300, 1], 4, 512, 2)
    before = (decode_attention.launches, paged_decode_attention.launches)
    decode_attention(q, kc, vc, lens)
    paged_decode_attention(q, *_paged_from(cuda, kc, vc, lens, 16, 1), lens)
    assert (decode_attention.launches, paged_decode_attention.launches) == (
        before[0] + 1, before[1] + 1)
    for which in range(4):
        vals = [ctypes.c_int() for _ in range(4)]
        assert lib.repro_decode_kernel_info(
            which, *(ctypes.byref(v) for v in vals)) == 0
        assert vals[1].value == 0 and vals[3].value >= 1
