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
spill nowhere.  The widened parts are held too: kernel 1 at head_dim 112
(zamba2's G = 1, both warpgroup launches, the suffix bit-equality),
kernel 2 at head_dim 112, kernel 8 at state 64 (zamba2's 112 heads), and
kernels 1-4 at qwen2.5-32b's G = 5 (40 query heads over 8 KV heads), with
the refusals of widths no kernel is built for; kernel 1 at MLA's widths
(Q and K of 96, V of 64: minicpm3-4b's 40 heads, both warpgroup launches,
the suffix bit-equality, V as a view of the decompressed K/V), and kernel
7 past its old 512-token limit (1,024 tokens a side, whole empty 64-row
tiles; any width) up to the card's shared memory; kernel 1 at whisper's
(64, 64), causal and not (the encoder's 1,500 frames, the cross prefill's
12 queries over them), and kernel 2 at head_dim 64 over the cross cache
(every length 1,500) and at ragged lengths, with a width no kernel is
built for refused by the wrapper and by the C entry; kernel 1 at
paligemma's d = 256 (G = 8, 64-key tiles) with and without the prefix-LM
mask, ``prefix_len=0`` bit-equal to the call without it at every width,
and kernel 2 at d = 256 over phase 15's lengths.  Every case carries the ``gpu``
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


def _ssd_case(cuda, b, slen, h, g, seed, n=128):
    """x, B and C as column views of one fused xBC row, as the model slices
    them (P = 64, N = ``n``); dt post-softplus; a in [-e, -1]."""
    p = 64
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
    tokens a side and width 1,024 run, and so do 513 tokens, width 1,025
    and the most tokens the card's opt-in shared memory holds; one token
    more raises."""
    from repro_torch.kernels.bertscore.bertscore import device_smem_optin, max_tokens

    args = _bert_case(cuda, 16, 64, 37, 256, 3)
    p, r = bertscore_pr(*args)
    for i in (0, 5, 15):
        pi, ri = bertscore_pr(*(t[i:i + 1].contiguous() for t in args))
        assert torch.equal(pi, p[i:i + 1]) and torch.equal(ri, r[i:i + 1])
    most = max_tokens(device_smem_optin(torch.cuda.current_device()))
    for lc, lr, d in ((512, 300, 1024), (513, 8, 8), (8, 513, 8), (8, 8, 1025),
                      (most - 5000, 5000, 8)):
        big = _bert_case(cuda, 2, lc, lr, d, 4)
        for a, b in zip(bertscore_pr(*big), bertscore_ref(*big)[:2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="takes"):
        bertscore_pr(*_bert_case(cuda, 1, most - 5000 + 1, 5000, 8, 5))
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


# -- the widened parts: head_dim 112, state 64, G = 5 ---------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,sq,sk,off,suffix", [
    (32, 32, 12, 12, 0, 0), (32, 32, 478, 478, 0, 14), (32, 32, 64, 64, 0, 0),
    (32, 32, 65, 65, 0, 0), (4, 2, 130, 300, 170, 0), (40, 8, 478, 478, 0, 14)])
def test_flash_kernel_at_head_dim_112(cuda, h, kh, sq, sk, off, suffix):
    """zamba2's width through both warpgroup launches, the K/V views of a
    fused projection as the model slices them, and a suffix's rows
    bit-equal to the full prefill's."""
    d = 112
    g = torch.Generator(device=cuda).manual_seed(sq + h)
    q = torch.randn((1, sq, h, d), generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn((1, sk, 2, kh, d), generator=g, device=cuda)
    k, v = kv.to(torch.bfloat16).unbind(2)
    got = flash_attention(q, k, v, q_offset=off)
    assert got.shape == q.shape
    assert _rowwise_ok(got, flash_attention_ref(q, k, v, q_offset=off), 2**-7, 1e-2)
    if suffix:
        tail = flash_attention(q[:, sq - suffix:], k, v, q_offset=off + sq - suffix)
        assert torch.equal(tail, got[:, sq - suffix:])


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads,kh", [(1, 32), (4, 2), (8, 1)])
def test_decode_kernel_at_head_dim_112(cuda, g_heads, kh):
    """Lengths at the span's edges, over a cache of 512 rows of 112; a
    sequence alone gives its bits among the rest; a repeat the same bits."""
    s, d = 512, 112
    lens = torch.tensor([1, s, 11, 45, SPAN - 1, SPAN, SPAN + 1, 2 * SPAN + 45, 479,
                         509], dtype=torch.int32, device=cuda)
    b = lens.numel()
    gen = torch.Generator(device=cuda).manual_seed(100 + g_heads)
    q = torch.randn((b, 1, kh * g_heads, d), generator=gen, device=cuda)
    q = q.to(torch.bfloat16)
    kc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
    vc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
    got = decode_attention(q, kc, vc, lens)
    assert _rowwise_ok(got, decode_attention_ref(q, kc, vc, lens), 2**-7, 1e-3)
    assert torch.equal(decode_attention(q, kc, vc, lens), got)
    for i in (0, 4, 7):
        alone = decode_attention(q[i:i + 1], kc[i:i + 1], vc[i:i + 1], lens[i:i + 1])
        assert torch.equal(alone, got[i:i + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("slen", [1, 12, 256, 478, 1000])
def test_ssd_kernel_at_state_64(cuda, g, slen):
    """The gates of the state-128 rows at zamba2's state of 64."""
    args = _ssd_case(cuda, 2, slen, 8, g, 50 + slen + g, n=64)
    y, state = ssd(*args, chunk=256)
    assert state.shape == (2, 8, 64, 64)
    for ry, rstate in (ssd_chunked(*args, 256), ssd_ref(*args)):
        assert _rowwise_ok(y, ry, 2**-7, 1e-3)
        assert _rowwise_ok(state, rstate, 2**-10, 1e-4)
    x, dt, a, bm, cm = args
    y1, state1 = ssd(x[1:], dt[1:], a, bm[1:], cm[1:], chunk=256)
    assert torch.equal(y1, y[1:]) and torch.equal(state1, state[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("slen", [12, 478])
def test_ssd_kernel_at_zamba2_width(cuda, slen):
    """zamba2-7b's scan (112 heads of 64, one group, state 64) at the
    shapes ``chip_smoke.py`` holds: within the gates, repeatable."""
    x, dt, a, bm, cm = _ssd_case(cuda, 2, slen, 112, 1, 9 + slen, n=64)
    y, state = ssd(x, dt, a, bm, cm, chunk=256)
    ry, rstate = ssd_chunked(x, dt, a, bm, cm, 256)
    assert _rowwise_ok(y, ry, 2**-7, 1e-3)
    assert _rowwise_ok(state, rstate, 2**-10, 1e-4)
    y2, s2 = ssd(x, dt, a, bm, cm, chunk=256)
    assert torch.equal(y2, y) and torch.equal(s2, state)


@pytest.mark.gpu
def test_g5_decode_kernels(cuda):
    """qwen2.5-32b's G = 5 (40 query heads over 8 KV heads) through the GM = 8
    instantiations: kernel 2 against its plain version, kernel 3 bit-equal
    to it, kernel 4 against its plain version."""
    q, kc, vc, lens = _f32_full(cuda, F32_LENS, 5, 512, 55)
    got = decode_attention(q, kc, vc, lens)
    assert _rowwise_ok(got, decode_attention_ref(q, kc, vc, lens), 2**-7, 1e-3)
    kp, vp, tables = _paged_from(cuda, kc, vc, lens, 16, 5)
    paged = paged_decode_attention(q, kp, vp, tables, lens)
    assert torch.equal(paged, got)
    qargs = _quant_full(cuda, MAIN_LENS, 16, g_heads=5, seed=5)
    got = quant_paged_decode_attention(*qargs)
    assert _rowwise_ok(got, quant_paged_decode_attention_ref(*qargs), 2**-7, 1e-3)


@pytest.mark.gpu
def test_widened_kernels_refuse_other_widths_and_do_not_spill(cuda):
    """Widths no kernel is built for raise; the paged kernels stay at 128;
    the d = 112 and N = 64 instantiations spill nowhere."""
    import ctypes

    from repro_torch.kernels import _cuda

    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    for d in (96, 80):
        q = torch.randn((1, 4, 2, d), device=cuda).to(torch.bfloat16)
        with pytest.raises(ValueError):
            flash_attention(q, q, q)
        with pytest.raises(ValueError):
            decode_attention(q[:, :1], q.float(), q.float(), lens)
    q = torch.randn((1, 1, 2, 112), device=cuda).to(torch.bfloat16)
    pool = torch.zeros((2, 16, 2, 112), device=cuda)
    table = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, pool, table, lens)
    with pytest.raises(ValueError):
        ssd(*_ssd_case(cuda, 1, 12, 4, 1, 0, n=32))
    lib = _cuda.library()
    for fn, which in (("repro_flash_kernel_info", (3, 4)),
                      ("repro_decode_kernel_info", (4, 5)),
                      ("repro_ssd_kernel_info", (3, 4, 5))):
        for w in which:
            vals = [ctypes.c_int() for _ in range(4)]
            assert getattr(lib, fn)(w, *(ctypes.byref(v) for v in vals)) == 0
            assert vals[1].value == 0 and vals[3].value >= 1, (fn, w)


# -- MLA's widths (kernel 1) and BERTScore past 512 tokens (kernel 7) ------------


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,off,suffix", [
    (12, 12, 0, 0), (478, 478, 0, 14), (64, 64, 0, 0), (65, 65, 0, 0),
    (130, 300, 170, 0), (1, 1, 0, 0)])
def test_flash_kernel_at_mla_widths(cuda, sq, sk, off, suffix):
    """minicpm3-4b's decompressed heads (40 / 40, Q and K of 96, V of 64)
    through both warpgroup launches: V a view of the decompressed (nope +
    v) rows and K the concatenation the model builds; (B, Sq, H, 64) out,
    within the gate; a suffix's rows bit-equal to the full prefill's."""
    h, nope, rope, dv = 40, 64, 32, 64
    g = torch.Generator(device=cuda).manual_seed(sq + 96)
    q = torch.randn((1, sq, h, nope + rope), generator=g, device=cuda)
    q = q.to(torch.bfloat16)
    kv = torch.randn((1, sk, h, nope + dv), generator=g, device=cuda)
    k_nope, v = kv.to(torch.bfloat16).split([nope, dv], dim=-1)
    k_rope = torch.randn((1, sk, 1, rope), generator=g, device=cuda)
    k = torch.cat([k_nope, k_rope.to(torch.bfloat16).expand(1, sk, h, rope)], -1)
    got = flash_attention(q, k, v, q_offset=off)
    assert got.shape == (1, sq, h, dv)
    assert _rowwise_ok(got, flash_attention_ref(q, k, v, q_offset=off), 2**-7, 1e-2)
    assert torch.equal(flash_attention(q, k, v.contiguous(), q_offset=off), got)
    if suffix:
        tail = flash_attention(q[:, sq - suffix:], k, v, q_offset=off + sq - suffix)
        assert torch.equal(tail, got[:, sq - suffix:])
    # the pair is (96, 64): neither (96, 96) nor (64, 96) is built
    with pytest.raises(ValueError):
        flash_attention(q, k, k, q_offset=off)
    with pytest.raises(ValueError):
        flash_attention(q[..., :64], k[..., :64], k, q_offset=off)


@pytest.mark.gpu
def test_flash_kernel_mla_instantiations_do_not_spill(cuda):
    import ctypes

    from repro_torch.kernels import _cuda

    lib = _cuda.library()
    for w in (5, 6):
        vals = [ctypes.c_int() for _ in range(4)]
        assert lib.repro_flash_kernel_info(w, *(ctypes.byref(v) for v in vals)) == 0
        assert vals[1].value == 0 and vals[3].value >= 1, w
    vals = [ctypes.c_int() for _ in range(4)]
    assert lib.repro_flash_kernel_info(10, *(ctypes.byref(v) for v in vals)) != 0


def _long_bert_case(cuda, b, n, d, seed):
    """``b`` examples of ``n`` tokens a side: ragged prefix masks (whole
    64-row tiles empty past each), ``_bert_case``'s four edge examples
    (example 1 an empty reference), and example 4 keeping only tokens
    0-63 and 960-999 of its candidate (masked 64-row tiles in between)."""
    cand, ref, cm, rm = _bert_case(cuda, b, n, n, d, seed)
    cm[4].zero_()
    cm[4, :64] = 1.0
    cm[4, 960:1000] = 1.0
    return cand, ref, cm, rm


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(1024, 256), (2048, 256), (1024, 37)])
def test_bertscore_kernel_past_512_tokens(cuda, n, d):
    """BERTScore at 1,024 and 2,048 tokens a side (the default embedder's
    width; 37 for the 4-byte staging) against the plain version, with
    whole 64-row tiles masked out; batch-invariant and repeatable."""
    args = _long_bert_case(cuda, 16, n, d, n + d)
    got = bertscore_pr(*args)
    want = bertscore_ref(*args)
    for a, r in zip(got, want[:2]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    assert float(got[0][1]) < -0.9e30
    for i in (1, 4):
        alone = bertscore_pr(*(t[i:i + 1].contiguous() for t in args))
        assert all(torch.equal(a, g[i:i + 1]) for a, g in zip(alone, got))
    assert all(torch.equal(a, g) for a, g in zip(bertscore_pr(*args), got))


# -- whisper's widths: kernel 1 at (64, 64), causal and not; kernel 2 at 64 ----------


@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,sq,sk,causal", [
    # chip_smoke.py phase 1's rows: the encoder, the cross prefill, the
    # decoder's causal prompt; Sk = 1,500 is not a multiple of the tile
    (20, 20, 1500, 1500, False), (20, 20, 12, 1500, False), (20, 20, 12, 12, True),
    (20, 20, 1, 1500, False), (20, 20, 65, 300, False), (20, 20, 200, 200, True),
    (8, 2, 130, 1500, False), (20, 20, 64, 64, False)])
def test_flash_kernel_at_whisper_width(cuda, h, kh, sq, sk, causal):
    """(d_qk, d_v) = (64, 64) through both warpgroup launches: within the
    gate; not causal, the same bits as causal with every query past the
    last key (q_offset = Sk - 1); a batch row alone gives its bits among
    others; the cross K/V as views of one fused projection."""
    d = 64
    g = torch.Generator(device=cuda).manual_seed(sq + sk + h)
    q = torch.randn((2, sq, h, d), generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn((2, sk, 2, kh, d), generator=g, device=cuda)
    k, v = kv.to(torch.bfloat16).unbind(2)
    got = flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape
    ref = flash_attention_ref(q, k, v, causal=causal)
    assert _rowwise_ok(got, ref, 2**-7, 1e-2)
    if not causal:
        assert torch.equal(flash_attention(q, k, v, q_offset=sk - 1), got)
        assert not torch.equal(flash_attention(q, k, v), got)
    alone = flash_attention(q[1:], k[1:].contiguous(), v[1:].contiguous(), causal=causal)
    assert torch.equal(alone, got[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("g_heads,kh,s", [(1, 20, 1500), (1, 20, 1024), (4, 2, 512),
                                          (8, 1, 300)])
def test_decode_kernel_at_head_dim_64(cuda, g_heads, kh, s):
    """whisper's decode: lengths = S for every sequence (the cross cache)
    and ragged lengths at the span's edges (the self cache); within the
    gate, repeatable, a sequence alone as among the rest."""
    d = 64
    gen = torch.Generator(device=cuda).manual_seed(64 + g_heads + s)
    ragged = torch.tensor([1, s, 11, 45, SPAN - 1, SPAN, SPAN + 1, s - 1],
                          dtype=torch.int32, device=cuda)
    for lens in (torch.full((16,), s, dtype=torch.int32, device=cuda), ragged):
        b = lens.numel()
        q = torch.randn((b, 1, kh * g_heads, d), generator=gen, device=cuda)
        q = q.to(torch.bfloat16)
        kc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
        vc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
        got = decode_attention(q, kc, vc, lens)
        assert _rowwise_ok(got, decode_attention_ref(q, kc, vc, lens), 2**-7, 1e-3)
        assert torch.equal(decode_attention(q, kc, vc, lens), got)
        for i in (0, b - 1):
            alone = decode_attention(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                                     lens[i:i + 1])
            assert torch.equal(alone, got[i:i + 1])


@pytest.mark.gpu
def test_decode_kernel_refuses_unbuilt_widths_at_both_entries(cuda):
    """d = 96 has no contiguous decode instantiation: the wrapper raises,
    and the C entry, called directly, returns an error rather than running
    another width's kernel; the d = 64 instantiations spill nowhere."""
    import ctypes

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.decode_attention.decode_attention import workspace

    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    q = torch.randn((2, 1, 4, 96), device=cuda).to(torch.bfloat16)
    kc = torch.randn((2, 8, 4, 96), device=cuda)
    with pytest.raises(ValueError):
        decode_attention(q, kc, kc, lens)
    out = torch.empty_like(q)
    stream = _cuda.stream_of(q)
    scratch, arrivals = workspace(q, stream, 8, 4)
    strides = [q.stride(0), q.stride(2), *kc.stride()[:3], *kc.stride()[:3],
               out.stride(0), out.stride(2)]
    lib = _cuda.library()
    err = lib.repro_decode_attention_f32cache(
        q.data_ptr(), kc.data_ptr(), kc.data_ptr(), lens.data_ptr(), out.data_ptr(),
        2, 4, 4, 96, 8, _cuda.int64_array(strides), 96**-0.5, scratch.data_ptr(),
        scratch.numel(), arrivals.data_ptr(), arrivals.numel(), stream)
    assert err != 0
    for fn, which in (("repro_decode_kernel_info", (6, 7)),
                      ("repro_flash_kernel_info", (7, 8))):
        for w in which:
            vals = [ctypes.c_int() for _ in range(4)]
            assert getattr(lib, fn)(w, *(ctypes.byref(v) for v in vals)) == 0
            assert vals[1].value == 0 and vals[3].value >= 1, (fn, w)
    vals = [ctypes.c_int() for _ in range(4)]
    assert lib.repro_decode_kernel_info(10, *(ctypes.byref(v) for v in vals)) != 0


# -- paligemma's width: kernel 1 at d = 256 with the prefix-LM mask; kernel 2 at 256 -


def _prefix_mask_ref(q, k, v, prefix):
    """The plain version under the prefix-LM mask, or causal at P = 0."""
    return flash_attention_ref(q, k, v, prefix_len=prefix)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,prefix", [(12, 0), (12, 256), (268, 0), (268, 256),
                                       (512, 0), (512, 256), (65, 64), (300, 1)])
def test_flash_kernel_at_paligemma_width(cuda, sq, prefix):
    """d = 256 at G = 8 (8 query heads over 1 KV head), 64-key tiles, one
    consumer warpgroup a block at every Sq: within the gate against the plain version with
    and without the prefix; a batch row alone gives its bits among others;
    K and V as views of one fused projection; P = 0 the same bits as the
    call without it, and the prefix moves only the rows below it."""
    d, h, kh = 256, 8, 1
    g = torch.Generator(device=cuda).manual_seed(sq + prefix)
    q = torch.randn((2, sq, h, d), generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn((2, sq, 2, kh, d), generator=g, device=cuda).to(torch.bfloat16)
    k, v = kv.unbind(2)
    got = flash_attention(q, k, v, prefix_len=prefix)
    assert got.shape == q.shape
    assert _rowwise_ok(got, _prefix_mask_ref(q, k, v, prefix), 2**-7, 1e-2)
    alone = flash_attention(q[1:], k[1:].contiguous(), v[1:].contiguous(),
                            prefix_len=prefix)
    assert torch.equal(alone, got[1:])
    plain = flash_attention(q, k, v)
    if prefix == 0:
        assert torch.equal(plain, got)
    else:
        assert torch.equal(plain[:, prefix:], got[:, prefix:])
        if min(prefix, sq) > 1:
            assert not torch.equal(plain[:, : min(prefix, sq) - 1],
                                   got[:, : min(prefix, sq) - 1])
    assert torch.equal(flash_attention(q, k, v, prefix_len=prefix), got)
    full = flash_attention(q, k, v, causal=False)
    assert _rowwise_ok(full, flash_attention_ref(q, k, v, causal=False), 2**-7, 1e-2)
    if prefix >= sq:  # a prefix over every row is no mask at all
        assert torch.equal(full, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(128, 128), (112, 112), (96, 64), (64, 64),
                                  (256, 256)])
def test_flash_kernel_prefix_zero_is_the_causal_call(cuda, dims):
    """At every width, ``prefix_len=0`` computes the bits of the call
    without the argument, at 12 and 200 query rows; a negative prefix is
    refused."""
    d, dv = dims
    g = torch.Generator(device=cuda).manual_seed(d + dv)
    for sq in (12, 200):
        q = torch.randn((1, sq, 8, d), generator=g, device=cuda).to(torch.bfloat16)
        k = torch.randn((1, sq, 2, d), generator=g, device=cuda).to(torch.bfloat16)
        v = torch.randn((1, sq, 2, dv), generator=g, device=cuda).to(torch.bfloat16)
        assert torch.equal(flash_attention(q, k, v, prefix_len=0),
                           flash_attention(q, k, v))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, prefix_len=-1)


@pytest.mark.gpu
def test_decode_kernel_at_paligemma_width(cuda):
    """d = 256 at G = 8 over phase 15's cache (16 slots of 512 rows) at its
    lengths 268..300 and at the span's edges: within the gate, repeatable,
    a sequence alone as among the rest; G = 4 (the reduced model's) too;
    no instantiation of either kernel at d = 256 spills."""
    import ctypes

    from repro_torch.kernels import _cuda

    d, s = 256, 512
    gen = torch.Generator(device=cuda).manual_seed(256)
    main = (268 + 2 * torch.arange(16, device=cuda)).clamp(max=300).to(torch.int32)
    ragged = torch.tensor([1, s, 11, 45, SPAN - 1, SPAN, SPAN + 1, s - 1, 268, 300,
                           2 * SPAN, 2 * SPAN + 1, 3, 400, 511, 256],
                          dtype=torch.int32, device=cuda)
    for g_heads, kh in ((8, 1), (4, 2)):
        for lens in (main, ragged):
            b = lens.numel()
            q = torch.randn((b, 1, kh * g_heads, d), generator=gen, device=cuda)
            q = q.to(torch.bfloat16)
            kc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
            vc = torch.randn((b, s, kh, d), generator=gen, device=cuda)
            got = decode_attention(q, kc, vc, lens)
            assert _rowwise_ok(got, decode_attention_ref(q, kc, vc, lens), 2**-7, 1e-3)
            assert torch.equal(decode_attention(q, kc, vc, lens), got)
            for i in (0, 9, b - 1):
                alone = decode_attention(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                                         lens[i:i + 1])
                assert torch.equal(alone, got[i:i + 1])
    lib = _cuda.library()
    for fn, which in (("repro_decode_kernel_info", (8, 9)),
                      ("repro_flash_kernel_info", (9,))):
        for w in which:
            vals = [ctypes.c_int() for _ in range(4)]
            assert getattr(lib, fn)(w, *(ctypes.byref(v) for v in vals)) == 0
            assert vals[1].value == 0 and vals[3].value >= 1, (fn, w)
