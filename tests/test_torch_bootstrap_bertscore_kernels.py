"""The algorithms of the Hopper kernels 6 (``csrc/bootstrap.cu``,
bootstrap partials) and 7 (``csrc/bertscore.cu``, BERTScore), mirrored in
torch on the CPU and held to the JAX package's Pallas kernels in interpret
mode on the same numpy inputs.

- The integer thresholds the partials kernel compares ``bits >> 8`` with
  (read from the source) give the Poisson(1) weights of the port's and the
  JAX package's ``poisson1_weight`` bit for bit at all 2^24 values.
- Kernel 6's summation order (rows of a warp in order, a tile's warps in
  order, a row block's tiles k, k + 64, ..., the row blocks in order; the
  geometry read from the source) gives ``sum w`` bit-equal to the Pallas
  kernel's (integers, exact in f32) and ``sum w x`` within 1e-5 of the
  value: f32 sums of at most 1,500 terms of at most 7 in two orders (the
  existing plain-version test's tolerance for the same sizes).
- Kernel 7's product is 3xTF32 (operands split into a TF32 part, rounded
  to nearest with ties away from zero on the bit pattern, and a TF32
  remainder; the lo.lo term dropped), added into an f32 accumulator per
  8-column k-step in the kernel's order, and scaled by the rows' inverse
  norms after the product.  P and R are within 1e-5 of the value plus 1e-6 of
  the Pallas kernel's, the gate ``chip_smoke.py`` holds the kernel to: the
  split leaves ~2^-21 of |c||r| a product, which is ~1e-6 of a cosine
  summed over D <= 256.  Plain TF32 (the split's hi parts alone) misses
  that gate, which the last test shows.

Every input comes from a fixed numpy seed.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bertscore import bertscore_pr as jax_bertscore_pr
from repro.kernels.bootstrap import bootstrap_partials as jax_partials
from repro.kernels.bootstrap.ref import POISSON1_CDF
from repro.kernels.bootstrap.ref import poisson1_weight as jax_poisson1
from repro_torch.kernels.bertscore.ref import NEG_INF
from repro_torch.kernels.bootstrap import (
    bootstrap_partials_ref,
    mix_bits,
    poisson1_weight,
)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _bootstrap_source() -> str:
    return (CSRC / "bootstrap.cu").read_text()


def _thresholds() -> list[int]:
    body = _bootstrap_source().split("float poisson1_draw(", 1)[1].split("}", 1)[0]
    return [int(t) for t in re.findall(r"v >= (\d+)u", body)]


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _bootstrap_source())[1])


def test_every_bound_entry_point_is_in_the_sources_with_its_arity():
    """The library is built only on the card: a name or an argument count
    that disagrees between ``_cuda.SIGNATURES`` and the CUDA sources shows
    here first."""
    from repro_torch.kernels._cuda import SIGNATURES

    found = {}
    for src in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]:
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = 0 if not params.strip() else params.count(",") + 1
    for name, argtypes in SIGNATURES.items():
        assert found.get(name) == len(argtypes), name


# -- the integer thresholds -----------------------------------------------------------


def test_thresholds_are_the_ceiling_of_the_f32_cdf_times_2_to_the_24():
    want = [math.ceil(float(np.float32(c)) * 2**24) for c in POISSON1_CDF]
    assert _thresholds() == want


@pytest.mark.parametrize("part", range(4))
def test_integer_thresholds_give_the_poisson_weights_at_every_24_bit_value(part):
    """All 2^24 values of ``bits >> 8``, a quarter a case, with the low
    byte varied: the count of thresholds at or below them is the port's
    and the JAX package's f32 ladder, bit for bit."""
    v = np.arange(part << 22, (part + 1) << 22, dtype=np.int64)
    bits = (v << 8) | (v * 37 & 0xFF)
    count = np.zeros(v.shape, np.float32)
    for t in _thresholds():
        count += (v >= t).astype(np.float32)
    got = poisson1_weight(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, count)
    np.testing.assert_array_equal(
        np.asarray(jax_poisson1(jnp.asarray(bits.astype(np.uint32)))), count)


# -- kernel 6: the summation order ----------------------------------------------------


def _fma32(w: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32 ``fmaf(w, x, s)``: w x is exact in f64 (w <= 7), so one f64 add
    and one rounding to f32 give the fused result wherever the f64 sum is
    exact (terms within 2^26 of each other, as here)."""
    return (s.double() + w.double() * x.double()).float()


def partials_mirror(scores: torch.Tensor, seed: int, start: int, n_boot: int):
    """Kernel 6's arithmetic on the CPU: the same weights (integer
    thresholds), f32 sums in the kernel's order."""
    warps, warp_rows = _constant("P_WARPS"), _constant("P_WARP_ROWS")
    rows, max_blocks = warps * warp_rows, _constant("P_BLOCKS")
    n, m = scores.shape
    n_tiles = -(-n // rows)
    pad = n_tiles * rows - n
    x = scores.to(torch.float32)
    valid = ~torch.isnan(x)
    xv = torch.cat([torch.where(valid, x, 0.0), valid.float()], dim=1)  # (n, 2m)
    xv = torch.cat([xv, torch.zeros(pad, 2 * m)]).view(n_tiles, warps, warp_rows, 2 * m)
    boot = torch.arange(n_boot, dtype=torch.int64)[:, None]
    pos = (start + torch.arange(n, dtype=torch.int64)) & 0xFFFFFFFF
    v = mix_bits(boot, pos[None, :], seed) >> 8
    w = sum((v >= t).float() for t in _thresholds())  # (B, n)
    w = torch.cat([w, torch.zeros(n_boot, pad)], dim=1).view(
        n_boot, n_tiles, warps, warp_rows)
    s = torch.zeros(n_boot, n_tiles, warps, 2 * m)
    for r in range(warp_rows):  # a warp's rows in order, from 0
        s = _fma32(w[..., r, None], xv[None, :, :, r, :], s)
    tile = s[:, :, 0]
    for k in range(1, warps):  # ((w0 + w1) + w2) + w3
        tile = tile + s[:, :, k]
    n_blocks = min(n_tiles, max_blocks)
    blocks = tile[:, :n_blocks].clone()
    for t in range(n_blocks, n_tiles):  # row block k: tiles k, k + 64, ...
        blocks[:, t % n_blocks] = blocks[:, t % n_blocks] + tile[:, t]
    total = blocks[:, 0]
    for k in range(1, n_blocks):
        total = total + blocks[:, k]
    return total[:, :m], total[:, m:]


@pytest.mark.parametrize("m", [1, 2, 7, 13])
@pytest.mark.parametrize("n", [1, 16, 1024, 1500])
def test_partials_order_matches_the_pallas_kernel(n, m):
    rng = np.random.default_rng(100 * n + m)
    x = rng.random((n, m)).astype(np.float32)
    x[:, 0] = x[:, 0] > 0.5
    x[::7, m - 1] = np.nan
    start = (2**32 - n // 2) & 0xFFFFFFFF  # the position counter wraps
    swx, sw = partials_mirror(torch.from_numpy(x), 11, start, 200)
    k_swx, k_sw = jax_partials(x, 11, start, n_boot=200, mode="interpret")
    np.testing.assert_array_equal(sw.numpy(), k_sw)
    np.testing.assert_allclose(swx.numpy(), k_swx, rtol=1e-5, atol=0)
    p_swx, p_sw = bootstrap_partials_ref(torch.from_numpy(x), 11, start, n_boot=200)
    assert torch.equal(sw, p_sw)
    torch.testing.assert_close(swx, p_swx, rtol=1e-5, atol=0)


def test_partials_order_past_64_tiles_and_each_column_alone():
    """Past 64 tiles a row block adds several tiles; a column's bits do
    not depend on the columns beside it."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((64 * 64 + 1000, 3)).astype(np.float32))
    x[::9, 1] = float("nan")
    swx, sw = partials_mirror(x, 2, 2**32 - 3000, 40)
    p_swx, p_sw = bootstrap_partials_ref(x, 2, 2**32 - 3000, n_boot=40)
    assert torch.equal(sw, p_sw)
    torch.testing.assert_close(swx, p_swx, rtol=1e-5, atol=0)
    for j in range(3):
        a_swx, a_sw = partials_mirror(x[:, j:j + 1], 2, 2**32 - 3000, 40)
        assert torch.equal(a_swx[:, 0], swx[:, j]) and torch.equal(a_sw[:, 0], sw[:, j])


# -- kernel 7: 3xTF32 ------------------------------------------------------------------


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 to TF32 (10 mantissa bits) rounded to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped range to the
    magnitude's bits and clear them."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def bertscore_mirror(cand, ref, cmask, rmask, *, terms: int = 3):
    """Kernel 7's arithmetic on the CPU.  Per 8-column k-step the f32
    accumulator takes lo.hi', then hi.lo', then hi.hi' (``terms=1``: hi.hi'
    alone, plain TF32), as the kernel's three ``mma.sync`` do; each mma's
    eight products are summed in f64 and rounded once to f32, a model of
    the tensor core's inner sum.  Squared norms are f32 fused multiply-adds
    in column order; the product is scaled by the two inverse norms in
    f32, then masked, maximised and averaged (``torch.rsqrt`` stands for
    ``rsqrtf``, and the means' order is not the kernel's warp tree)."""
    def split(t):
        hi = tf32_rna(t)
        return hi, tf32_rna(t - hi)

    c_hi, c_lo = split(cand)
    r_hi, r_lo = split(ref)
    pairs = ((c_lo, r_hi), (c_hi, r_lo), (c_hi, r_hi)) if terms == 3 else ((c_hi, r_hi),)
    dot = torch.zeros(cand.shape[0], cand.shape[1], ref.shape[1])
    for k in range(0, cand.shape[2], 8):
        for a, b in pairs:
            step = torch.einsum("bid,bjd->bij", a[..., k:k + 8].double(),
                                b[..., k:k + 8].double())
            dot = (dot.double() + step).float()

    def inv_norm(t):
        n2 = torch.zeros(t.shape[:-1])
        for k in range(t.shape[-1]):  # fmaf: the square is exact in f64
            n2 = (n2.double() + t[..., k].double() ** 2).float()
        return torch.rsqrt(torch.clamp(n2, min=1e-18))

    sim = dot * inv_norm(cand)[:, :, None] * inv_norm(ref)[:, None, :]
    cm, rm = cmask > 0.5, rmask > 0.5
    sim = torch.where(cm[:, :, None] & rm[:, None, :], sim, NEG_INF)
    p = torch.where(cm, sim.amax(2), 0.0).sum(1) / cm.sum(1).clamp(min=1)
    r = torch.where(rm, sim.amax(1), 0.0).sum(1) / rm.sum(1).clamp(min=1)
    return p, r


def _bert_inputs(lc, lr, d, seed, b=6):
    """Random embeddings under random prefix masks; examples 0-3 are
    ``chip_smoke.py``'s edges: an empty candidate, an empty reference,
    both empty, and one pair at cosine -0.995."""
    rng = np.random.default_rng(seed)
    cand = rng.standard_normal((b, lc, d)).astype(np.float32)
    ref = rng.standard_normal((b, lr, d)).astype(np.float32)
    nc = rng.integers(1, lc + 1, b)
    nr = rng.integers(1, lr + 1, b)
    nc[0], nr[1], nc[2], nr[2], nc[3], nr[3] = 0, 0, 0, 0, 1, 1
    cand[3, 0] = 0.0
    ref[3, 0] = 0.0
    cand[3, 0, 0] = 1.0
    ref[3, 0, 0], ref[3, 0, 1] = -0.995, (1 - 0.995**2) ** 0.5
    cm = (np.arange(lc)[None, :] < nc[:, None]).astype(np.float32)
    rm = (np.arange(lr)[None, :] < nr[:, None]).astype(np.float32)
    return cand, ref, cm, rm


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("lr", [5, 37, 64])
@pytest.mark.parametrize("lc", [5, 37, 64])
def test_3xtf32_bertscore_matches_the_pallas_kernel(lc, lr, d):
    arrays = _bert_inputs(lc, lr, d, lc * 1000 + lr * 10 + d)
    p, r = bertscore_mirror(*(torch.from_numpy(a) for a in arrays))
    kp, kr = jax_bertscore_pr(*arrays, interpret=True)
    for got, want in ((p, kp), (r, kr)):
        np.testing.assert_allclose(got.numpy().astype(np.float64),
                                   np.asarray(want, np.float64), rtol=1e-5, atol=1e-6)
    # the edges: the -1e30 sentinel's mean where the other side is empty,
    # 0 where both are
    assert float(r[0]) < -0.9e30 and float(p[1]) < -0.9e30
    assert (float(p[2]), float(r[2])) == (0.0, 0.0)
    assert abs(float(p[3]) + 0.995) < 1e-6 and abs(float(r[3]) + 0.995) < 1e-6


def test_plain_tf32_misses_the_gate_that_3xtf32_meets():
    arrays = _bert_inputs(64, 64, 256, 7, b=32)
    args = [torch.from_numpy(a) for a in arrays]
    kp, kr = (torch.tensor(np.asarray(t)) for t in
              jax_bertscore_pr(*arrays, interpret=True))

    def worst(p, r):
        return max(float(((a.double() - b.double()).abs()
                          / (1e-5 * b.double().abs() + 1e-6)).max())
                   for a, b in ((p, kp), (r, kr)))

    assert worst(*bertscore_mirror(*args)) <= 1.0
    assert worst(*bertscore_mirror(*args, terms=1)) > 1.0
