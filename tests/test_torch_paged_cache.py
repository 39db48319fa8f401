"""The port's page manager and int8 quantizer against the JAX package's.

The manager is pure bookkeeping, so the two must agree call for call: a
seeded churn of ``acquire`` / ``register`` / ``ensure_position`` /
``release`` under pool pressure drives both side by side.  The quantizer
must give the JAX bits exactly, including where XLA flushes f32
subnormals to zero."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import quant as jax_quant
from repro.serve import paged_cache as jax_pc
from repro_torch.kernels.decode_attention import quant
from repro_torch.serve import paged_cache as port_pc

# -- the page manager ---------------------------------------------------------------


def _call(mgr, name, *args):
    """(outcome, value): a result as a dict, or the exception's class name
    (the two packages raise their own PagePoolExhausted)."""
    try:
        out = getattr(mgr, name)(*args)
    except (RuntimeError, ValueError) as e:
        return "raised", type(e).__name__
    return "ok", dataclasses.asdict(out) if dataclasses.is_dataclass(out) else out


def _state(mgr, owners):
    return {
        "tables": {o: mgr.table(o) for o in sorted(owners)},
        "refs": [mgr.refcount(p) for p in range(mgr.n_pages)],
        "free": mgr.pages_free,
        "cached": mgr.pages_cached,
        "active": mgr.pages_active,
        "stats": dataclasses.asdict(mgr.stats),
    }


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_manager_matches_jax_call_for_call(seed, prefix_cache):
    rng = random.Random(seed)
    ps, n_pages = 4, 12
    kw = {"prefix_cache": prefix_cache, "page_bytes": 96}
    port = port_pc.PagedCacheManager(n_pages, ps, **kw)
    ref = jax_pc.PagedCacheManager(n_pages, ps, **kw)
    # prompts share long prefixes, so pages match, get cached and evicted
    stems = [[rng.randrange(2, 50) for _ in range(13)] for _ in range(3)]
    owners: dict[int, list[int]] = {}  # owner -> tokens it holds pages for
    n_exhausted = 0
    for step in range(160):
        op = rng.random()
        if op < 0.4 or not owners:
            owner = rng.randrange(8)
            if owner in owners:
                continue
            toks = rng.choice(stems)[: rng.randrange(1, 14)]
            toks = toks + [rng.randrange(2, 50) for _ in range(rng.randrange(0, 4))]
            got = _call(port, "acquire", owner, toks)
            want = _call(ref, "acquire", owner, toks)
            assert got == want, (step, got, want)
            if got[0] == "ok":
                owners[owner] = toks
                if rng.random() < 0.8:
                    assert port.register(owner, toks) == ref.register(owner, toks)
            else:
                assert got[1] == "PagePoolExhausted"
                n_exhausted += 1
        elif op < 0.75:
            owner = rng.choice(sorted(owners))
            held = len(port.table(owner)) * ps
            # grow at the end, or write inside a (possibly shared) page
            pos = held if rng.random() < 0.6 else rng.randrange(held)
            got = _call(port, "ensure_position", owner, pos)
            want = _call(ref, "ensure_position", owner, pos)
            assert got == want, (step, got, want)
            n_exhausted += got == ("raised", "PagePoolExhausted")
        else:
            owner = rng.choice(sorted(owners))
            port.release(owner)
            ref.release(owner)
            del owners[owner]
        assert _state(port, owners) == _state(ref, owners), step
    assert n_exhausted > 0  # the pool ran out at least once, on both sides
    if prefix_cache:
        assert port.stats.prefix_pages_hit > 0 and port.stats.cow_copies > 0
    for owner in list(owners):
        port.release(owner)
        ref.release(owner)
    port.check_no_leaks()
    ref.check_no_leaks()
    assert _state(port, {}) == _state(ref, {})


def test_helpers_match_jax():
    for args in [(16, 8, 128, 36, "bf16"), (16, 8, 128, 36, "int8"),
                 (4, 1, 16, 2, "int8")]:
        assert port_pc.kv_page_bytes(*args) == jax_pc.kv_page_bytes(*args)
    with pytest.raises(ValueError):
        port_pc.kv_page_bytes(16, 8, 128, 36, "fp8")
    assert port_pc.pages_for_budget(10_000, 96) == jax_pc.pages_for_budget(10_000, 96)
    with pytest.raises(ValueError):
        port_pc.pages_for_budget(95, 96)
    toks = list(range(2, 40))
    assert port_pc.page_hash_chain(toks, 16) == jax_pc.page_hash_chain(toks, 16)


# -- the quantizer ------------------------------------------------------------------


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same_quant(x: np.ndarray, axes, mask=None):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jq, js = jax_quant.absmax_quantize(jnp.asarray(x), axes, mask=jm)
    tq, ts = quant.absmax_quantize(torch.from_numpy(x), axes, mask=tm)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    want = jax_quant.absmax_dequantize(jq, js, axes)
    got = quant.absmax_dequantize(tq, ts, axes)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_pages_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    # (P, K, ps, d), the JAX kernels' layout; the port's pool is (P, ps, K, d)
    x = rng.standard_normal((6, 3, 8, 16)) * 10.0 ** rng.integers(-3, 3)
    x = x.astype(np.float32)
    x[2] = 0.0  # all-zero groups: scale 1.0
    jq, js = jax_quant.quantize_pages(jnp.asarray(x))
    tq, ts = quant.quantize_pages(torch.from_numpy(x).transpose(1, 2).contiguous())
    np.testing.assert_array_equal(tq.transpose(1, 2).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert (ts[2] == 1.0).all()
    back = quant.dequantize_pages(tq, ts).transpose(1, 2).contiguous()
    want = jax_quant.dequantize_pages(jq, js)
    np.testing.assert_array_equal(_bits(back), _bits(want))


def test_masked_rows_bit_equal_to_jax():
    """The batcher's write-page requantization: rows past the new token
    are masked out of the absmax and of the bytes."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 16, 4, 32)).astype(np.float32)
    x[:, 9:] *= 100.0  # stale rows that must not set the scale
    offs = np.array([0, 3, 8, 15, 8])
    mask = (np.arange(16)[None, :] <= offs[:, None])[:, :, None, None]
    _assert_same_quant(x, (1, 3), mask)


def test_half_step_values_round_to_even_as_jax():
    # absmax 127 -> scale exactly 1.0; absmax 254 -> scale exactly 2.0
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                  [254.0, 1.0, 3.0, 5.0, -1.0, -3.0, 7.0, 253.0]], np.float32)
    _assert_same_quant(x, (1,))


@pytest.mark.parametrize("vals", [
    [1.4e-45],                              # one subnormal: XLA reads it as 0
    [1e-38, 2e-39],                         # subnormal absmax: scale 1.0
    [1e-37, -5e-38],                        # absmax / 127 flushes: scale 0.0
    [1e-37, 0.0, 1e-39, -1e-39, -0.0, 5e-38],  # 0 / 0 stores byte 0
    [2e-36, 1.4e-45, 1e-39, 1e-38],         # subnormal elements quantize as 0
    [1.4e-45, 1.0],
    [0.0, -0.0],
])
def test_subnormals_give_the_jax_bits(vals):
    x = np.array(vals, np.float32)
    _assert_same_quant(x, (0,))
    _assert_same_quant(np.stack([x, -x, x * 2]), (1,))
