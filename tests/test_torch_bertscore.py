"""Kernel 7's plain PyTorch version (``repro_torch.kernels.bertscore``)
against the JAX package's ``bertscore_ref`` and against the Pallas
``bertscore_pr`` in interpret mode, on the same numpy inputs: Lc = 64 and
Lr = 37, so that ``block_r=16`` cuts the reference side into ragged tiles,
and the edge cases (empty candidate, empty reference, both, and a pair
with p + r < 0, where the reference's F1 epilogue explodes).  f32 sums run
in other orders, so P, R and F1 agree within 1e-5 of the value plus 1e-6,
the -1e30 sentinel's means included; F1's sign agrees exactly."""

import numpy as np
import pytest
import torch

from repro.kernels.bertscore import bertscore as jax_bertscore
from repro.kernels.bertscore import bertscore_pr as jax_pr
from repro.kernels.bertscore import bertscore_ref as jax_ref
from repro_torch.kernels.bertscore import bertscore, bertscore_pr, bertscore_ref

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, b=6, lc=64, lr=37, d=48):
    rng = np.random.default_rng(seed)
    cand = rng.standard_normal((b, lc, d)).astype(np.float32)
    ref = rng.standard_normal((b, lr, d)).astype(np.float32)
    cm = (rng.random((b, lc)) > 0.25).astype(np.float32)
    rm = (rng.random((b, lr)) > 0.25).astype(np.float32)
    cand[0, 3] = 0.0  # a zero vector: normalises to 0 on both sides
    cm[1] = 0.0       # empty candidate
    rm[2] = 0.0       # empty reference
    cm[3] = rm[3] = 0.0
    rm[4, : lr - 1] = 0.0  # one reference token, in the last ragged tile
    return cand, ref, cm, rm


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_matches_jax_ref_and_pallas_kernel(seed):
    cand, ref, cm, rm = _inputs(seed)
    p, r, f1 = bertscore_ref(*_torch(cand, ref, cm, rm))
    jp, jr, jf1 = jax_ref(cand, ref, cm, rm)
    kp, kr = jax_pr(cand, ref, cm, rm, block_r=16, interpret=True)
    for got, a, b in ((p, jp, kp), (r, jr, kr)):
        _close(got, a)
        _close(got, b)
    _close(f1, jf1)
    # the dispatcher takes the plain version for CPU tensors, F1 included
    for got, want in zip(bertscore(*_torch(cand, ref, cm, rm)), (p, r, f1)):
        assert torch.equal(got, want)


def test_sentinel_edges_match_the_reference():
    cand, ref, cm, rm = _inputs(3, b=5)
    p, r, f1 = (t.numpy() for t in bertscore_ref(*_torch(cand, ref, cm, rm)))
    jp, jr, jf1 = (np.asarray(t) for t in jax_ref(cand, ref, cm, rm))
    # empty candidate: P = 0, R = -1e30 (the sentinel, as near as the f32
    # mean of -1e30s comes), F1 = -0.0
    assert p[1] == 0.0 and f1[1] == 0.0 and np.signbit(f1[1])
    _close(r[1], -1e30)
    # empty reference: P = -1e30, R = 0, F1 = -0.0
    _close(p[2], -1e30)
    assert r[2] == 0.0 and np.signbit(f1[2])
    # both empty: zeros
    assert (p[3], r[3], f1[3]) == (0.0, 0.0, 0.0)
    _close(p, jp)
    _close(r, jr)
    np.testing.assert_array_equal(np.signbit(f1), np.signbit(jf1))


def test_negative_p_plus_r_explodes_as_in_the_reference():
    """One token pair at cosine -0.995: P = R = -0.995 and the epilogue
    divides by max(p + r, 1e-9) = 1e-9, giving F1 ~ 1.98e9 in both."""
    c = np.array([[[1.0, 0.0]]], np.float32)
    s = np.sqrt(1 - 0.995**2)
    r = np.array([[[-0.995, s]]], np.float32)
    m = np.ones((1, 1), np.float32)
    p_, r_, f1 = bertscore_ref(*_torch(c, r, m, m))
    jp, jr, jf1 = jax_ref(c, r, m, m)
    kp, kr = jax_pr(c, r, m, m, interpret=True)
    _, _, kf1 = jax_bertscore(c, r, m, m, use_pallas=True, interpret=True)
    assert abs(float(f1[0]) - 1.98e9) < 1e-3 * 1.98e9
    np.testing.assert_allclose(float(f1[0]), float(jf1[0]), rtol=1e-5)
    np.testing.assert_allclose(float(f1[0]), float(kf1[0]), rtol=1e-5)
    _close(p_, jp)
    _close(r_, kr)
    _close(p_, kp)


def test_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises; only the
    dispatcher chooses the plain version, and only for CPU tensors."""
    cand, ref, cm, rm = _torch(*_inputs(4, b=5))
    with pytest.raises(ValueError, match="CUDA"):
        bertscore_pr(cand, ref, cm, rm)
    assert bertscore_pr.launches == 0
