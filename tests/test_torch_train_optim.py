"""The port's optimizer, schedules, clipping and cross-entropy against the
JAX package's, on the CPU: the cases of ``tests/test_train_grad.py``
(schedule shape, clipping, the vocab-padding mask, AdamW on a quadratic,
a deterministic train step), each also held against the reference on the
same inputs; ``adamw_update`` at the default eps against the reference's
on identical gradients over three steps (tiny and zero gradients
included); a stacked leaf's gradient given per layer, and the update done
in small slices, bit-equal to the whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import OptimizerConfig as JaxOptimizerConfig
from repro.train import adamw_update as jax_adamw_update
from repro.train import clip_by_global_norm as jax_clip
from repro.train import cross_entropy as jax_cross_entropy
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import lr_at as jax_lr_at
from repro_torch.models import build_model
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    adamw_update,
    clip_by_global_norm,
    cross_entropy,
    init_opt_state,
    lr_at,
    make_train_step,
)
from repro_torch.train import optimizer as opt_mod
from test_torch_train_common import global_state_unchanged, port_setup  # noqa: F401

#: f32 scalars through the same formula (XLA's cos may differ by an ulp)
SCALAR_RTOL = 1e-6
#: identical f32 inputs, the same operations: rounding (fused or not) only
UPDATE_RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_lr_schedule_shape():
    cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_at(cfg, torch.tensor(s))) for s in range(0, 100, 5)]
    assert lrs[0] < lrs[1]  # warmup rising
    assert max(lrs) <= 1e-3 + 1e-9
    assert lrs[-1] < lrs[3]  # cosine decays
    assert lrs[-1] >= 1e-4 - 1e-9  # min_lr_ratio floor


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_the_reference(schedule):
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    cfg, jcfg = OptimizerConfig(**kw), JaxOptimizerConfig(**kw)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.array([float(jax_lr_at(jcfg, jnp.asarray(s))) for s in steps])
    got = np.array([float(lr_at(cfg, torch.tensor(s, dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=SCALAR_RTOL)
    assert lr_at(cfg, torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    with pytest.raises(ValueError):
        lr_at(OptimizerConfig(schedule="step"), 0)


def test_grad_clip():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0)
    same, _ = clip_by_global_norm(g, 10.0)  # below threshold: untouched
    assert torch.equal(same["a"], g["a"])


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_grad_clip_matches_the_reference(max_norm):
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    want, want_norm = jax_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    got, norm = clip_by_global_norm(jax.tree.map(_t, tree), max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=SCALAR_RTOL)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SCALAR_RTOL)


def test_cross_entropy_masking_and_vocab_padding():
    logits = torch.zeros((1, 4, 8))
    logits[..., 7] = 100.0
    labels = torch.tensor([[0, 1, -1, -1]])
    # vocab_size=6: ids 6, 7 are padding and must be masked
    loss, metrics = cross_entropy(logits, labels, vocab_size=6, z_loss_weight=0.0)
    assert float(metrics["tokens"]) == 2.0
    # the padded id 7 had logit 100 but must not dominate: nll = log(6)
    assert float(metrics["nll"]) == pytest.approx(np.log(6), abs=1e-4)


@pytest.mark.parametrize("vocab,z", [(50, 1e-4), (64, 1e-4), (50, 0.0)])
def test_cross_entropy_matches_the_reference(vocab, z):
    """Random logits over a padded vocab of 64, labels with ignored ones:
    the total, every metric and the gradient of the total."""
    rng = np.random.default_rng(vocab)
    logits = (3 * rng.standard_normal((3, 7, 64))).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = -1
    labels[0, 0] = int(np.argmax(logits[0, 0, :vocab]))  # one sure hit
    fn = lambda x: jax_cross_entropy(x, jnp.asarray(labels), vocab, z)  # noqa: E731
    (want, want_m), want_g = jax.value_and_grad(fn, has_aux=True)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got, got_m = cross_entropy(x, _t(labels).long(), vocab, z)
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=SCALAR_RTOL)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=SCALAR_RTOL,
                                   err_msg=k)
    assert float(got_m["accuracy"]) > 0
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)


def test_adamw_descends_quadratic():
    w = {"w": torch.tensor([5.0, -3.0])}
    cfg = OptimizerConfig(learning_rate=0.2, warmup_steps=0, total_steps=1000,
                          weight_decay=0.0, schedule="constant")
    state = init_opt_state(w)
    for _ in range(200):
        w, state, _ = adamw_update(cfg, w, {"w": 2 * w["w"]}, state)
    assert float(w["w"].abs().max()) < 1e-2
    assert int(state.step) == 200 and state.step.dtype == torch.int32


def _tree(rng):
    return {"embed": rng.standard_normal((11, 6)).astype(np.float32),
            "layers": {"w": rng.standard_normal((3, 6, 5)).astype(np.float32),
                       "s": rng.standard_normal((3, 5)).astype(np.float32)}}


def test_adamw_update_matches_the_reference():
    """Three steps at the default config (warmup, cosine, eps 1e-8,
    clipping at 1.0, weight decay 0.1) on gradients given to both
    frameworks, some of them 0 or within a few eps of 0."""
    rng = np.random.default_rng(7)
    params = _tree(rng)
    cfg, jcfg = OptimizerConfig(), JaxOptimizerConfig()
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_init_opt_state(jp)
    pp = jax.tree.map(_t, params)
    state = init_opt_state(pp)
    for i in range(3):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                        * 10.0 ** rng.integers(-9, 1, x.shape))
                             .astype(np.float32), params)
        grads["layers"]["s"][1] = 0.0
        jp, jstate, jm = jax_adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, grads), jstate)
        pp, state, m = adamw_update(cfg, pp, jax.tree.map(_t, grads), state)
        assert int(state.step) == int(jstate.step) == i + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=SCALAR_RTOL)
        for got, want in ((pp, jp), (state.mu, jstate.mu), (state.nu, jstate.nu)):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=UPDATE_RTOL,
                                           atol=UPDATE_RTOL * np.abs(b).max())


def test_per_layer_gradients_and_slices_are_bit_equal(monkeypatch):
    """A stacked leaf's gradient given as the list of its per-layer
    gradients, and the update run 7 elements at a time, write the same
    bits as the stacked gradient in whole slices."""
    rng = np.random.default_rng(11)
    params = _tree(rng)
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    cfg = OptimizerConfig(warmup_steps=0)
    whole = jax.tree.map(_t, params)
    whole, s_whole, _ = adamw_update(cfg, whole, jax.tree.map(_t, grads),
                                     init_opt_state(whole))
    per_layer = jax.tree.map(_t, params)
    g = jax.tree.map(_t, grads)
    g["layers"] = {k: list(v.unbind(0)) for k, v in g["layers"].items()}
    monkeypatch.setattr(opt_mod, "CHUNK", 7)
    per_layer, s_layer, _ = adamw_update(cfg, per_layer, g, init_opt_state(per_layer))
    for a, b in zip(jax.tree.leaves((whole, s_whole.mu, s_whole.nu)),
                    jax.tree.leaves((per_layer, s_layer.mu, s_layer.nu))):
        assert torch.equal(a, b)


def test_train_step_determinism():
    """Two steps from the same state give the same bits (reduced
    mamba2-2.7b, f32)."""
    cfg, params, batch = port_setup("mamba2-2.7b")
    step = make_train_step(build_model(cfg, remat="none"), cfg,
                           TrainConfig(compute_dtype=torch.float32))
    out = []
    for _ in range(2):
        p = jax.tree.map(torch.clone, params)
        out.append(step(p, init_opt_state(p), batch))
    (p1, _, m1), (p2, _, m2) = out
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)))
