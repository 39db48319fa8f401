"""The port's training slice against the JAX package, on the CPU: what every
family shares, and the harness that the per-family files
(``test_torch_train_<family>.py``) run.

Here: the differentiable attention (``naive_attention`` under
``make_causal_mask``: causal, not, prefix-LM, a query offset, GQA groups)
against the reference's in f32 and bf16; ``dots`` recomputing the batched
products but no plain one.  The family files also run
:func:`check_remat_bits` (the three remat policies give bit-equal losses
and gradients) and :func:`check_microbatches` (M = 2 microbatches against
one batch), one family a file so that the workers share them out.

The harness (:func:`check_train_parity`): one family's reduced config in
f32, the reference's parameters (constant leaves, the norms' ones and the
biases' zeros, drawn away from their init so a dropped one shows) bridged
by ``params_from_jax(..., dtype=torch.float32)``, a seeded batch with
ignored labels; the loss and its metrics, every gradient leaf, and the
parameters, moments and step after one AdamW step, against one step of
the reference's jitted ``make_train_step`` (its ``make_loss_fn`` inside).  The step's optimizer
takes ``eps = 1e-3``: at the default 1e-8 an element whose gradient is
within f32 noise of zero moves by up to ``lr`` either way, in either
framework; at 1e-3 an update is a smooth function of its gradient, so the
parameters can be held tightly (``test_torch_train_optim.py`` holds the
default eps on identical gradients).

Every test file of the slice uses :func:`global_state_unchanged` (autouse):
the suite runs files of both packages in shared worker processes
(``pytest -n``), so a test may not leave a process-wide setting changed."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import params as jax_pm
from repro.models.model import build_model as jax_build_model
from repro.train import OptimizerConfig as JaxOptimizerConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import build_model, init_params, params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models.params import STACKED, _jax_path, param_specs
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    init_opt_state,
    make_loss_fn,
    make_train_step,
)
from repro_torch.train.step import grad_leaves, loss_and_grads

#: f32 on both sides, sums in other orders: the loss and its metrics
LOSS_RTOL = 1e-6
#: each gradient leaf, the moments and the parameters after a step: within
#: this fraction of the largest |value| of the whole tree
GRAD_RTOL = 2e-5
#: and within this fraction of the leaf's own largest |value|, so that a
#: small leaf (the router, a norm scale, a bias, Mamba2's decay) is held as
#: tightly as the embedding (the largest seen: 2.3e-5, Mamba2's ``A_log``
#: in ``nu``, which squares the gradient)
LEAF_RTOL = 5e-5
#: a leaf whose largest |value| is below this fraction of the tree's holds
#: f32 noise about a true 0, which GRAD_RTOL alone holds.  Only the key
#: biases of a model without rotary positions fall under it (the enc-dec's
#: ``attn/bk`` and ``cross/bk``, at 1e-8 of the tree in the gradient): a
#: bias that every key shares shifts each softmax row by a constant
NOISE_FLOOR = 1e-6
#: the plain attention in f32; in bf16, 2^-7 of the largest |output|
ATTN_F32_TOL = 2e-6
ATTN_BF16_REL = 2.0**-7
#: M = 2 microbatches against one batch: the same sums split in two, f32
MICRO_RTOL = 1e-5
#: the step's optimizer (see the module docstring and
#: :func:`check_train_parity`)
OPT = dict(learning_rate=1e-3, warmup_steps=0, eps=1e-3, grad_clip_norm=1e9)
OPT_B1 = JaxOptimizerConfig().b1

_JAX_FLAGS = ("jax_enable_x64", "jax_default_matmul_precision")
#: pytest's own variable, rewritten at every phase of every test
_PYTEST_VAR = "PYTEST_CURRENT_TEST"
#: set by torch itself when ``torch._dynamo`` is first imported (the
#: non-reentrant checkpoint imports it): put back, not a failure
_TORCH_VARS = ("TORCHINDUCTOR_CACHE_DIR",)


def _snapshot():
    return {
        "jax": {f: getattr(jax.config, f) for f in _JAX_FLAGS},
        "dtype": torch.get_default_dtype(),
        "deterministic": (torch.are_deterministic_algorithms_enabled(),
                          torch.is_deterministic_algorithms_warn_only_enabled()),
        "torch_rng": torch.get_rng_state(),
        "np_rng": np.random.get_state(),
        "py_rng": random.getstate(),
        "environ": {k: v for k, v in os.environ.items() if k != _PYTEST_VAR},
        "cwd": os.getcwd(),
    }


def _env(s) -> dict:
    return {k: v for k, v in s["environ"].items() if k not in _TORCH_VARS}


def _changed(before, after) -> list[str]:
    out = [k for k in ("jax", "dtype", "deterministic", "cwd", "py_rng")
           if before[k] != after[k]]
    if _env(before) != _env(after):
        out.append("environ")
    if not torch.equal(before["torch_rng"], after["torch_rng"]):
        out.append("torch_rng")
    if not all(np.array_equal(a, b) for a, b in zip(before["np_rng"], after["np_rng"])):
        out.append("np_rng")
    return out


def _restore(s, changed: list[str]) -> None:
    if "jax" in changed:
        for f, v in s["jax"].items():
            jax.config.update(f, v)
    if "dtype" in changed:
        torch.set_default_dtype(s["dtype"])
    if "deterministic" in changed:
        torch.use_deterministic_algorithms(s["deterministic"][0],
                                           warn_only=s["deterministic"][1])
    if "torch_rng" in changed:
        torch.set_rng_state(s["torch_rng"])
    if "np_rng" in changed:
        np.random.set_state(s["np_rng"])
    if "py_rng" in changed:
        random.setstate(s["py_rng"])
    if "environ" in changed or any(os.environ.get(k) != s["environ"].get(k)
                                   for k in _TORCH_VARS):
        for k in [k for k in os.environ if k != _PYTEST_VAR and k not in s["environ"]]:
            del os.environ[k]
        os.environ.update(s["environ"])
    if "cwd" in changed:
        os.chdir(s["cwd"])


@pytest.fixture(autouse=True)
def global_state_unchanged():
    """Save the process-wide state a training test could touch, put back
    whatever the test changed, and fail the test if it changed anything."""
    before = _snapshot()
    yield
    changed = _changed(before, _snapshot())
    _restore(before, changed)
    assert not changed, f"the test changed process-wide state: {changed}"


# -- the harness ---------------------------------------------------------------


def _perturb_constants(tree, rng):
    def f(x):
        x = np.array(x, np.float32)
        if x.size > 1 and (np.all(x == 1) or np.all(x == 0)):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree.map(f, tree)


def make_setup(arch: str, batch: int = 2, seq: int = 16, seed: int = 0):
    """(jax cfg, port cfg, JAX parameters as numpy, port f32 parameters,
    JAX batch, port batch) for ``arch`` reduced: tokens and labels (the
    next token, -1 at the last position and at a few random ones), a VLM's
    patches at 0.02 and an enc-dec's frames, all from ``seed``."""
    jcfg, pcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    specs = jax_build_model(jcfg, remat="none").param_specs()
    tree = _perturb_constants(
        jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(seed), specs)), rng)
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    toks = rng.integers(0, pcfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((batch, 1), np.int32)], 1)
    labels[rng.random(labels.shape) < 0.1] = -1
    arrays = {"tokens": toks, "labels": labels}
    if pcfg.family == "vlm":
        arrays["patches"] = (0.02 * rng.standard_normal(
            (batch, pcfg.n_vision_tokens, pcfg.d_model))).astype(np.float32)
    if pcfg.family == "encdec":
        arrays["frames"] = rng.standard_normal(
            (batch, pcfg.encoder_seq, pcfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    pbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in arrays.items()}
    return jcfg, pcfg, tree, params, jbatch, pbatch


def port_setup(arch: str, batch: int = 2, seq: int = 16, seed: int = 0):
    """(port cfg, f32 parameters from ``init_params``, batch) for
    ``arch`` reduced, without the reference: for the port's own checks."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    out = {"tokens": toks,
           "labels": torch.cat([toks[:, 1:], torch.full((batch, 1), -1)], 1)}
    if cfg.family == "vlm":
        out["patches"] = 0.02 * torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                                            generator=gen)
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen)
    return cfg, params, out


def stack_grads(grads):
    """``loss_and_grads``' gradients with every per-layer list stacked back
    to its leaf's shape."""
    if isinstance(grads, dict):
        return {k: stack_grads(v) for k, v in grads.items()}
    return torch.stack(grads) if isinstance(grads, list) else grads


def port_leaves(tree, family: str, ref):
    """(path, port tensor, reference array) over the port's tree, the
    reference's leaf found by the bridge's renaming."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        r = ref
        for k in _jax_path(path, family):
            r = r[k]
        out.append(("/".join(path), node.detach().numpy(), np.asarray(r)))

    walk(tree, ())
    return out


def assert_tree_close(tree, family: str, ref, rtol: float, what: str) -> None:
    """Every leaf within ``rtol`` of the tree's largest |value| and, unless
    it is a NOISE_FLOOR leaf, within LEAF_RTOL of its own."""
    pairs = port_leaves(tree, family, ref)
    scale = max(float(np.abs(r).max()) for _, _, r in pairs)
    for path, got, want in pairs:
        assert got.shape == want.shape, (what, path)
        err = float(np.abs(got - want).max())
        assert err <= rtol * scale, f"{what} {path}: {err:.3g} > {rtol} x {scale:.3g}"
        leaf = float(np.abs(want).max())
        if leaf < NOISE_FLOOR * scale:
            assert family == "encdec" and path.endswith(("attn/bk", "cross/bk")), (
                f"{what} {path}: {leaf:.3g} is under the noise floor of {scale:.3g}")
            continue
        assert err <= LEAF_RTOL * leaf, f"{what} {path}: {err:.3g} > {LEAF_RTOL} x {leaf:.3g}"


def check_train_parity(arch: str, seq: int = 16) -> None:
    """The loss, its metrics and every gradient leaf, then one AdamW step
    (parameters, moments, step, learning rate, gradient norm), against
    one step of the reference's jitted ``make_train_step`` in f32.  The
    reference's gradients are read from its first moments: from zero they
    are ``(1 - b1) g`` exactly rounded, and no clipping scales ``g`` at
    ``grad_clip_norm`` 1e9."""
    jcfg, pcfg, tree, params, jbatch, pbatch = make_setup(arch, seq=seq)
    jmodel = jax_build_model(jcfg, remat="none", attn_impl="naive")
    jtcfg = JaxTrainConfig(compute_dtype=jnp.float32, optimizer=JaxOptimizerConfig(**OPT))
    ptcfg = TrainConfig(compute_dtype=torch.float32, optimizer=OptimizerConfig(**OPT))
    jparams = jax.tree.map(jnp.asarray, tree)
    jp1, jopt, jmet = jax.jit(jax_make_train_step(jmodel, jcfg, jtcfg))(
        jparams, jax_init_opt_state(jparams), jbatch)
    jgrads = jax.tree.map(lambda m: np.asarray(m, np.float64) / (1 - OPT_B1), jopt.mu)

    model = build_model(pcfg, remat="none")
    total, met, grads = loss_and_grads(make_loss_fn(model, pcfg, ptcfg), params, pbatch)
    assert set(met) | {"lr", "grad_norm"} == set(jmet)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=LOSS_RTOL)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL, err_msg=k)
    assert_tree_close(stack_grads(grads), pcfg.family, jgrads, GRAD_RTOL, "grad")

    p1, opt, m1 = make_train_step(model, pcfg, ptcfg)(params, init_opt_state(params), pbatch)
    assert int(opt.step) == int(jopt.step) == 1 and opt.step.dtype == torch.int32
    np.testing.assert_allclose(float(m1["lr"]), float(jmet["lr"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=GRAD_RTOL)
    assert_tree_close(p1, pcfg.family, jp1, GRAD_RTOL, "params after a step")
    assert_tree_close(opt.mu, pcfg.family, jopt.mu, GRAD_RTOL, "mu")
    assert_tree_close(opt.nu, pcfg.family, jopt.nu, GRAD_RTOL, "nu")


def _port_grads(cfg, remat: str, batch: dict, params):
    tcfg = TrainConfig(compute_dtype=torch.float32)
    total, _, grads = loss_and_grads(make_loss_fn(build_model(cfg, remat=remat), cfg, tcfg),
                                     params, batch)
    return total, list(torch.utils._pytree.tree_leaves(stack_grads(grads)))


def check_remat_bits(arch: str) -> None:
    """``none``, ``full`` and ``dots`` recompute what they drop with the
    same operations on the same inputs: the loss and every gradient are
    bit-equal."""
    cfg, params, batch = port_setup(arch)
    base_total, base = _port_grads(cfg, "none", batch, params)
    for remat in ("full", "dots"):
        total, grads = _port_grads(cfg, remat, batch, params)
        assert torch.equal(total, base_total), remat
        assert len(grads) == len(base)
        for a, b in zip(grads, base):
            assert torch.equal(a, b), remat


def check_microbatches(arch: str) -> None:
    """M = 2 (each row's labels weigh the same in both halves) gives the
    full batch's gradients, loss and parameters after a step, in f32.  The
    MoE aux loss is a product of means over the batch, so two halves'
    mean differs from the whole's by design: the MoE case weighs it 0."""
    cfg, params, batch = port_setup(arch, batch=4)
    cfg = cfg.replace(router_aux_weight=0.0)
    model = build_model(cfg, remat="none")
    out = []
    for m in (1, 2):
        p = torch.utils._pytree.tree_map(torch.clone, params)
        tcfg = TrainConfig(compute_dtype=torch.float32, microbatches=m,
                           optimizer=OptimizerConfig(**OPT))
        out.append(make_train_step(model, cfg, tcfg)(p, init_opt_state(p), batch))
    (p1, o1, m1), (p2, o2, m2) = out
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=MICRO_RTOL, err_msg=k)
    for tree1, tree2 in ((p1, p2), (o1.mu, o2.mu), (o1.nu, o2.nu)):
        a, b = (torch.utils._pytree.tree_leaves(t) for t in (tree1, tree2))
        scale = max(float(x.abs().max()) for x in a)
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= MICRO_RTOL * scale


# -- the attention and the dots policy ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,prefix,q_offset,sq,sk,h,kh", [
    (True, 5, 0, 13, 13, 8, 2), (True, 0, 7, 6, 13, 4, 4), (False, 0, 0, 9, 21, 4, 2),
    (True, 13, 0, 13, 13, 4, 1)])
def test_naive_attention_matches_the_reference(causal, prefix, q_offset, sq, sk, h, kh,
                                               dtype):
    rng = np.random.default_rng(sq * sk + prefix)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, sq, h, 16), (2, sk, kh, 16), (2, sk, kh, 16)))
    jmask = jattn.make_causal_mask(sq, sk, prefix, q_offset) if causal else None
    pmask = attn.make_causal_mask(sq, sk, prefix, q_offset) if causal else None
    if causal:
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    jd, pd = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jattn.naive_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), jmask, 0.25).astype(jnp.float32))
    got = attn.naive_attention(*(torch.from_numpy(a).to(pd) for a in (q, k, v)),
                               pmask, 0.25).float().numpy()
    tol = ATTN_F32_TOL if dtype == "float32" else ATTN_BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_plain_products_and_recomputes_batched_ones():
    """In the backward pass ``full`` recomputes every block's products,
    ``dots`` only the batched ones (the attention's einsums) and the rest
    around them, never a plain matrix product."""
    cfg, params, batch = port_setup("qwen3-4b")
    counts = {}
    for remat in ("none", "full", "dots"):
        view, leaves = grad_leaves(params)
        total, _ = make_loss_fn(build_model(cfg, remat=remat), cfg,
                                TrainConfig(compute_dtype=torch.float32))(view, batch)
        with _CountOps() as ops:
            torch.autograd.grad(total, leaves)
        counts[remat] = ops.n
    mm = {r: c.get("mm", 0) for r, c in counts.items()}
    bmm = {r: c.get("bmm", 0) for r, c in counts.items()}
    assert mm["dots"] == mm["none"] < mm["full"], mm
    assert bmm["none"] < bmm["dots"] == bmm["full"], bmm




@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "minicpm3-4b", "paligemma-3b",
                                  "mamba2-2.7b", "zamba2-7b", "whisper-large-v3"])
def test_stacked_keys_are_the_reference_layer_stacks(arch):
    """``params.STACKED``, the top-level keys that ``train.step``
    differentiates a layer at a time, holds exactly the port's leaves whose
    reference leaf has a ``layers`` axis first."""
    jcfg, pcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jspecs = jax_build_model(jcfg, remat="none").param_specs()
    seen = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        spec = jspecs
        for k in _jax_path(path, pcfg.family):
            spec = spec[k]
        seen.append(path[0])
        assert (path[0] in STACKED) == (spec.axes[0] == "layers"), (path, spec.axes)

    walk(param_specs(pcfg), ())
    assert set(seen) & STACKED
