"""The port's checkpoints and crash-resume against the JAX package's, on the
CPU (every checkpoint under ``tmp_path``): the cases of
``tests/test_ft_ckpt.py`` (a round trip, a checksum mismatch that raises,
rotation, a crash and a resume bit-equal to the uninterrupted run, the
template's dtype and shape); ``(params, AdamWState)`` of reduced models
of several families saved by the port and restored by the reference, and
the other way; what a bfloat16 leaf does on each side; and
``simulate_training`` through the port's ``make_train_step`` on reduced
qwen3-4b, crashed at step 3 and resumed, bit-equal to the uninterrupted
run and within tolerance of the reference's run."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.ft import simulate_training as jax_simulate_training
from repro.models.model import build_model as jax_build_model
from repro.train import AdamWState as JaxAdamWState
from repro.train import OptimizerConfig as JaxOptimizerConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.ckpt import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ft import simulate_training
from repro_torch.models import build_model
from repro_torch.models.params import _jax_path
from repro_torch.train import (
    AdamWState,
    OptimizerConfig,
    TrainConfig,
    init_opt_state,
    make_train_step,
)
from test_torch_train_common import (  # noqa: F401
    OPT,
    global_state_unchanged,
    make_setup,
    port_leaves,
)

#: the port against the reference after 6 steps in f32 (eps 1e-3: see
#: test_torch_train_common.py), as a fraction of the largest |parameter|
RUN_RTOL = 1e-4
N_STEPS, CRASH_AT, CKPT_EVERY = 6, 3, 2


def test_ckpt_roundtrip_and_checksum(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    cdir = save_checkpoint(str(tmp_path), 5, tree, extra={"note": "x"})
    out, mani = restore_checkpoint(str(tmp_path), template=tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32 and mani["extra"]["note"] == "x"
    assert sorted(mani["leaves"]) == ["a", "b/c"]
    flat, _ = restore_checkpoint(str(tmp_path))  # no template: name -> tensor
    assert torch.equal(flat["b/c"], tree["b"]["c"])
    assert not os.path.exists(cdir + ".tmp")

    # corrupt a tensor file: the restore must fail its checksum
    victim = [f for f in os.listdir(cdir) if f.endswith(".npy")][0]
    with open(os.path.join(cdir, victim), "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\xff")
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), template=tree)
    restore_checkpoint(str(tmp_path), template=tree, verify=False)
    with pytest.raises(FileExistsError):
        save_checkpoint(str(tmp_path), 5, tree)


def test_ckpt_manager_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=2)
    tree = {"w": torch.zeros(3)}
    for step in range(1, 9):
        tree = {"w": tree["w"] + 1}
        mgr.maybe_save(step, tree)
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step-"))
    assert steps == [6, 8]
    assert latest_step(str(tmp_path)) == 8
    assert latest_step(str(tmp_path / "none")) is None
    out, mani = mgr.restore_latest(template=tree)
    assert mani["step"] == 8 and torch.equal(out["w"], torch.full((3,), 8.0))


def test_crash_restart_bitwise_equivalence(tmp_path):
    def step(state, batch):
        return {"w": state["w"] * 1.5 + batch}

    init = {"w": torch.tensor([1.0, -2.0, 3.0])}
    batches = [float(i) for i in range(1, 9)]
    ref = simulate_training(step, init, batches, ckpt_dir=str(tmp_path / "a"))
    crashed = simulate_training(step, init, batches, ckpt_dir=str(tmp_path / "b"),
                                crash_at_step=5)
    assert crashed is None and latest_step(str(tmp_path / "b")) == 4
    resumed = simulate_training(step, init, batches, ckpt_dir=str(tmp_path / "b"))
    assert torch.equal(ref["w"], resumed["w"])


def test_restore_template_dtype_and_shape(tmp_path):
    """Restore casts to the template's dtype (f32 master to bf16 serving)
    and refuses a template of another shape or a leaf the file lacks."""
    save_checkpoint(str(tmp_path), 1, {"w": torch.arange(8.0)})
    out, _ = restore_checkpoint(str(tmp_path),
                                template={"w": torch.empty(8, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], torch.arange(8.0).to(torch.bfloat16))
    meta, _ = restore_checkpoint(str(tmp_path),
                                 template={"w": torch.empty(8, device="meta")})
    assert meta["w"].device.type == "cpu"
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), template={"w": torch.empty(4)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), template={"v": torch.empty(8)})


def _jax_state(tree, rng):
    """The reference's (params, AdamWState) with random moments at step 3."""
    rand = lambda x: rng.standard_normal(np.shape(x)).astype(np.float32)  # noqa: E731
    return (tree, JaxAdamWState(step=np.int32(3), mu=jax.tree.map(rand, tree),
                                nu=jax.tree.map(rand, tree)))


def _port_like(tree, family, ref):
    """``tree``'s structure with each leaf's values taken from the
    reference's tree ``ref``, through the bridge's renaming."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        r = ref
        for k in _jax_path(path, family):
            r = r[k]
        return torch.from_numpy(np.array(r))

    return walk(tree, ())


def _assert_state_equal(port_state, jax_state, family):
    (pp, opt), (jp, jopt) = port_state, jax_state
    assert int(opt.step) == int(jopt.step) and opt.step.dtype == torch.int32
    for tree, ref in ((pp, jp), (opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        for path, got, want in port_leaves(tree, family, ref):
            assert got.dtype == want.dtype and np.array_equal(got, want), path


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "qwen3-moe-30b-a3b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_checkpoints_cross_between_the_frameworks(arch, tmp_path):
    """The port's ``CheckpointManager`` given the model's family writes
    each leaf under the reference's name, so the reference's restore takes
    a port checkpoint into its own template, and the port's restore takes a
    reference checkpoint into the port's tree; every leaf bit for bit both
    ways."""
    _, cfg, tree, params, _, _ = make_setup(arch)
    jstate = _jax_state(tree, np.random.default_rng(5))
    port_state = (params, AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        mu=_port_like(params, cfg.family, jstate[1].mu),
        nu=_port_like(params, cfg.family, jstate[1].nu)))

    CheckpointManager(str(tmp_path / "port"), every=1, family=cfg.family).maybe_save(
        3, port_state)
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
                            jstate)
    restored, _ = jax_restore(str(tmp_path / "port"), template=template)
    _assert_state_equal(port_state, jax.tree.map(np.asarray, restored), cfg.family)

    jax_save(str(tmp_path / "jax"), 3, jax.tree.map(jnp.asarray, jstate))
    tmpl = (params, init_opt_state(params))
    back, mani = CheckpointManager(str(tmp_path / "jax"), family=cfg.family).restore_latest(
        template=tmpl)
    assert isinstance(back[1], AdamWState) and mani["step"] == 3
    _assert_state_equal(back, jstate, cfg.family)


def test_bf16_leaves(tmp_path):
    """The port writes a bfloat16 leaf as its exact f32 values (numpy has no
    bfloat16): a bfloat16 template gets the same bits back in the port and
    in the reference.  The reference writes bfloat16 as raw 2-byte records
    (``|V2``), which its own restore cannot cast back; the port reads them
    bit for bit, with or without a template."""
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    cdir = save_checkpoint(str(tmp_path / "port"), 1, {"w": w})
    with open(os.path.join(cdir, "manifest.json")) as f:
        assert json.load(f)["leaves"]["w"]["dtype"] == "float32"
    out, _ = restore_checkpoint(str(tmp_path / "port"),
                                template={"w": torch.empty(5, 3, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], w)
    jout, _ = jax_restore(str(tmp_path / "port"),
                          template={"w": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16)})
    assert np.array_equal(np.asarray(jout["w"]).view(np.int16), w.view(torch.int16).numpy())

    jw = w.float().numpy().astype(ml_dtypes.bfloat16)
    jax_save(str(tmp_path / "jax"), 1, {"w": jnp.asarray(jw)})
    with pytest.raises(ValueError):
        jax_restore(str(tmp_path / "jax"),
                    template={"w": jax.ShapeDtypeStruct((5, 3), jnp.bfloat16)})
    out, _ = restore_checkpoint(str(tmp_path / "jax"),
                                template={"w": torch.empty(5, 3, dtype=torch.bfloat16)})
    assert torch.equal(out["w"], w)
    flat, _ = restore_checkpoint(str(tmp_path / "jax"))
    assert flat["w"].dtype == torch.bfloat16 and torch.equal(flat["w"], w)


def test_simulate_training_crash_and_resume(tmp_path):
    """Reduced qwen3-4b in f32, 6 steps, a checkpoint every 2: crashed
    after step 3 and resumed from step 2, the port ends bit-equal to its
    uninterrupted run; the reference's run over the same batches ends
    within ``RUN_RTOL``; and each side's ``simulate_training`` resumes
    from the other's checkpoints."""
    jcfg, cfg, tree, params, _, _ = make_setup("qwen3-4b")
    rng = np.random.default_rng(9)
    toks = [rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
            for _ in range(N_STEPS)]
    batches = [{"tokens": torch.from_numpy(t).long(),
                "labels": torch.from_numpy(np.roll(t, -1, 1)).long()} for t in toks]
    step = make_train_step(build_model(cfg, remat="none"), cfg,
                           TrainConfig(compute_dtype=torch.float32,
                                       optimizer=OptimizerConfig(**OPT)))

    def fresh():
        p = jax.tree.map(torch.clone, params)
        return (p, init_opt_state(p))

    def train(state, batch):
        return step(*state, batch)[:2]

    run = dict(ckpt_every=CKPT_EVERY, family=cfg.family)
    whole = simulate_training(train, fresh(), batches, ckpt_dir=str(tmp_path / "a"), **run)
    assert simulate_training(train, fresh(), batches, ckpt_dir=str(tmp_path / "b"),
                             crash_at_step=CRASH_AT, **run) is None
    assert latest_step(str(tmp_path / "b")) == 2
    resumed = simulate_training(train, fresh(), batches, ckpt_dir=str(tmp_path / "b"), **run)
    assert int(resumed[1].step) == int(whole[1].step) == N_STEPS
    for a, b in zip(jax.tree.leaves(whole), jax.tree.leaves(resumed)):
        assert torch.equal(a, b)

    jstep = jax.jit(jax_make_train_step(
        jax_build_model(jcfg, remat="none", attn_impl="naive"), jcfg,
        JaxTrainConfig(compute_dtype=jnp.float32, optimizer=JaxOptimizerConfig(**OPT))))
    jparams = jax.tree.map(jnp.asarray, tree)
    jbatches = [{"tokens": jnp.asarray(t), "labels": jnp.asarray(np.roll(t, -1, 1))}
                for t in toks]
    jinit = (jparams, jax_init_opt_state(jparams))

    def jtrain(state, batch):
        return jstep(*state, batch)[:2]

    jout = jax_simulate_training(jtrain, jinit, jbatches,
                                 ckpt_dir=str(tmp_path / "jax"), ckpt_every=CKPT_EVERY)
    # one naming on disk: each side's run "resumes" from the other's last
    # checkpoint (step 6 of 6) and returns it bit for bit
    _assert_state_equal(simulate_training(train, fresh(), batches,
                                          ckpt_dir=str(tmp_path / "jax"), **run),
                        jax.tree.map(np.asarray, jout), cfg.family)
    _assert_state_equal(whole, jax.tree.map(np.asarray, jax_simulate_training(
        jtrain, jinit, jbatches, ckpt_dir=str(tmp_path / "a"), ckpt_every=CKPT_EVERY)),
        cfg.family)
    pairs = port_leaves(resumed[0], cfg.family, jout[0])
    scale = max(float(np.abs(r).max()) for _, _, r in pairs)
    for path, got, want in pairs:
        assert float(np.abs(got - want).max()) <= RUN_RTOL * scale, path
