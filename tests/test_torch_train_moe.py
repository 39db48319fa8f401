"""Training of the MoE family in the port against the JAX package, on the
CPU: the layer's Switch aux loss against the reference's ``moe_block``
(capacity drops exercised; the output bit-equal with and without the aux,
so the serving path computes what it did), and reduced qwen3-moe-30b-a3b in
f32 (``router_aux_weight`` times the aux in the total, ``moe_aux`` among
the metrics) through the harness of ``test_torch_train_common.py``: the
loss and its metrics, every gradient leaf (the router's through the
weights and the aux), one AdamW step; the three remat policies
bit-equal; two microbatches against one batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models import params as jax_pm
from repro_torch.configs import get_config
from repro_torch.models import moe
from test_torch_train_common import (  # noqa: F401
    check_microbatches,
    check_remat_bits,
    check_train_parity,
    global_state_unchanged,
)

ARCH = "qwen3-moe-30b-a3b"
#: f32, the same sums in another order
AUX_RTOL = 1e-6
OUT_TOL = 1e-5


@pytest.mark.parametrize("s", [12, 40])
def test_switch_aux_matches_the_reference(s):
    cfg, pcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    specs = jax_moe.moe_specs(cfg)
    jp = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(s), specs))
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    rng = np.random.default_rng(s)
    # hidden states sharing a direction, so some experts' queues overflow
    x = (rng.standard_normal((2, s, cfg.d_model))
         + 2.0 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    want, want_aux = jax_moe.moe_block(jax.tree.map(jnp.asarray, jp), cfg, jnp.asarray(x))
    got, aux = moe.moe_block(tp, pcfg, torch.from_numpy(x), return_aux=True)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_TOL, rtol=OUT_TOL)
    assert torch.equal(moe.moe_block(tp, pcfg, torch.from_numpy(x)), got)
    _, _, mask, keep, _ = moe.route(tp, pcfg, torch.from_numpy(x))
    assert int((mask & ~keep).sum()) > 0  # the drops were exercised


def test_moe_training_matches_the_reference():
    check_train_parity(ARCH)


def test_remat_policies_give_bit_equal_gradients():
    check_remat_bits("qwen3-moe-30b-a3b")


def test_two_microbatches_equal_one_batch():
    check_microbatches("qwen3-moe-30b-a3b")
