"""Training of the Mamba2 family in the port against the JAX package, on
the CPU: reduced mamba2-2.7b in f32 over 32 tokens (two SSD chunks of 16,
the plain ``ssd_chunked``, never the kernel) through the harness of
``test_torch_train_common.py`` (the loss and its metrics, every gradient
leaf, one AdamW step; the three remat policies
bit-equal; two microbatches against one batch); and a length that is not a multiple of the chunk,
which the reference refuses and the port pads with ``dt = 0``: the port's
training logits over 20 tokens equal the reference's first 20 positions
of a 32-token forward (the model is causal)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model import build_model as jax_build_model
from repro_torch.models import build_model
from test_torch_train_common import (  # noqa: F401
    check_microbatches,
    check_remat_bits,
    check_train_parity,
    global_state_unchanged,
    make_setup,
)

ARCH = "mamba2-2.7b"
#: f32 logits through two layers, sums in other orders
LOGIT_TOL = 2e-5


def test_mamba_training_matches_the_reference():
    check_train_parity(ARCH, seq=32)


def test_ragged_length_is_the_causal_prefix_of_a_whole_chunk_run():
    jcfg, pcfg, tree, params, jbatch, pbatch = make_setup(ARCH, seq=32)
    want, _ = jax_build_model(jcfg, remat="none").forward(
        jax.tree.map(jnp.asarray, tree), {"tokens": jbatch["tokens"]}, dtype=jnp.float32)
    got, aux = build_model(pcfg).forward(params, {"tokens": pbatch["tokens"][:, :20]},
                                         dtype=torch.float32)
    assert got.shape == (2, 20, pcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:, :20],
                               atol=LOGIT_TOL, rtol=0)


def test_remat_policies_give_bit_equal_gradients():
    check_remat_bits("mamba2-2.7b")


def test_two_microbatches_equal_one_batch():
    check_microbatches("mamba2-2.7b")
