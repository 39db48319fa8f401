"""Training of the dense family in the port against the JAX package, on the
CPU: reduced qwen3-4b (qk-norm, tied embedding) and qwen2.5-32b (q/k/v
biases, untied unembedding) in f32, through the harness of
``test_torch_train_common.py``: the loss and its metrics, every gradient
leaf, one AdamW step; the three remat policies
bit-equal; two microbatches against one batch."""

import pytest

from test_torch_train_common import (  # noqa: F401
    check_microbatches,
    check_remat_bits,
    check_train_parity,
    global_state_unchanged,
)


ARCHS = ("qwen3-4b", "qwen2.5-32b")


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_training_matches_the_reference(arch):
    check_train_parity(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_bit_equal_gradients(arch):
    check_remat_bits(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_microbatches_equal_one_batch(arch):
    check_microbatches(arch)
