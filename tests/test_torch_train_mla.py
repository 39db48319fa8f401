"""Training of the MLA family in the port against the JAX package, on the
CPU: reduced minicpm3-4b (the query bottleneck, decompressed K and V) in
f32, through the harness of
``test_torch_train_common.py``: the loss and its metrics, every gradient
leaf, one AdamW step; the three remat policies
bit-equal; two microbatches against one batch."""

from test_torch_train_common import (  # noqa: F401
    check_microbatches,
    check_remat_bits,
    check_train_parity,
    global_state_unchanged,
)


def test_mla_training_matches_the_reference():
    check_train_parity("minicpm3-4b")


def test_remat_policies_give_bit_equal_gradients():
    check_remat_bits("minicpm3-4b")


def test_two_microbatches_equal_one_batch():
    check_microbatches("minicpm3-4b")
