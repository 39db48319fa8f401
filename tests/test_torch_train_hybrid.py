"""Training of the hybrid family in the port against the JAX package, on
the CPU: reduced zamba2-7b in f32 (two groups of two Mamba2 blocks, each
group followed by the shared attention block with its own application
norm) over 32 tokens, two SSD chunks, through the harness of
``test_torch_train_common.py``: the loss and its metrics, every gradient
leaf, one AdamW step; the three remat policies
bit-equal; two microbatches against one batch."""

from test_torch_train_common import (  # noqa: F401
    check_microbatches,
    check_remat_bits,
    check_train_parity,
    global_state_unchanged,
)


def test_hybrid_training_matches_the_reference():
    check_train_parity("zamba2-7b", seq=32)


def test_remat_policies_give_bit_equal_gradients():
    check_remat_bits("zamba2-7b")


def test_two_microbatches_equal_one_batch():
    check_microbatches("zamba2-7b")
