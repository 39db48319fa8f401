"""Training of the VLM family in the port against the JAX package, on the
CPU: reduced paligemma-3b in f32 (the patches ahead of the tokens under the
prefix-LM mask, the scaled token embedding, the logits cut past the
patches before the loss), through the harness of
``test_torch_train_common.py``: the loss and its metrics, every gradient
leaf, one AdamW step; the three remat policies
bit-equal; two microbatches against one batch."""

from test_torch_train_common import (  # noqa: F401
    check_microbatches,
    check_remat_bits,
    check_train_parity,
    global_state_unchanged,
)


def test_vlm_training_matches_the_reference():
    check_train_parity("paligemma-3b")


def test_remat_policies_give_bit_equal_gradients():
    check_remat_bits("paligemma-3b")


def test_two_microbatches_equal_one_batch():
    check_microbatches("paligemma-3b")
