"""Training of the enc-dec family in the port against the JAX package, on
the CPU: reduced whisper-large-v3 in f32 (the encoder over 32 frames, the
decoder's causal self-attention and its cross-attention over the encoder's
output, learned positions, LayerNorms, biased MLPs), through the harness of
``test_torch_train_common.py``: the loss and its metrics, every gradient
leaf (the key biases' true gradients are 0: their f32 noise is held to the
tree's scale), one AdamW step; the three remat policies
bit-equal; two microbatches against one batch."""

from test_torch_train_common import (  # noqa: F401
    check_microbatches,
    check_remat_bits,
    check_train_parity,
    global_state_unchanged,
)


def test_encdec_training_matches_the_reference():
    check_train_parity("whisper-large-v3")


def test_remat_policies_give_bit_equal_gradients():
    check_remat_bits("whisper-large-v3")


def test_two_microbatches_equal_one_batch():
    check_microbatches("whisper-large-v3")
