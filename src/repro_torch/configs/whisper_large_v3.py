"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed.

32L d_model=1280 20H (kv=20, full MHA) d_ff=5120 vocab=51866
[arXiv:2212.04356]. The mel/conv frontend is a stub: a request carries
pre-computed frame embeddings (1500, 1280) in ``extras["frames"]``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,             # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    act="gelu",
    qkv_bias=True,           # whisper projections carry biases
    pos_emb="learned",
    norm_eps=1e-5,
    encoder_seq=1500,        # 30s audio -> 3000 mel frames -> conv stride 2
    tie_embeddings=True,
)
