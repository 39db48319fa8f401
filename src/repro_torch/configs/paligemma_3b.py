"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; the SigLIP frontend is a stub: a request carries its
precomputed patch embeddings (256, 2048) in ``extras["patches"]``, which
the Gemma-style decoder prepends to the prompt [arXiv:2407.07726].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    act="gelu",
    n_vision_tokens=256,     # 224px / 14px patches = 16x16
    embed_scale=True,        # gemma scales embeddings by sqrt(d_model)
    tie_embeddings=True,
    rope_theta=10_000.0,
)
