"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + shared full-attention block
[arXiv:2411.15242].  The shared attention and MLP block (one set of
weights) is applied after every 6th Mamba2 layer with per-application norm
gains: 13 applications, then a tail of 3 Mamba2 layers."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    rope_theta=10_000.0,
)
