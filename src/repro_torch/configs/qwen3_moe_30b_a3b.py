"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert_ff=768
vocab=151936, 128 experts top-8, qk_norm [hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,               # per-expert hidden (as assigned)
    moe_d_ff=768,
    vocab_size=151_936,
    n_experts=128,
    n_experts_per_token=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
