"""deepseek-v2-236b [moe] — 60L d_model=5120 128H expert_ff=1536
vocab=102400; MLA kv_lora=512, 2 shared + 160 routed experts top-6,
first layer dense [arXiv:2405.04434].  Its bf16 weights (~472 GB) exceed
one card: the port serves it reduced only."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,               # per-expert hidden (as assigned)
    moe_d_ff=1536,
    vocab_size=102_400,
    n_experts=160,
    n_experts_per_token=6,
    n_shared_experts=2,
    first_k_dense=1,
    dense_d_ff=12_288,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,            # qk_nope + qk_rope
    rope_theta=10_000.0,
)
