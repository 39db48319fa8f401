"""Model configuration schema: the port's copy of the dense, MLA, MoE, SSM,
hybrid, enc-dec and VLM parts of ``repro/configs/base.py`` (the JAX
package's ``ModelConfig``)."""

from __future__ import annotations

import dataclasses
from typing import Any


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "silu"  # silu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    pos_emb: str = "rope"  # rope | learned

    # --- MLA (multi-head latent attention) ---------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0  # 0 -> no q compression
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden
    first_k_dense: int = 0      # leading dense layers (deepseek-v2)
    dense_d_ff: int = 0         # hidden of those dense layers
    router_aux_weight: float = 0.001  # the Switch aux loss's weight in training
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # --- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0  # apply the shared attention block every N layers

    # --- enc-dec (whisper) -----------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0        # frontend-stub frame count

    # --- VLM (paligemma) --------------------------------------------------------
    n_vision_tokens: int = 0    # the patch embeddings prepended to a prompt
    embed_scale: bool = False   # gemma: scale embeddings by sqrt(d_model)

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's TP-16 rule)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's rule)."""
        kw: dict[str, Any] = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
        )
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.family == "hybrid":
            kw.update(n_layers=4, shared_attn_every=2)
        if self.n_experts:
            kw.update(n_experts=8, n_experts_per_token=2, moe_d_ff=64,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_k_dense=min(self.first_k_dense, 1), dense_d_ff=128)
        if self.use_mla:
            kw.update(q_lora_rank=32 if self.q_lora_rank else 0,
                      kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16)
        if self.family == "encdec":
            kw.update(n_encoder_layers=2, encoder_seq=32)
        if self.family == "vlm":
            kw.update(n_vision_tokens=8)
        return self.replace(**kw)
