from repro_torch.models.model import (
    HybridCache,
    HybridLM,
    KVCache,
    MambaLM,
    MLACache,
    PagedKVCache,
    PageTables,
    TransformerLM,
    build_model,
)
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.ssm import SSMCache

__all__ = [
    "HybridCache",
    "HybridLM",
    "KVCache",
    "MLACache",
    "MambaLM",
    "PageTables",
    "PagedKVCache",
    "SSMCache",
    "TransformerLM",
    "build_model",
    "init_params",
    "params_from_jax",
]
