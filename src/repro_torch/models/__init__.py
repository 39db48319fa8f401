from repro_torch.models.model import (
    EncDecCache,
    EncDecLM,
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
    "EncDecCache",
    "EncDecLM",
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
