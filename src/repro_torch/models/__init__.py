from repro_torch.models.model import KVCache, PagedKVCache, PageTables, TransformerLM
from repro_torch.models.params import init_params, params_from_jax

__all__ = [
    "KVCache",
    "PageTables",
    "PagedKVCache",
    "TransformerLM",
    "init_params",
    "params_from_jax",
]
