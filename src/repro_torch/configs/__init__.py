"""Architecture registry of the port: the models it serves so far."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mamba2_27b import CONFIG as MAMBA2_27B
from repro_torch.configs.qwen3_4b import CONFIG as QWEN3_4B

ARCHS: dict[str, ModelConfig] = {
    QWEN3_4B.name: QWEN3_4B,
    MAMBA2_27B.name: MAMBA2_27B,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
