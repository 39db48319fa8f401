"""Architecture registry of the port: the models it serves so far."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from repro_torch.configs.mamba2_27b import CONFIG as MAMBA2_27B
from repro_torch.configs.minicpm3_4b import CONFIG as MINICPM3_4B
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.qwen3_4b import CONFIG as QWEN3_4B
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from repro_torch.configs.qwen15_110b import CONFIG as QWEN15_110B
from repro_torch.configs.qwen25_32b import CONFIG as QWEN25_32B
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

ARCHS: dict[str, ModelConfig] = {
    QWEN3_4B.name: QWEN3_4B,
    MAMBA2_27B.name: MAMBA2_27B,
    QWEN3_MOE_30B_A3B.name: QWEN3_MOE_30B_A3B,
    QWEN25_32B.name: QWEN25_32B,
    QWEN15_110B.name: QWEN15_110B,
    ZAMBA2_7B.name: ZAMBA2_7B,
    MINICPM3_4B.name: MINICPM3_4B,
    DEEPSEEK_V2_236B.name: DEEPSEEK_V2_236B,
    WHISPER_LARGE_V3.name: WHISPER_LARGE_V3,
    PALIGEMMA_3B.name: PALIGEMMA_3B,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
