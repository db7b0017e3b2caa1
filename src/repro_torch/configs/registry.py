"""Architecture registry of the port: --arch <id> -> ModelConfig.  It names
only the architectures whose every block kind the port runs."""
from __future__ import annotations

from .base import ModelConfig
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .gemma2_9b import CONFIG as gemma2_9b
from .gemma3_1b import CONFIG as gemma3_1b
from .gemma_2b import CONFIG as gemma_2b
from .llama4_maverick_400b_a17b import CONFIG as llama4_maverick_400b_a17b
from .qwen2_7b import CONFIG as qwen2_7b
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [gemma_2b, gemma3_1b, gemma2_9b, qwen2_7b, falcon_mamba_7b,
                        qwen3_moe_235b_a22b, llama4_maverick_400b_a17b, zamba2_7b]
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
