"""Architecture registry of the port: --arch <id> -> ModelConfig.  It names
every architecture of the reference's registry: the decoder LMs, the VLM
(qwen2-vl-7b) and the encoder-decoder (whisper-tiny)."""
from __future__ import annotations

from .base import ModelConfig
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .gemma2_9b import CONFIG as gemma2_9b
from .gemma3_1b import CONFIG as gemma3_1b
from .gemma_2b import CONFIG as gemma_2b
from .llama4_maverick_400b_a17b import CONFIG as llama4_maverick_400b_a17b
from .qwen2_7b import CONFIG as qwen2_7b
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .whisper_tiny import CONFIG as whisper_tiny
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [gemma_2b, gemma3_1b, gemma2_9b, qwen2_7b, falcon_mamba_7b,
                        qwen3_moe_235b_a22b, llama4_maverick_400b_a17b, zamba2_7b,
                        qwen2_vl_7b, whisper_tiny]
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
