"""Config registry: ``get_config('<arch-id>')`` for every assigned arch."""
from repro_torch.configs.base import (
    ATTN, LOCAL, RGLRU, RWKV, ModelConfig, MoEConfig, ShapeConfig, SHAPES,
    ShardingPlan, local_plan,
)

from repro_torch.configs import (
    gemma2_2b,
    gemma3_27b,
    kimi_k2,
    llava_next_7b,
    mixtral_8x7b,
    phi3_mini,
    qwen3_32b,
    recurrentgemma_9b,
    rwkv6_1p6b,
    whisper_medium,
)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        rwkv6_1p6b, mixtral_8x7b, kimi_k2, gemma2_2b, qwen3_32b,
        gemma3_27b, phi3_mini, recurrentgemma_9b, llava_next_7b,
        whisper_medium,
    )
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = [
    "ATTN", "LOCAL", "RGLRU", "RWKV", "ModelConfig", "MoEConfig",
    "ShapeConfig", "SHAPES", "ShardingPlan", "local_plan",
    "REGISTRY", "ARCH_IDS", "get_config",
]
