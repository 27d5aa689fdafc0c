"""Configurations: ``base`` (dataclasses), ``surf_paper`` (SURF presets),
``shapes`` (the four input shapes) and the ten LLM architectures, with
the registry ``get_config('<arch-id>')`` (the port's copy of
``repro.configs``)."""
from repro_torch.configs.base import (ArchConfig, AttnConfig, MoEConfig,
                                      SSMConfig, ShapeConfig, SURFConfig)
from repro_torch.configs.shapes import SHAPES, get_shape

from repro_torch.configs import (qwen2_72b, qwen3_4b, jamba_1_5_large_398b,
                                 llama4_scout_17b_a16e, qwen1_5_32b,
                                 rwkv6_1_6b, whisper_small, deepseek_moe_16b,
                                 chameleon_34b, gemma3_27b, surf_paper)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_72b, qwen3_4b, jamba_1_5_large_398b,
              llama4_scout_17b_a16e, qwen1_5_32b, rwkv6_1_6b, whisper_small,
              deepseek_moe_16b, chameleon_34b, gemma3_27b)
}

ARCH_IDS = tuple(sorted(ARCHS))


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchConfig", "AttnConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "SURFConfig", "SHAPES", "get_shape", "ARCHS",
           "ARCH_IDS", "get_config", "surf_paper"]
