"""Configurations: ``base`` (dataclasses), ``surf_paper`` (SURF presets)
and the LLM architectures the port serves, the encoder-decoder
whisper-small among them, with the registry ``get_config('<arch-id>')``.

The registry holds the ported archs only. The reference's other archs
(those that need more than one card) raise a ``KeyError`` that names the
ROADMAP item (queue 1) that ports what they need."""
from repro_torch.configs import (deepseek_moe_16b, gemma3_27b,
                                 jamba_1_5_large_398b, llama4_scout_17b_a16e,
                                 qwen3_4b, rwkv6_1_6b, whisper_small)
from repro_torch.configs.base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (qwen3_4b, rwkv6_1_6b, gemma3_27b, deepseek_moe_16b,
                   llama4_scout_17b_a16e, jamba_1_5_large_398b,
                   whisper_small)}

ARCH_IDS = tuple(sorted(ARCHS))

# The reference's archs that the port does not serve yet, with the ROADMAP
# queue 1 item each waits for.
UNPORTED = {
    "qwen2-72b": "item 18 (sharding: more than one card even in bf16)",
    "qwen1.5-32b": "item 18 (sharding: more than one card in f32)",
    "chameleon-34b": "item 18 (sharding: more than one card in f32)",
}


def get_config(name: str) -> ArchConfig:
    if name in UNPORTED:
        raise KeyError(f"arch {name!r} is not ported yet: ROADMAP queue 1 "
                       f"{UNPORTED[name]}; ported: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ARCH_IDS", "UNPORTED", "get_config"]
