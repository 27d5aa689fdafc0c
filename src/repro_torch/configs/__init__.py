"""Configurations: ``base`` (dataclasses), ``surf_paper`` (SURF presets)
and the LLM architectures the port serves, with the registry
``get_config('<arch-id>')``.

The registry holds the ported archs only. The reference's other archs
raise a ``KeyError`` that names the ROADMAP item (queue 1) that ports
what they need."""
from repro_torch.configs import gemma3_27b, qwen3_4b, rwkv6_1_6b
from repro_torch.configs.base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (qwen3_4b, rwkv6_1_6b, gemma3_27b)}

ARCH_IDS = tuple(sorted(ARCHS))

# The reference's archs that the port does not serve yet, with the ROADMAP
# queue 1 item each waits for.
UNPORTED = {
    "deepseek-moe-16b": "item 12 (MoE, models/moe.py)",
    "llama4-scout-17b-a16e": "item 12 (MoE, models/moe.py)",
    "jamba-1.5-large-398b": "item 13 (mamba; its MoE layers need item 12)",
    "whisper-small": "item 14 (enc-dec: frontend.py, encode, cross "
                     "attention)",
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
