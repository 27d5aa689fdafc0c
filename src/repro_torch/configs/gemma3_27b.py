"""Gemma3-27B [hf:google/gemma-3 family] — dense, 5 local (sliding window
1024) : 1 global attention pattern, GQA kv=16, 128k context, huge vocab.

Layout 'gemma3': 10 superblocks of (5 local + 1 global) + 2 trailing local
layers = 62 layers exactly. In the port it serves at reduced width (the
CPU tests' sliding windows and ring caches); full width in bf16 is later
work (ROADMAP queue 1 item 11).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    d_ff=21504, vocab=262144,
    attn=AttnConfig(n_heads=32, n_kv_heads=16, d_head=128, qk_norm=True,
                    window=1024, pattern_local=5, pattern_period=6,
                    rope_theta=1e6),
    layout="gemma3", norm="rmsnorm", act="swiglu", subquadratic=True,
    max_position=524288, source="[hf:google/gemma-3-1b-pt]",
)
