"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE 16
experts top-1, iRoPE chunked-local attention (3 local : 1 global, 8192
chunks), early fusion (text backbone here; vision tower stubbed).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    d_ff=8192, vocab=202048,
    attn=AttnConfig(n_heads=40, n_kv_heads=8, d_head=128, window=8192,
                    pattern_local=3, pattern_period=4, rope_theta=5e5),
    moe=MoEConfig(n_experts=16, top_k=1, n_shared=1),
    norm="rmsnorm", act="swiglu", subquadratic=True,
    max_position=1048576, source="[hf:meta-llama/Llama-4-Scout-17B-16E]",
)
