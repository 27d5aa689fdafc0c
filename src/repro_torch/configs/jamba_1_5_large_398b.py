"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave, MoE 16 experts top-2 every other layer.

Layout 'jamba': repeating 8-layer superblock with attention at position 4,
Mamba elsewhere; MoE FFN on odd layers, dense FFN on even layers.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    d_ff=24576, vocab=65536,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, d_head=128),
    moe=MoEConfig(n_experts=16, top_k=2, every=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    layout="jamba", norm="rmsnorm", act="swiglu", subquadratic=True,
    max_position=262144, source="[arXiv:2403.19887]",
)
