"""RWKV6 'Finch' 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay linear recurrence. d_model=2048, 24 layers, head_size 64 => 32 heads.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    d_ff=7168, vocab=65536,
    ssm=SSMConfig(kind="rwkv6", n_heads=32),
    norm="layernorm", act="gelu",  # rwkv channel-mix uses squared relu; gelu stands in cheaply
    subquadratic=True, max_position=1048576, source="[arXiv:2404.05892]",
)
