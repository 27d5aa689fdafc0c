"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM; VQ-VAE image
tokenizer is a STUB per the VLM carve-out (image tokens arrive as ids in the
shared 65536 vocab / precomputed patch embeddings via input_specs). The
backbone is a dense decoder with qk-norm (Chameleon uses qk-norm for
stability).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    d_ff=22016, vocab=65536,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, d_head=128, qk_norm=True),
    frontend="vision_stub",
    norm="rmsnorm", act="swiglu", subquadratic=False,
    source="[arXiv:2405.09818]",
)
