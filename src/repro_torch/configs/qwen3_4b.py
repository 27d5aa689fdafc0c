"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — dense, GQA (8 kv), qk-norm, no QKV bias."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    d_ff=9728, vocab=151936,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, d_head=128, qkv_bias=False,
                    qk_norm=True, rope_theta=1e6),
    norm="rmsnorm", act="swiglu", subquadratic=False,
    source="[hf:Qwen/Qwen3-8B]",
)
