"""Qwen2-72B [arXiv:2407.10671] — dense, GQA (8 kv heads), QKV bias."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
    d_ff=29568, vocab=152064,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, d_head=128, qkv_bias=True,
                    rope_theta=1e6),
    norm="rmsnorm", act="swiglu", subquadratic=False,
    source="[arXiv:2407.10671]",
)
