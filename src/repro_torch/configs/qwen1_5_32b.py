"""Qwen1.5-32B [hf:Qwen/Qwen1.5 family] — dense, MHA (kv=40), QKV bias."""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    d_ff=27392, vocab=152064,
    attn=AttnConfig(n_heads=40, n_kv_heads=40, d_head=128, qkv_bias=True,
                    rope_theta=1e6),
    norm="rmsnorm", act="swiglu", subquadratic=False,
    source="[hf:Qwen/Qwen1.5-0.5B]",
)
