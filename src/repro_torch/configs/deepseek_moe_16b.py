"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE: 2 shared + 64
routed experts, top-6, expert hidden 1408; first layer dense (d_ff would be
10944 for that layer in the release; we use the routed d_expert for layer 0's
dense FFN scaled by ~8 to match released 1.4B-activated profile).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    d_ff=10944,  # the dense (first) layer's FFN width
    vocab=102400,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, d_head=128, rope_theta=1e4),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  first_dense=1),
    norm="rmsnorm", act="swiglu", subquadratic=False,
    source="[arXiv:2401.06066]",
)
