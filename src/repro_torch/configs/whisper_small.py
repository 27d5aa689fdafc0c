"""Whisper-small [arXiv:2212.04356]: encoder-decoder; the conv/mel frontend
is a stub (``models.frontend``: (B, 1500, d) frame embeddings stand in for
its output). 12 encoder + 12 decoder layers, d_model=768, MHA, sinusoidal
positions (learned ones in the real model).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    d_ff=3072, vocab=51865,
    attn=AttnConfig(n_heads=12, n_kv_heads=12, d_head=64, qkv_bias=True),
    layout="encdec", n_encoder_layers=12, frontend="audio_stub",
    norm="layernorm", act="gelu", subquadratic=False, max_position=32768,
    source="[arXiv:2212.04356]",
)

AUDIO_FRAMES = 1500  # 30 s of audio after the conv frontend (stubbed)
