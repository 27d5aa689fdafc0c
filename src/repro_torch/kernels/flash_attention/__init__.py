"""Blocked online-softmax attention (forward): the hand-written CUDA
kernel (``csrc/flash_attention.cu``), its wrapper (``ops``) and its plain
version (``ref``)."""
from repro_torch.kernels.flash_attention.ops import MAX_DH, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["MAX_DH", "attention_ref", "flash_attention"]
