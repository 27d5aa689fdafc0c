"""Blocked online-softmax attention: the hand-written CUDA kernels
(``csrc/flash_attention.cu``, forward; ``csrc/flash_attention_bwd.cu``,
backward), their wrapper and autograd function (``ops``) and the plain
version (``ref``)."""
from repro_torch.kernels.flash_attention.ops import MAX_DH, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["MAX_DH", "attention_ref", "flash_attention"]
