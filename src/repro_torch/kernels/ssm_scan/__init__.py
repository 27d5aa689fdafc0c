"""RWKV6 wkv recurrence: the hand-written CUDA kernels (``csrc/wkv.cu``,
forward; ``csrc/wkv_bwd.cu``, backward), their wrapper and autograd
function (``ops``) and the plain version (``ref``)."""
from repro_torch.kernels.ssm_scan.ops import MAX_DK, wkv
from repro_torch.kernels.ssm_scan.ref import wkv_ref

__all__ = ["MAX_DK", "wkv", "wkv_ref"]
