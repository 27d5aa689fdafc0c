"""Public wrapper of the fused K-hop graph filter Y = Σ_k h_k S^k W.

``graph_filter(S, W, h)`` keeps the reference's argument order
(``repro.kernels.graph_filter.ops.graph_filter``):

  * a CPU tensor takes the plain version (``ref.graph_filter_ref``);
  * a CUDA tensor launches the hand-written kernel
    (``csrc/graph_filter.cu``) or raises. No CUDA input is ever routed
    to the plain version.

The reference's (8, 128) padding, ``pick_block_d`` and
``pallas_profitable`` are TPU tiling rules and have no counterpart: the
kernel masks ragged n and d itself. The backward (dW is the same kernel
on Sᵀ) lands with the training slice; until then a CUDA call that would
record a gradient raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.graph_filter import loader
from repro_torch.kernels.graph_filter.ref import graph_filter_ref

# Largest agent count the kernel takes (MAX_N in csrc/graph_filter.cu):
# S (n x n f32) stays resident in shared memory.
MAX_N = 128
W_DTYPES = (torch.float32, torch.bfloat16)


def _check(S, W, h):
    if W.dim() not in (2, 3) or S.dim() != W.dim():
        raise ValueError(f"expected S (n,n), W (n,d) or S (B,n,n), "
                         f"W (B,n,d); got S {tuple(S.shape)}, "
                         f"W {tuple(W.shape)}")
    n = W.shape[-2]
    if S.shape[-2:] != (n, n) or S.shape[:-2] != W.shape[:-2]:
        raise ValueError(f"S {tuple(S.shape)} does not match "
                         f"W {tuple(W.shape)}")
    if h.dim() != 1 or h.shape[0] < 1:
        raise ValueError(f"h must be (K+1,), got {tuple(h.shape)}")
    if not (S.device == W.device == h.device):
        raise ValueError(f"S, W and h must share a device, got {S.device}, "
                         f"{W.device}, {h.device}")
    if W.dtype not in W_DTYPES:
        raise TypeError(f"W must be float32 or bfloat16, got {W.dtype}")


def graph_filter(S, W, h):
    """Σ_k h_k S^k W. S (B,n,n) or (n,n), W (B,n,d) or (n,d) f32 or bf16,
    h (K+1,); the result is in W's dtype with f32 accumulation. On CUDA,
    S and h must be f32, S and W contiguous, n ≤ ``MAX_N``."""
    _check(S, W, h)
    if W.device.type == "cpu":
        return graph_filter_ref(S, W, h)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (S, W, h)):
        raise NotImplementedError(
            "the graph-filter kernel has no backward yet: it lands with "
            "the training slice; call under torch.no_grad()")
    if S.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"the kernel takes f32 S and h, got {S.dtype}, "
                        f"{h.dtype}")
    if not (S.is_contiguous() and W.is_contiguous()):
        raise ValueError("the kernel takes contiguous S and W")
    n, d = W.shape[-2], W.shape[-1]
    B = W.shape[0] if W.dim() == 3 else 1
    if not (1 <= n <= MAX_N and d >= 1 and 1 <= B <= 65535):
        raise ValueError(f"the kernel takes 1 <= n <= {MAX_N}, d >= 1 and "
                         f"1 <= B <= 65535; got n={n}, d={d}, B={B}")
    h = h.contiguous()
    Y = torch.empty_like(W)
    lib = loader.load()
    fn = (lib.graph_filter_f32 if W.dtype == torch.float32
          else lib.graph_filter_bf16)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(S.data_ptr(), W.data_ptr(), h.data_ptr(), Y.data_ptr(),
                 B, n, d, h.shape[0] - 1, stream)
    if err:
        raise RuntimeError("graph_filter kernel launch failed: "
                           + lib.graph_filter_error_string(err).decode())
    graph_filter.launches += 1
    return Y


# Kernel launches in this process; ``chip_smoke.py`` zeroes it before the
# serve run and reads it after.
graph_filter.launches = 0


def make_cuda_mix(*, tag=None):
    """The S-as-argument mixer of every unrolled layer through the
    kernel: ``mix_fn(S, W, h)`` with ``takes_S = True``, the protocol
    that tells ``core.unroll._mix`` to pass the current (per-request)
    mixing matrix. The port of ``make_pallas_mix``."""
    def mix_fn(S, W, h):
        return graph_filter(S, W, h)

    mix_fn.takes_S = True
    mix_fn.tag = ("cuda",) if tag is None else tag
    return mix_fn
