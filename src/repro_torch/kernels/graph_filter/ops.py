"""Public wrapper of the fused K-hop graph filter Y = Σ_k h_k S^k W, with
its gradient.

``graph_filter(S, W, h)`` keeps the reference's argument order
(``repro.kernels.graph_filter.ops.graph_filter``):

  * a CPU tensor takes the plain version (``ref.graph_filter_ref``), and so
    does a ``meta`` one (shapes only: the dry run's description of a
    step);
  * a CUDA tensor launches the hand-written kernel
    (``csrc/graph_filter.cu``, built by ``kernels._nvcc`` at first use)
    or raises. No CUDA input is ever routed to the plain version. Any
    agent count n: up to ``RESIDENT_N`` S stays on chip (in registers, as
    the tensor cores' A operand) for every hop; beyond it the kernel
    streams S through shared memory and keeps the iterate between hops in
    an f32 scratch that this wrapper allocates.

The gradient is a ``torch.autograd.Function`` that serves both devices,
so the CPU tests run the same backward formulas as the card (the
reference's custom VJP, ``ops.py::_bwd``):

  * dW = Σ_k h_k (Sᵀ)^k Ḡ, the filter on Sᵀ applied to the cotangent: on
    CUDA the kernel's transposed-S entry (``graph_filter_t_f32``, which
    reads S in transposed order: for n ≤ ``RESIDENT_N`` it loads Sᵀ's
    split-TF32 fragments into registers, beyond it it streams Sᵀ's
    panels through shared memory, so no transposed copy of S is made);
  * dh_k = ⟨Ḡ, S^k W⟩, summed over the batch axis (h is shared);
  * dS = Σ_k h_k Σ_{a+b=k−1} (Sᵀ)^a Ḡ (S^b W)ᵀ, only when S needs a
    gradient (topology-learning callers; SURF's graphs are fixed).

Each is computed only when ``ctx.needs_input_grad`` asks for it. dh and
dS are plain torch products and reductions, as in the reference (jnp
outside Pallas). The backward is first-order only: SURF's grad-of-grad
goes through the task's loss, never twice through the filter.

The reference's (8, 128) padding, ``pick_block_d`` and
``pallas_profitable`` are TPU tiling rules and have no counterpart: the
kernel masks ragged n and d itself.

JAX-only: ``IMPLS`` and ``resolve_interpret`` (the reference's choice
between its Pallas kernel, interpret mode and plain jnp: here the device
chooses, CUDA tensors the kernel and CPU tensors the plain version),
``graph_filter_hsw`` (the deprecated (h, S, W) argument order:
``graph_filter(S, W, h)``) and ``make_pallas_mix`` (the S-as-argument
mixer through the Pallas kernel: the engines' default mixer, ``mix=None``,
launches this kernel on CUDA tensors; ``ref.make_plain_mix`` is the
plain one).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._nvcc import Library
from repro_torch.kernels.graph_filter.ref import graph_filter_ref

CSRC = Path(__file__).resolve().parent / "csrc" / "graph_filter.cu"
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# S, W, h, Y, work, B, n, d, K, stream
_SIG = [_ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr]
_ENTRIES = {(torch.float32, False): "graph_filter_f32",
            (torch.bfloat16, False): "graph_filter_bf16",
            (torch.float32, True): "graph_filter_t_f32"}
LIB = Library(CSRC, {**{name: _SIG for name in _ENTRIES.values()},
                     "graph_filter_resident_n": []},
              "graph_filter_error_string")
_FNS = {}          # (W dtype, transpose_s) -> bound entry, after LIB.load()

# The largest n whose S stays on chip for all hops (RESIDENT_N in
# csrc/graph_filter.cu, which ``graph_filter_resident_n`` returns). Larger
# n launch the streamed path, which for K >= 2 needs the f32 scratch
# ``_launch`` allocates. No n is refused.
RESIDENT_N = 128
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
    if W.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {W.device}")


def _entry(dtype, transpose_s):
    """The bound C entry for W's dtype; the library is loaded once."""
    fn = _FNS.get((dtype, transpose_s))
    if fn is None:
        lib = LIB.load()
        if lib.graph_filter_resident_n() != RESIDENT_N:
            raise RuntimeError("ops.RESIDENT_N does not match "
                               "csrc/graph_filter.cu")
        _FNS.update({k: getattr(lib, v) for k, v in _ENTRIES.items()})
        fn = _FNS[(dtype, transpose_s)]
    return fn


def _launch(S, W, h, transpose_s=False):
    """One launch of the kernel on CUDA tensors: Σ_k h_k S^k W, or
    Σ_k h_k (Sᵀ)^k W with ``transpose_s`` (f32 W only). S and h are cast
    to f32 and S and W made contiguous first, as the reference casts and
    pads them into fresh arrays, so the card takes what the plain version
    takes. Raises on what the kernel does not take and on a refused
    launch."""
    if transpose_s and W.dtype != torch.float32:
        raise TypeError(f"the transposed-S entry takes f32 W, got {W.dtype}")
    S = S.to(torch.float32).contiguous()
    W = W.contiguous()
    n, d = W.shape[-2], W.shape[-1]
    B = W.shape[0] if W.dim() == 3 else 1
    if not (n >= 1 and d >= 1 and 1 <= B <= 65535):
        raise ValueError(f"the kernel takes n >= 1, d >= 1 and "
                         f"1 <= B <= 65535; got n={n}, d={d}, B={B}")
    K = h.shape[0] - 1
    h = h.to(torch.float32).contiguous()
    Y = torch.empty_like(W)
    work = None
    if n > RESIDENT_N and K >= 2:
        work = torch.empty((min(K - 1, 2), B, n, d), dtype=torch.float32,
                           device=W.device)
    fn = _entry(W.dtype, transpose_s)
    args = (S.data_ptr(), W.data_ptr(), h.data_ptr(), Y.data_ptr(),
            None if work is None else work.data_ptr(), B, n, d, K)
    if W.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(W.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    LIB.check(err, "graph_filter")
    return Y


def bf16_error_bound(y_ref):
    """Per-element bound on |kernel − plain| for bf16 W, ``y_ref`` being
    the plain version's bf16 result on the same inputs.

    Both widen W to f32, run Horner's rule in f32 and round Y to bf16
    once. Their f32 results y_k and y_p differ by the order of the sums
    and the kernel's split-TF32 products: |y_k − y_p| ≤ δ, within the
    reference's f32 tolerance, δ ≤ 5e-5 at these inputs' scale. Rounding
    to nearest bf16 (8 significant bits) moves each by at most half an
    ulp, 2⁻⁸ of its magnitude, so |r(y_k) − r(y_p)| ≤ δ + 2⁻⁸(|y_k| +
    |y_p|) ≤ δ + 2⁻⁷(1 + 2⁻⁸)|y_ref| + 2⁻⁸δ: one bf16 ulp of y_ref plus an
    f32-sized term, 5e-5 + 1.02·2⁻⁷|y_ref| with room to spare. A kernel
    that drops a k-tile of 8 agents moves y by about 0.03 at PAPER
    width, far outside it, though inside the reference's 5e-2."""
    return 5e-5 + 1.02 * 2.0 ** -7 * y_ref.float().abs()


def _filter(S, W, h):
    """The forward on either device."""
    if W.device.type in ("cpu", "meta"):
        return graph_filter_ref(S, W, h)
    Y = _launch(S, W, h)
    graph_filter.launches += 1
    return Y


def graph_filter_bwd(S, G, h):
    """The backward's dW = Σ_k h_k (Sᵀ)^k G for f32 G, with S given
    untransposed: the plain filter on Sᵀ for CPU tensors, one launch of
    the kernel's transposed-S entry for CUDA tensors (counted in
    ``graph_filter.bwd_launches``)."""
    if G.device.type in ("cpu", "meta"):
        return graph_filter_ref(S.mT, G, h)
    dW = _launch(S, G, h, transpose_s=True)
    graph_filter.bwd_launches += 1
    return dW


def _powers(S, W, K):
    """[W, S W, ..., S^K W] in f32."""
    P = [W]
    for _ in range(K):
        P.append(S @ P[-1])
    return P


def _grad_h(P, G):
    """dh_k = ⟨G, S^k W⟩ over every axis, the batch axis included."""
    return torch.stack([(G * p).sum() for p in P])


def _grad_S(S, G, h, P):
    """dS = Σ_k h_k Σ_{a+b=k−1} (Sᵀ)^a G (S^b W)ᵀ, per batch item."""
    K = h.shape[0] - 1
    GT = _powers(S.mT, G, K - 1)          # (Sᵀ)^a G, a < K
    dS = torch.zeros_like(S)
    for k in range(1, K + 1):
        for a in range(k):
            dS = dS + h[k] * (GT[a] @ P[k - 1 - a].mT)
    return dS


class _GraphFilter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S, W, h):
        ctx.save_for_backward(S, W, h)
        return _filter(S, W, h)

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        S, W, h = ctx.saved_tensors
        need_S, need_W, need_h = ctx.needs_input_grad
        G = G.to(torch.float32).contiguous()
        hf, Sf = h.to(torch.float32), S.to(torch.float32)
        dS = dW = dh = None
        if need_W:
            dW = graph_filter_bwd(S, G, hf).to(W.dtype)
        if need_S or need_h:
            P = _powers(Sf, W.to(torch.float32), h.shape[0] - 1)
            if need_h:
                dh = _grad_h(P, G).to(h.dtype)
            if need_S:
                dS = _grad_S(Sf, G, hf, P).to(S.dtype)
        return dS, dW, dh


def graph_filter(S, W, h):
    """Σ_k h_k S^k W. S (B,n,n) or (n,n), W (B,n,d) or (n,d) f32 or bf16,
    h (K+1,) of any float dtype; the result is in W's dtype with f32
    accumulation. S and h are read as f32, and on CUDA S and W are made
    contiguous before the one launch; any n ≥ 1.
    Differentiable in S, W and h (first order)."""
    _check(S, W, h)
    return _GraphFilter.apply(S, W, h)


# Kernel launches in this process: ``launches`` counts the forward, and
# ``bwd_launches`` the backward's dW launches (the transposed-S entry).
# ``chip_smoke.py`` zeroes both before each path it drives and reads them
# after.
graph_filter.launches = 0
graph_filter.bwd_launches = 0
