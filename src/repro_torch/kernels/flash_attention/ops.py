"""Public wrapper of the flash-attention kernels: blocked online-softmax
attention with causal and sliding-window masks and GQA, forward and (for
f32 training) backward.

``flash_attention(q, k, v, causal=True, window=0)`` keeps the
reference's layout and semantics
(``repro.kernels.flash_attention.ops.flash_attention``), computed on the
tensor cores (see the kernel's header):

  * a CPU tensor takes the plain version (``ref.attention_ref``);
  * a CUDA tensor launches the hand-written kernel
    (``csrc/flash_attention.cu``, built by ``kernels._nvcc`` at first
    use) or raises. No CUDA input is ever routed to the plain version.
  * when an input requires a gradient (grad mode on), a CUDA call goes
    through ``FlashAttention``, a ``torch.autograd.Function``: its forward
    launch also writes each row's log-sum-exp, and its backward launches
    the hand-written backward kernel (``csrc/flash_attention_bwd.cu``:
    dq, dk, dv on the tensor cores in split TF32, dk and dv per tile of
    128 keys summed over the G query heads of a kv head, dq per tile of
    64 query rows, no atomics). The backward takes f32 only (the reference
    trains in f32): bf16 inputs that require a gradient raise. On the CPU
    autograd differentiates the plain version.

The reference's tiling knobs (``block_q``, ``block_kv``) and its
``interpret`` switch do not exist here, nor do its padding of dh to 128
lanes and of the sequence to block multiples, or its "non-causal needs
Skv % block_kv == 0": those are TPU tiling rules. The kernel masks ragged
Sq, Skv and dh itself and reads q, k and v through their strides (any
strides over batch, head and sequence), so the model's (B, S, H, dh)
projections go in as transposed views, without a copy; an input whose
stride over dh is not 1 is copied to a contiguous one first. The output has q's strides when q is dense (no gaps between its
elements, as in the model's transposed views) and contiguous strides
otherwise (``torch.empty_like``). Tensors whose rows all start on 16 bytes
(``_layout.vector_loads``) are tiled with ``cp.async``; others take the
same kernel with per-element loads.

The kernel's arithmetic departs from the reference's in two places, both
held by the tests: for f32 inputs each product is split TF32 (x = hi +
lo, three TF32 products, f32 accuracy); for bf16 inputs P is rounded to
bf16 before P·V (the reference keeps it in f32), within
``bf16_error_bound`` of the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._layout import vector_loads
from repro_torch.kernels._nvcc import Library
from repro_torch.kernels.flash_attention.ref import attention_ref

CSRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
CSRC_BWD = CSRC.with_name("flash_attention_bwd.cu")
_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, B, H, KV, Sq, Skv, dh, strides, causal, window, scale_log2,
# vec, lse (or None), stream
_SIG = [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32, _ptr,
        _i32, _i32, _f32, _i32, _ptr, _ptr]
LIB = Library(CSRC, {"flash_attention_f32": _SIG,
                     "flash_attention_bf16": _SIG},
              "flash_attention_error_string")
# q, k, v, o, do, lse, dq, dk, dv, delta, B, H, KV, Sq, Skv, dh, strides,
# causal, window, scale_log2, scale, stream
BWD_LIB = Library(CSRC_BWD, {"flash_attention_bwd_f32": [_ptr] * 10
                             + [_i32] * 6 + [_ptr, _i32, _i32, _f32, _f32,
                                             _ptr]},
                  "flash_attention_bwd_error_string")

# Largest head dim the kernel takes (its 128-wide instance).
MAX_DH = 128
DTYPES = (torch.float32, torch.bfloat16)
LOG2E = 1.4426950408889634


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,Sq,dh), k and v (B,KV,Skv,dh); "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, _, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"q, k and v must share one dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v must share a device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _unit_dh(*ts):
    """The kernels read dh with unit stride; the few layouts without it are
    copied, so the card takes what the plain version takes."""
    return [t if t.stride(3) == 1 else t.contiguous() for t in ts]


def _launch(q, k, v, causal, window, want_lse=False):
    """One launch of the kernel on CUDA tensors; raises on what it does
    not take and on a refused launch. Returns o, and with ``want_lse``
    also each row's log-sum-exp (B, H, Sq) f32 in the kernel's log2
    units (the backward's input)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if dh > MAX_DH or B * H >= 2 ** 31 or Sq > 64 * 65535:
        raise ValueError(f"the kernel takes dh <= {MAX_DH}, B H < 2^31 and "
                         f"Sq <= {64 * 65535}; got dh={dh}, B={B}, H={H}, "
                         f"Sq={Sq}")
    q, k, v = _unit_dh(q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = LIB.load()
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, Sq, Skv, dh, (ctypes.c_longlong * 12)(*strides),
                 int(causal), int(window), dh ** -0.5 * LOG2E,
                 int(vector_loads(q, k, v, o)),
                 None if lse is None else lse.data_ptr(), stream)
    LIB.check(err, "flash_attention")
    return (o, lse) if want_lse else o


def _launch_bwd(q, k, v, o, lse, do, causal, window):
    """One launch of the backward kernel (three CUDA kernels: delta, dk/dv,
    dq) on f32 CUDA tensors. Returns contiguous (dq, dk, dv)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    q, k, v, o, do = _unit_dh(q, k, v, o, do)
    dq = torch.empty((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, KV, Skv, dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    fn = BWD_LIB.load().flash_attention_bwd_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(), B, H, KV, Sq, Skv, dh,
                 (ctypes.c_longlong * 15)(*strides), int(causal),
                 int(window), dh ** -0.5 * LOG2E, dh ** -0.5, stream)
    BWD_LIB.check(err, "flash_attention backward")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable function of (q, k, v) on CUDA:
    the forward launch (with the row log-sum-exp) and the backward
    launch. ``flash_attention`` applies it whenever an input requires a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _launch(q, k, v, causal, window, want_lse=True)
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, o, lse, do, ctx.causal,
                                 ctx.window)
        flash_attention.bwd_launches += 1
        return dq, dk, dv, None, None


def bf16_error_bound(q, k, v, o_ref, causal=True, window=0):
    """Per-element bound on |kernel − plain| for bf16 inputs, ``o_ref``
    being the plain version's output on the same inputs.

    Both take softmax(q kᵀ) v in f32 from the same bf16 values and round o
    to bf16 once. The kernel rounds P to bf16 before P·V (at most 2⁻⁹ of
    each entry; l sums the f32 P), which moves o by at most 2⁻⁹ of
    A = softmax(q kᵀ) |v|; the two roundings of o differ by at most 2⁻⁷ of
    |o|. The bound takes A at 2⁻⁸ (room for the tensor cores' f32
    accumulation) and the rounding at 1.02 · 2⁻⁷ |o_ref|. A key dropped
    or counted twice moves o by its softmax weight times |v − o|."""
    a = attention_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                      window=window)
    return 2.0 ** -8 * a + 1.02 * 2.0 ** -7 * o_ref.float().abs()


def flash_attention(q, k, v, causal=True, window=0):
    """q (B,H,Sq,dh); k/v (B,KV,Skv,dh), all three of one dtype, f32 or
    bf16 (the reference casts each input to f32 and so also takes mixed
    dtypes; this wrapper refuses them on both devices). Returns (B,H,Sq,dh)
    in q's dtype: softmax(q kᵀ / sqrt(dh) + mask) v with head h reading kv
    head h // (H // KV), f32 accumulation. On CUDA, dh ≤ ``MAX_DH``, f32
    products in split TF32 and, for bf16 inputs, P rounded to bf16; when
    an input requires a gradient, the call is ``FlashAttention`` (f32
    only), whose backward is the backward kernel."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return _on_card(q, k, v, causal, window)


def _on_card(q, k, v, causal, window):
    """The CUDA path of ``flash_attention``: ``FlashAttention`` when an
    input requires a gradient, else one forward launch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.dtype != torch.float32:
            raise TypeError(f"the flash-attention backward kernel takes "
                            f"float32; got {q.dtype} inputs that require a "
                            "gradient")
        return FlashAttention.apply(q, k, v, causal, window)
    o = _launch(q, k, v, causal, window)
    flash_attention.launches += 1
    return o


# Kernel launches in this process (forward, backward); ``chip_smoke.py``
# zeroes them before each path it drives and reads them after.
flash_attention.launches = 0
flash_attention.bwd_launches = 0
