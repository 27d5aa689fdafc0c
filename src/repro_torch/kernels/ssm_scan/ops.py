"""Public wrapper of the RWKV6 wkv kernel.

``wkv(r, k, v, w, u)`` keeps the reference's layout and semantics
(``repro.kernels.ssm_scan.ops.wkv``): the recurrence from S_0 = 0,
returning y and the final f32 state, which a decode resumes from.

  * a CPU tensor takes the plain version (``ref.wkv_ref``);
  * a CUDA tensor launches the hand-written kernel (``csrc/wkv.cu``,
    built by ``kernels._nvcc`` at first use) or raises. No CUDA input is
    ever routed to the plain version.
  * when an input requires a gradient (grad mode on), a CUDA call goes
    through ``WKV``, a ``torch.autograd.Function`` whose backward launches
    the hand-written backward kernel (``csrc/wkv_bwd.cu``: dr, dk, dv, dw
    and du in reverse time over blocks of 32 value columns, dr, dk and dw
    summed over the column groups in order by a second kernel; each
    chunk's S_{t-1} rebuilt into shared memory from states stored every
    16 steps, never by dividing by w). The final state S is treated as
    having no gradient (training leaves it unused); a nonzero one raises
    rather than being dropped. The backward takes f32 only (the reference
    trains in f32): bf16 inputs that require a gradient raise. On the CPU
    autograd differentiates the plain version.

The reference's ``chunk`` and ``interpret`` arguments do not exist here,
nor does its padding of time to a chunk multiple with w=1, k=0 no-op
steps: the kernel loops over the real T. It reads r, k, v and w through
their strides (any strides over batch, head and time), so the model's
(B, T, H, dk) projections go in as transposed views; an input whose stride
over dk is not 1 is copied to a contiguous one first.
y has r's strides when r is dense (no gaps between its elements) and
contiguous strides otherwise (``torch.empty_like``). Tensors whose rows
all start on 16 bytes (``_layout.vector_loads``) are staged with
``cp.async``; others take the same kernel with per-element loads. y is
summed in another order than the reference's (the bonus term Σᵢ rᵢuᵢkᵢ
apart, the dot product over the state in partial sums), so it agrees to
f32 rounding (for bf16 inputs, within ``bf16_error_bound``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._layout import vector_loads
from repro_torch.kernels._nvcc import Library
from repro_torch.kernels.ssm_scan.ref import wkv_ref

CSRC = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
CSRC_BWD = CSRC.with_name("wkv_bwd.cu")
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# r, k, v, w, u, y, S, B, H, T, dk, strides, vec, stream
_SIG = [_ptr] * 7 + [_i32] * 4 + [_ptr, _i32, _ptr]
LIB = Library(CSRC, {"wkv_f32": _SIG, "wkv_bf16": _SIG,
                     "wkv_launch_shape": [_i32] * 3 + [_ptr]},
              "wkv_error_string")
# r, k, v, w, u, dy, dr, dk, dv, dw, du, du_part, ckpt, part, B, H, T,
# dk, strides, stream
BWD_LIB = Library(CSRC_BWD, {"wkv_bwd_f32": [_ptr] * 14 + [_i32] * 4
                             + [_ptr, _ptr]},
                  "wkv_bwd_error_string")
# Steps between the states the backward kernel stores (its chunk; it
# rebuilds them half a chunk at a time), and the value columns of one of
# its blocks (a column group; dr, dk and dw are summed over the groups).
BWD_CHUNK = 16
BWD_COLUMNS = 32

# Largest head size the kernel takes: a value column of S is spread over
# 16 lanes of 4 rows each.
MAX_DK = 64
DTYPES = (torch.float32, torch.bfloat16)


def _check(r, k, v, w, u):
    if r.dim() != 4 or any(a.shape != r.shape for a in (k, v, w)):
        raise ValueError(f"expected r, k, v, w of one shape (B,H,T,dk); got "
                         f"{[tuple(a.shape) for a in (r, k, v, w)]}")
    if u.shape != (r.shape[1], r.shape[3]):
        raise ValueError(f"u must be (H, dk) = {(r.shape[1], r.shape[3])}, "
                         f"got {tuple(u.shape)}")
    if any(a.dtype != r.dtype for a in (k, v, w)) or r.dtype not in DTYPES:
        raise TypeError(f"r, k, v, w must share one dtype of float32 or "
                        f"bfloat16, got {[a.dtype for a in (r, k, v, w)]}")
    if any(a.device != r.device for a in (k, v, w, u)):
        raise ValueError("r, k, v, w and u must share a device")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r.device}")


def _launch(r, k, v, w, u):
    """One launch of the kernel on CUDA tensors; raises on what it does
    not take and on a refused launch."""
    B, H, T, dk = r.shape
    if dk > MAX_DK or T < 1:
        raise ValueError(f"the kernel takes dk <= {MAX_DK} and T >= 1; got "
                         f"dk={dk}, T={T}")
    # the kernel reads dk with unit stride; the few layouts without it are
    # copied here, so the card takes what the plain version takes
    r, k, v, w = (a if a.stride(3) == 1 else a.contiguous()
                  for a in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    S = torch.empty((B, H, dk, dk), dtype=torch.float32, device=r.device)
    strides = [s for a in (r, k, v, w, y) for s in a.stride()[:3]]
    lib = LIB.load()
    fn = lib.wkv_f32 if r.dtype == torch.float32 else lib.wkv_bf16
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), y.data_ptr(), S.data_ptr(), B, H, T, dk,
                 (ctypes.c_longlong * 15)(*strides),
                 int(vector_loads(r, k, v, w)), stream)
    LIB.check(err, "wkv")
    return y, S


def _launch_bwd(r, k, v, w, u, dy):
    """One launch of the backward kernel on f32 CUDA tensors. Returns
    contiguous (dr, dk, dv, dw) and du (H, dk) f32."""
    B, H, T, dk = r.shape
    r, k, v, w, dy = (a if a.stride(3) == 1 else a.contiguous()
                      for a in (r, k, v, w, dy))
    u = u.to(torch.float32).contiguous()
    grads = [torch.empty((B, H, T, dk), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    du = torch.empty((H, dk), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, dk), dtype=torch.float32, device=r.device)
    n_ch = -(-T // BWD_CHUNK)
    ckpt = torch.empty(B * H * n_ch * 64 * 64, dtype=torch.float32,
                       device=r.device)
    part = torch.empty(3 * -(-dk // BWD_COLUMNS) * B * H * T * dk,
                       dtype=torch.float32, device=r.device)
    strides = [s for a in (r, k, v, w, dy) for s in a.stride()[:3]]
    fn = BWD_LIB.load().wkv_bwd_f32
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), dy.data_ptr(),
                 *(g.data_ptr() for g in grads), du.data_ptr(),
                 du_part.data_ptr(), ckpt.data_ptr(), part.data_ptr(), B,
                 H, T, dk,
                 (ctypes.c_longlong * 15)(*strides), stream)
    BWD_LIB.check(err, "wkv backward")
    return (*grads, du)


class WKV(torch.autograd.Function):
    """The kernels as one differentiable function of (r, k, v, w, u) on
    CUDA: the forward launch and the backward launch. ``wkv`` applies it
    whenever an input requires a gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, S = _launch(r, k, v, w, u)
        wkv.launches += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        if dS is not None and bool(dS.any()):
            raise NotImplementedError(
                "wkv: the backward kernel treats the final state as having "
                "no gradient (training leaves it unused); got a nonzero one")
        r, k, v, w, u = ctx.saved_tensors
        if dy is None:
            return None, None, None, None, None
        dr, dk, dv, dw, du = _launch_bwd(r, k, v, w, u, dy)
        wkv.bwd_launches += 1
        return dr, dk, dv, dw, du.to(u.dtype)


def launch_shape(B, H, dk):
    """(blocks, threads per block) of the kernel's launch for this shape
    (builds and loads the library)."""
    grid = (ctypes.c_int * 2)()
    LIB.check(LIB.load().wkv_launch_shape(B, H, dk, grid), "wkv")
    return grid[0], grid[1]


def bf16_error_bound(y_ref):
    """Per-element bound on |kernel − plain| of y for bf16 inputs, ``y_ref``
    being the plain version's y on the same inputs. Both widen the inputs
    to f32, run the recurrence in f32 and round y to bf16 once: they differ
    by the order of y's sums (within the reference's f32 tolerance, 5e-5)
    and by one rounding each, together at most 2⁻⁷ of |y| (with 2% to
    spare). S is f32 for both dtypes and is held at the f32 tolerance."""
    return 5e-5 + 1.02 * 2.0 ** -7 * y_ref.float().abs()


def wkv(r, k, v, w, u):
    """r/k/v/w (B,H,T,dk), all four of one dtype, f32 or bf16 (the
    reference casts each input to f32 and so also takes mixed dtypes; this
    wrapper refuses them on both devices); u (H,dk). Returns (y (B,H,T,dk) in
    r's dtype, S (B,H,dk,dk) f32). On CUDA, dk ≤ ``MAX_DK``; when an input
    requires a gradient, the call is ``WKV`` (f32 only), whose backward is
    the backward kernel."""
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv_ref(r, k, v, w, u)
    return _on_card(r, k, v, w, u)


def _on_card(r, k, v, w, u):
    """The CUDA path of ``wkv``: ``WKV`` when an input requires a
    gradient, else one forward launch."""
    if torch.is_grad_enabled() and any(a.requires_grad
                                       for a in (r, k, v, w, u)):
        if r.dtype != torch.float32:
            raise TypeError(f"the wkv backward kernel takes float32; got "
                            f"{r.dtype} inputs that require a gradient")
        return WKV.apply(r, k, v, w, u)
    out = _launch(r, k, v, w, u)
    wkv.launches += 1
    return out


# Kernel launches in this process (forward, backward); ``chip_smoke.py``
# zeroes them before each path it drives and reads them after.
wkv.launches = 0
wkv.bwd_launches = 0
