"""Public wrapper of the RWKV6 wkv kernel.

``wkv(r, k, v, w, u)`` keeps the reference's layout and semantics
(``repro.kernels.ssm_scan.ops.wkv``): the recurrence from S_0 = 0,
returning y and the final f32 state, which a decode resumes from.

  * a CPU tensor takes the plain version (``ref.wkv_ref``);
  * a CUDA tensor launches the hand-written kernels (``csrc/wkv.cu``,
    built by ``kernels._nvcc`` at first use) or raises. No CUDA input is
    ever routed to the plain version. The forward is two launches: the
    state at every chunk boundary (chunks of ``CHUNK`` = 64 steps, one
    split-TF32 ``wgmma`` product per chunk, ``csrc/wkv_chunk.cuh``), then
    y with the chunks in parallel, each from its chunk-start state.
  * when an input requires a gradient (grad mode on), a CUDA call goes
    through ``WKV``, a ``torch.autograd.Function`` whose backward launches
    the hand-written backward (``csrc/wkv_bwd.cu``) with the chunk-start
    states S its forward launch wrote (``WKV`` keeps them: 67 MB at the
    rwkv6-1.6b shape, until the backward): the same chunk-state pass,
    last chunk first from the final state's gradient dS (as the reference
    differentiates its scan through S), for G = dL/dS; then the chunks in
    parallel, one block per (batch item, head, chunk)
    holding all 64 value columns, so dr, dk, dw and dv are complete in the
    block (no partial sums in device memory); each chunk's S_{t-1} rebuilt
    from checkpoints every 16 steps, 8 states at a time in registers,
    never by dividing by w; du summed from per-chunk partials
    in a fixed order. f32 and bf16 inputs (bf16
    widened to f32 as they are loaded, the gradients rounded to bf16 once,
    within ``bf16_grad_error_bound`` of the plain version). On the CPU
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
``cp.async``; others take the same kernel with per-element loads. The
chunk-boundary states come from split-TF32 products and y is summed in
another order than the reference's (the bonus term Σᵢ rᵢuᵢkᵢ apart, the
dot product over the state in partial sums), so it agrees to f32 rounding
(for bf16 inputs, within ``bf16_error_bound``).
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
# r, k, v, w, u, y, S, states, B, H, T, dk, strides, vec, stream
_SIG = [_ptr] * 8 + [_i32] * 4 + [_ptr, _i32, _ptr]
LIB = Library(CSRC, {"wkv_f32": _SIG, "wkv_bf16": _SIG,
                     "wkv_launch_shape": [_i32] * 4 + [_ptr]},
              "wkv_error_string")
# r, k, v, w, u, dy, dS (or None), dr, dk, dv, dw, du, the forward's
# states, g_states, du_part, B, H, T, dk, strides, stream
_BWD_SIG = [_ptr] * 15 + [_i32] * 4 + [_ptr, _ptr]
BWD_LIB = Library(CSRC_BWD, {"wkv_bwd_f32": _BWD_SIG,
                             "wkv_bwd_bf16": _BWD_SIG},
                  "wkv_bwd_error_string")
# Steps per chunk: the states (and, in the backward, the gradients) at the
# chunk boundaries are the only ones the kernels keep in device memory
# (B H ceil(T / CHUNK) x 64 x 64 f32 each, 67 MB at the rwkv6-1.6b shape).
CHUNK = 64

# Largest head size the kernels take: the state is padded to 64 x 64 (the
# chunk products' width; a value column of S spread over 16 lanes of 4 rows
# in the forward, a key row over 8 lanes in the backward).
MAX_DK = 64
DTYPES = (torch.float32, torch.bfloat16)
# The f32 backward kernel's distance from autograd through the plain
# version, of each gradient's largest entry (chip_smoke.py 6b's gate: f32
# sums over up to 2048 steps in another order).
F32_GRAD_REL = 1e-4


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
    """One call of the forward kernels on CUDA tensors; raises on what they
    do not take and on a refused launch. Returns (y, S, states): ``states``
    the state at every chunk start (f32 scratch), which the backward of the
    same inputs can take instead of computing it again."""
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
    states = torch.empty(_state_floats(B, H, T), dtype=torch.float32,
                         device=r.device)
    strides = [s for a in (r, k, v, w, y) for s in a.stride()[:3]]
    lib = LIB.load()
    fn = lib.wkv_f32 if r.dtype == torch.float32 else lib.wkv_bf16
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), y.data_ptr(), S.data_ptr(),
                 states.data_ptr(), B, H, T, dk,
                 (ctypes.c_longlong * 15)(*strides),
                 int(vector_loads(r, k, v, w)), stream)
    LIB.check(err, "wkv")
    return y, S, states


def _launch_bwd(r, k, v, w, u, dy, dS, states):
    """One call of the backward kernels on CUDA tensors (r, k, v, w and
    dy of one dtype, f32 or bf16; ``dS`` the final state's gradient, or
    None for none; ``states`` the chunk-start states ``_launch`` returned
    for the same r, k, v, w). Returns contiguous (dr, dk, dv, dw) in the
    inputs' dtype and du (H, dk) f32."""
    B, H, T, dk = r.shape
    r, k, v, w, dy = (a if a.stride(3) == 1 else a.contiguous()
                      for a in (r, k, v, w, dy.to(r.dtype)))
    u = u.to(torch.float32).contiguous()
    if dS is not None:
        dS = dS.to(torch.float32).contiguous()
    grads = [torch.empty((B, H, T, dk), dtype=r.dtype, device=r.device)
             for _ in range(4)]
    du = torch.empty((H, dk), dtype=torch.float32, device=r.device)
    g_states = torch.empty(_state_floats(B, H, T), dtype=torch.float32,
                           device=r.device)
    du_part = torch.empty(B * H * -(-T // CHUNK) * MAX_DK,
                          dtype=torch.float32, device=r.device)
    strides = [s for a in (r, k, v, w, dy) for s in a.stride()[:3]]
    lib = BWD_LIB.load()
    fn = lib.wkv_bwd_f32 if r.dtype == torch.float32 else lib.wkv_bwd_bf16
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), dy.data_ptr(),
                 None if dS is None else dS.data_ptr(),
                 *(g.data_ptr() for g in grads), du.data_ptr(),
                 states.data_ptr(), g_states.data_ptr(),
                 du_part.data_ptr(), B, H, T, dk,
                 (ctypes.c_longlong * 15)(*strides), stream)
    BWD_LIB.check(err, "wkv backward")
    return (*grads, du)


class WKV(torch.autograd.Function):
    """The kernels as one differentiable function of (r, k, v, w, u) on
    CUDA: the forward launch and the backward launch. ``wkv`` applies it
    whenever an input requires a gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, S, states = _launch(r, k, v, w, u)
        wkv.launches += 1
        ctx.set_materialize_grads(False)
        # the chunk-start states are kept for the backward (one 64 x 64 f32
        # state per 64 steps: 67 MB at the rwkv6-1.6b shape) instead of
        # being computed there again
        ctx.save_for_backward(r, k, v, w, u, states)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        r, k, v, w, u, states = ctx.saved_tensors
        if dy is None and dS is None:
            return None, None, None, None, None
        if dy is None:
            dy = torch.zeros_like(r)
        dr, dk, dv, dw, du = _launch_bwd(r, k, v, w, u, dy, dS, states)
        wkv.bwd_launches += 1
        return dr, dk, dv, dw, du.to(u.dtype)


def _state_floats(B, H, T):
    """Floats of one set of chunk-boundary states: a 64 x 64 f32 state per
    (batch item, head, chunk of ``CHUNK`` steps)."""
    return B * H * -(-T // CHUNK) * MAX_DK * MAX_DK


def launch_shape(B, H, T, dk):
    """(blocks, threads per block) of the forward's y launch for this shape
    (builds and loads the library): a block per (batch item, head, chunk);
    the state pass before it runs B·H blocks of 128 threads."""
    grid = (ctypes.c_int * 2)()
    LIB.check(LIB.load().wkv_launch_shape(B, H, T, dk, grid), "wkv")
    return grid[0], grid[1]


def bf16_error_bound(y_ref):
    """Per-element bound on |kernel − plain| of y for bf16 inputs, ``y_ref``
    being the plain version's y on the same inputs. Both widen the inputs
    to f32, run the recurrence in f32 and round y to bf16 once: they differ
    by the order of y's sums (within the reference's f32 tolerance, 5e-5)
    and by one rounding each, together at most 2⁻⁷ of |y| (with 2% to
    spare). S is f32 for both dtypes and is held at the f32 tolerance."""
    return 5e-5 + 1.02 * 2.0 ** -7 * y_ref.float().abs()


def bf16_grad_error_bound(grads_ref):
    """Per-element bounds on |kernel − plain| of (dr, dk, dv, dw) for bf16
    inputs, ``grads_ref`` being the plain version's gradients (autograd
    through ``wkv_ref``) on the same inputs and cotangents. Both widen the
    inputs to f32 and run the same f32 recurrence, then round each
    gradient to bf16 once: they differ by the f32 sums' order, at most
    ``F32_GRAD_REL`` of the gradient's largest entry (the f32 kernel's
    gate, chip_smoke.py 6b), and by the two roundings, together at most
    2⁻⁷ of |g| (with 2% to spare). du is f32 for both dtypes and is held
    at the f32 gate."""
    return [F32_GRAD_REL * g.float().abs().max() + 1.02 * 2.0 ** -7
            * g.float().abs() for g in grads_ref]


def wkv(r, k, v, w, u):
    """r/k/v/w (B,H,T,dk), all four of one dtype, f32 or bf16 (the
    reference casts each input to f32 and so also takes mixed dtypes; this
    wrapper refuses them on both devices); u (H,dk). Returns (y (B,H,T,dk) in
    r's dtype, S (B,H,dk,dk) f32). On CUDA, dk ≤ ``MAX_DK``; when an input
    requires a gradient, the call is ``WKV``, whose backward is the
    backward kernel."""
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        return wkv_ref(r, k, v, w, u)
    return _on_card(r, k, v, w, u)


def _on_card(r, k, v, w, u):
    """The CUDA path of ``wkv``: ``WKV`` when an input requires a
    gradient, else one forward launch."""
    if torch.is_grad_enabled() and any(a.requires_grad
                                       for a in (r, k, v, w, u)):
        return WKV.apply(r, k, v, w, u)
    y, S, _ = _launch(r, k, v, w, u)
    wkv.launches += 1
    return y, S


# Kernel launches in this process (forward, backward); ``chip_smoke.py``
# zeroes them before each path it drives and reads them after.
wkv.launches = 0
wkv.bwd_launches = 0
