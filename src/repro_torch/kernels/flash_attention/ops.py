"""Public wrapper of the flash-attention kernels: blocked online-softmax
attention with causal and sliding-window masks and GQA, forward and
backward.

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
    dq, dk, dv in warpgroup products on the tensor cores, on tiles that
    TMA brings, dk and dv per tile of keys summed over the G query heads
    of a kv head, dq per tile of query rows, dk's mean over the keys taken
    out, no atomics; f32 in split TF32 with every product on keys centred
    on their mean, bf16 in bf16 products with P and dS rounded to bf16 as
    operands and dq's product on the centred keys, within
    ``bf16_grad_error_bound`` of the plain version). Its operands go
    through ``tma_operands`` (dh padded to whole 16-byte rows, rows TMA
    cannot read copied). On the CPU autograd differentiates the plain
    version.

The reference's tiling knobs (``block_q``, ``block_kv``) and its
``interpret`` switch do not exist here, nor do its padding of dh to 128
lanes and of the sequence to block multiples, or its "non-causal needs
Skv % block_kv == 0": those are TPU tiling rules. The kernel masks ragged
Sq, Skv and dh itself and reads q, k and v through their strides (any
strides over batch, head and sequence), so the model's (B, S, H, dh)
projections go in as transposed views, without a copy; an input whose
stride over dh is not 1 is copied to a contiguous one first. The output has q's strides when q is dense (no gaps between its
elements, as in the model's transposed views) and contiguous strides
otherwise (``torch.empty_like``). Both entries are ``wgmma`` kernels on
tiles that TMA brings: bf16 reads q, k and v by TMA, f32 reads q by TMA
and k and v through their strides in a split pass that writes them,
split, into scratch the wrapper allocates per call
(``fwd_scratch_floats``: 134 MB at the qwen3-4b prefill shape). So
``tma_inputs`` pads dh to whole 16-byte rows (a multiple of 8 bf16 or 4
f32 columns) and copies a tensor whose rows TMA cannot read
(``_layout.tma_rows``); the model's views need neither.

The kernel's arithmetic departs from the reference's in two places, both
held by the tests: for f32 inputs each product is split TF32 (x = hi +
lo, both rounded to TF32, three TF32 products, f32 accuracy); for bf16
inputs P is rounded to bf16 before P·V (the reference keeps it in f32),
within ``bf16_error_bound`` of the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels._layout import tma_rows
from repro_torch.kernels._nvcc import Library
from repro_torch.kernels.flash_attention.ref import attention_ref

CSRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
CSRC_BWD = CSRC.with_name("flash_attention_bwd.cu")
_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, B, H, KV, Sq, Skv, dh, strides, causal, window, scale_log2,
# scratch (f32; None for bf16), lse (or None), stream
_SIG = [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32, _ptr,
        _i32, _i32, _f32, _ptr, _ptr, _ptr]
LIB = Library(CSRC, {"flash_attention_f32": _SIG,
                     "flash_attention_bf16": _SIG},
              "flash_attention_error_string")
# q, k, v, o, do, lse, dq, dk, dv, scratch, B, H, KV, Sq, Skv, dh, strides,
# causal, window, scale_log2, scale, stream
_BWD_SIG = [_ptr] * 10 + [_i32] * 6 + [_ptr, _i32, _i32, _f32, _f32, _ptr]
BWD_LIB = Library(CSRC_BWD, {"flash_attention_bwd_f32": _BWD_SIG,
                             "flash_attention_bwd_bf16": _BWD_SIG},
                  "flash_attention_bwd_error_string")

# Largest head dim the kernel takes (its 128-wide instance).
MAX_DH = 128
DTYPES = (torch.float32, torch.bfloat16)
LOG2E = 1.4426950408889634
# The f32 backward kernel's distance from autograd through the plain
# version, of each gradient's largest entry (chip_smoke.py 5b's gate: f32
# sums over up to 2048 keys in another order).
F32_GRAD_REL = 1e-4


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


def fwd_scratch_floats(B, KV, Skv, dh):
    """f32 floats of the f32 forward's scratch: k split into hi and lo
    ((B, KV, Skv, dh) each) and v transposed, split ((B, KV, dh, Skv
    rounded up to a multiple of 8) each), which the kernel's split pass
    writes and its TMA tiles read."""
    return 2 * B * KV * dh * (Skv + -(-Skv // 8) * 8)


def _launch(q, k, v, causal, window, want_lse=False):
    """One launch of the kernel on CUDA tensors; raises on what it does
    not take and on a refused launch. The operands go through
    ``tma_inputs`` first (the kernel sees the padded dh, the scale stays
    that of the true dh, and o is sliced back); f32 launches also get
    their split pass's scratch (``fwd_scratch_floats``). Returns o, and
    with ``want_lse`` also each row's log-sum-exp (B, H, Sq) f32 in the
    kernel's log2 units (the backward's input)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if dh > MAX_DH or B * H >= 2 ** 31 or Sq > 64 * 65535:
        raise ValueError(f"the kernel takes dh <= {MAX_DH}, B H < 2^31 and "
                         f"Sq <= {64 * 65535}; got dh={dh}, B={B}, H={H}, "
                         f"Sq={Sq}")
    q, k, v = _unit_dh(q, k, v)
    f32 = q.dtype == torch.float32
    (q, k, v), dhp = tma_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    scratch = (torch.empty(fwd_scratch_floats(B, KV, Skv, dhp),
                           dtype=torch.float32, device=q.device)
               if f32 else None)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = LIB.load()
    fn = lib.flash_attention_f32 if f32 else lib.flash_attention_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, Sq, Skv, dhp, (ctypes.c_longlong * 12)(*strides),
                 int(causal), int(window), dh ** -0.5 * LOG2E,
                 None if scratch is None else scratch.data_ptr(),
                 None if lse is None else lse.data_ptr(), stream)
    LIB.check(err, "flash_attention")
    if dhp != dh:
        o = o[..., :dh].contiguous()
    return (o, lse) if want_lse else o


def _tma_legal(t):
    """``t`` if TMA can read its rows (``_layout.tma_rows``), else a
    contiguous copy."""
    return (t if tma_rows(t)
            else t.clone(memory_format=torch.contiguous_format))


def _pad_dh(ts):
    """The tensors with dh padded with zeros to whole 16-byte rows (a
    multiple of 8 bf16 or 4 f32 columns; new and contiguous; as they are
    when dh is one already), and that dh."""
    dh = ts[0].shape[-1]
    per = 16 // ts[0].element_size()
    dhp = -(-dh // per) * per
    if dhp != dh:
        ts = [F.pad(t, (0, dhp - dh)) for t in ts]
    return list(ts), dhp


def tma_inputs(q, k, v):
    """The forward's operands made legal for the kernel's TMA loads: dh
    padded with zeros to whole 16-byte rows (a multiple of 8 bf16 or 4 f32
    columns), then each of q, k and v whose rows TMA cannot read copied to
    a contiguous tensor (the f32 kernel reads q by TMA and k and v by
    plain loads, into its split copies). Zero columns change no score and
    no output column the caller keeps; the kernel's scale stays that of
    the true dh. Returns [q, k, v] and the padded dh."""
    ts, dhp = _pad_dh((q, k, v))
    return [_tma_legal(t) for t in ts], dhp


def tma_operands(q, k, v, o, do):
    """The backward's operands made legal for the kernel's TMA loads: dh
    padded with zeros to whole 16-byte rows (a multiple of 8 bf16 or 4 f32
    columns; all five tensors, new and contiguous), then each of q, k, v
    and do whose rows TMA cannot read (``_layout.tma_rows``) copied to a
    contiguous tensor; o is read by plain loads and kept (the f32 entry
    also reads k and v by plain loads, into its split copies). Zero columns
    change no score, and their gradient columns are sliced off. Returns
    (q, k, v, o, do) and the padded dh."""
    (q, k, v, o, do), dhp = _pad_dh((q, k, v, o, do))
    q, k, v, do = (_tma_legal(t) for t in (q, k, v, do))
    return (q, k, v, o, do), dhp


def _launch_bwd(q, k, v, o, lse, do, causal, window):
    """One launch of the backward kernel (nine CUDA kernels: the key means
    in two passes, the centred keys, delta beside the lse (f32: shifted to
    the centred keys) per query tile, dk/dv, dq, then dk's mean over the
    keys taken out in three) on CUDA tensors, q, k, v, o and do of one
    dtype (f32 or bf16), lse f32. The operands go through
    ``tma_operands`` first. Returns contiguous (dq, dk, dv) in that
    dtype."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    q, k, v, o, do = _unit_dh(q, k, v, o, do.to(q.dtype))
    (q, k, v, o, do), dhp = tma_operands(q, k, v, o, do)
    dq = torch.empty((B, H, Sq, dhp), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KV, Skv, dhp), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    n = B * KV * Skv * dhp
    # the centred keys (f32: and the values, each as hi and lo, 4 n floats;
    # bf16: n / 2, then dk's f32 sums), lse and delta per query tile of 64
    # rows, the key means and their partial sums over chunks of 64 keys
    keys = 4 * n if q.dtype == torch.float32 else n // 2 + n
    size = (keys + 128 * B * H * -(-Sq // 64)
            + B * KV * dhp * (1 + -(-Skv // 64)))
    scratch = torch.empty(size, dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    lib = BWD_LIB.load()
    fn = (lib.flash_attention_bwd_f32 if q.dtype == torch.float32
          else lib.flash_attention_bwd_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), scratch.data_ptr(), B, H, KV, Sq, Skv, dhp,
                 (ctypes.c_longlong * 15)(*strides), int(causal),
                 int(window), dh ** -0.5 * LOG2E, dh ** -0.5, stream)
    BWD_LIB.check(err, "flash_attention backward")
    if dhp != dh:
        dq, dk, dv = (t[..., :dh].contiguous() for t in (dq, dk, dv))
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


def _probs(q, k, causal, window):
    """softmax(q kᵀ / sqrt(dh) + mask) in f32, (B, KV, G, Sq, Skv), as
    ``attention_ref`` computes it."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, Sq, dh)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * dh ** -0.5
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return torch.softmax(torch.where(mask, logits, -1e30), dim=-1)


def bf16_grad_error_bound(q, k, v, do, grads_ref, causal=True, window=0):
    """Per-element bounds on |kernel − plain| of (dq, dk, dv) for bf16
    inputs, ``grads_ref`` being the plain version's gradients (autograd
    through ``attention_ref`` on the same q, k, v and cotangent ``do``,
    in f32 and rounded to bf16 once). Written from the kernel's roundings,
    with u = 2⁻⁸ (a bf16 rounding moves x by at most u|x|), P and dP
    exact in f32 but for the sums' order:

      * P and dS are rounded to bf16 as operands: u P_ij and u |dS_ij|;
      * delta = do·o reads the forward kernel's bf16 o, at most
        Δo = u softmax|v| + u |o| from the f32 o (``bf16_error_bound``'s
        two terms), so dS_ij moves by P_ij Δδ_i, Δδ_i = Σ_d |do_id| Δo_id;
      * dv_j = Σ_i P_ij do_i: u Σ_i P_ij |do_i|;
      * dq_i = scale Σ_j dS_ij (k_j − k̄) on the centred keys, rounded to
        bf16 (u |k_j − k̄|): scale Σ_j (2u |dS_ij| + P_ij Δδ_i) |k_j − k̄|;
      * dk_j = scale Σ_i dS_ij q_i over the G heads: E_j = scale Σ_i
        (u |dS_ij| + P_ij Δδ_i) |q_i|, and taking out dk's mean over the
        keys (zero analytically) moves it by at most the mean of E;
      * each gradient rounded to bf16 once in both versions: 1.02 · 2⁻⁷
        of |g_ref|, and the f32 sums' order, ``F32_GRAD_REL`` of the
        gradient's largest entry (the f32 kernel's gate).

    Never fitted to a run: a kernel above 1.0 is a kernel or a δ that is
    wrong."""
    u, scale = 2.0 ** -8, q.shape[-1] ** -0.5
    p = _probs(q, k, causal, window)
    vf, kf = v.float(), k.float()
    o = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    a = torch.einsum("bkgqs,bksd->bkgqd", p, vf.abs())
    dof = do.float().reshape(o.shape)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - (dof * o).sum(-1, keepdim=True))
    ddelta = (dof.abs() * (u * a + u * o.abs())).sum(-1, keepdim=True)
    pd = p * ddelta
    kc = (kf - kf.mean(2, keepdim=True)).abs()
    qa = q.float().abs().reshape(o.shape)
    dv = u * torch.einsum("bkgqs,bkgqd->bksd", p, dof.abs())
    dq = scale * torch.einsum("bkgqs,bksd->bkgqd", 2 * u * ds.abs() + pd, kc)
    e = scale * torch.einsum("bkgqs,bkgqd->bksd", u * ds.abs() + pd, qa)
    dk = e + e.mean(2, keepdim=True)
    return [x.reshape(g.shape) + 1.02 * 2.0 ** -7 * g.float().abs()
            + F32_GRAD_REL * g.float().abs().max()
            for x, g in zip((dq, dk, dv), grads_ref)]


def flash_attention(q, k, v, causal=True, window=0):
    """q (B,H,Sq,dh); k/v (B,KV,Skv,dh), all three of one dtype, f32 or
    bf16 (the reference casts each input to f32 and so also takes mixed
    dtypes; this wrapper refuses them on both devices). Returns (B,H,Sq,dh)
    in q's dtype: softmax(q kᵀ / sqrt(dh) + mask) v with head h reading kv
    head h // (H // KV), f32 accumulation. On CUDA, dh ≤ ``MAX_DH``, f32
    products in split TF32 and, for bf16 inputs, P rounded to bf16; when
    an input requires a gradient, the call is ``FlashAttention``, whose
    backward is the backward kernel."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return _on_card(q, k, v, causal, window)


def _on_card(q, k, v, causal, window):
    """The CUDA path of ``flash_attention``: ``FlashAttention`` when an
    input requires a gradient, else one forward launch."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    o = _launch(q, k, v, causal, window)
    flash_attention.launches += 1
    return o


# Kernel launches in this process (forward, backward); ``chip_smoke.py``
# zeroes them before each path it drives and reads them after.
flash_attention.launches = 0
flash_attention.bwd_launches = 0
