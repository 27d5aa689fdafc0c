"""The port's flash attention against the reference's, on the CPU.

The reference's kernel (``repro.kernels.flash_attention.flash_attention``)
runs in Pallas interpret mode, as ``tests/test_kernels.py`` runs it; the
port's wrapper takes its plain version for CPU tensors. Inputs come from
numpy with a seed; bf16 inputs are the same f32 draws rounded to bf16 by
both frameworks (round to nearest even, so bit-equal).

Tolerance: 10x the reference's kernel tolerance (5e-5 f32, 5e-2 bf16),
the reference's own for this kernel (``test_flash_attention_sweep``);
the emulated CUDA arithmetic is also held to ``ops.bf16_error_bound``,
the card's per-element bf16 gate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention, ops)

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
SWEEP = [(1, 4, 4, 64, 32, 0), (2, 4, 2, 80, 32, 0), (1, 8, 2, 128, 64, 16),
         (1, 2, 1, 48, 16, 8)]


def _inputs(B, H, KV, S, dh, dtype, seed=0, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    arrs = [rng.standard_normal((B, n, s, dh)).astype(np.float32)
            for n, s in ((H, S), (KV, Skv), (KV, Skv))]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,H,KV,S,dh,win", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_kernel(B, H, KV, S, dh, win, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(B, H, KV, S, dh, dtype, seed=S + dh)
    o_ref = jflash(jq, jk, jv, causal=True, window=win, block_q=32,
                   block_kv=32)
    o = flash_attention(q, k, v, causal=True, window=win)
    assert o.dtype == q.dtype and o.shape == q.shape
    tol = 10 * TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,win", [(False, 0), (False, 24), (True, 40)])
def test_plain_version_matches_reference_oracle(causal, win):
    """Non-causal and windowed masks against the reference's oracle,
    including a ragged Skv (the port needs no block multiple)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 4, 2, 50, 32, "float32", seed=3,
                                      Skv=50 if causal else 37)
    np.testing.assert_allclose(
        _np(flash_attention(q, k, v, causal=causal, window=win)),
        _np(jattention_ref(jq, jk, jv, causal=causal, window=win)),
        atol=5e-5, rtol=5e-5)


def test_plain_version_reads_transposed_views():
    """The model hands the kernel (B, S, H, dh) projections as transposed
    views; the result does not depend on the layout."""
    _, (q, k, v) = _inputs(2, 4, 2, 30, 16, "float32", seed=1)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    torch.testing.assert_close(flash_attention(*views, window=8),
                               attention_ref(q, k, v, window=8))


def test_wrapper_checks():
    _, (q, k, v) = _inputs(1, 4, 2, 8, 16, "float32")
    with pytest.raises(ValueError, match="expected q"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q[..., :8], k, v)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.double(), v)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    before = flash_attention.launches
    flash_attention(q, k, v)             # the CPU path launches nothing
    assert flash_attention.launches == before


# The CUDA kernel's arithmetic, emulated in plain torch on the CPU (the
# kernel itself runs only on the card). f32 inputs: split TF32. Each
# operand x is hi + lo, hi = x rounded to TF32 (10 mantissa bits, round to
# nearest with ties away from zero, as cvt.rna), lo = x - hi, which the
# tensor core reads as TF32 by dropping its low 13 bits; each product is
# lo·hi + hi·lo + hi·hi in f32. bf16 inputs: f32 products of the bf16
# values, P rounded to bf16 before P·V. Both run the kernel's online
# softmax over kv tiles (32 keys in f32, 64 in bf16) with exp2 and the
# scale folded into log2 units.
LOG2E = 1.4426950408889634


def _tf32_round(x):
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def _tf32_trunc(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b):
    """a @ b in split TF32: lo·hi + hi·lo + hi·hi, the small ones first."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _kernel_emulation(q, k, v, causal, window, skip=None):
    """The kernel's tiled online softmax with its products, in f32.
    ``skip``: the first key of a kv tile to leave out (a faulty kernel)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    f32 = q.dtype == torch.float32
    bkv = 32 if f32 else 64
    mm = _split_mm if f32 else torch.matmul
    qf, kf, vf = (t.float() for t in (q, k, v))
    kf = kf.repeat_interleave(H // KV, dim=1)
    vf = vf.repeat_interleave(H // KV, dim=1)
    scale = torch.tensor(dh ** -0.5 * LOG2E, dtype=torch.float32)
    qi = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, dh))
    for k_lo in range(0, Skv, bkv):
        if k_lo == skip:
            continue
        kj = torch.arange(k_lo, min(k_lo + bkv, Skv))[None, :]
        live = torch.ones((Sq, kj.shape[1]), dtype=torch.bool)
        if causal:
            live &= kj <= qi
        if window:
            live &= kj > qi - window
        s = mm(qf, kf[:, :, k_lo:k_lo + bkv].transpose(-1, -2)) * scale
        s = torch.where(live, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(live, torch.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        if not f32:
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + mm(p, vf[:, :, k_lo:k_lo + bkv])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("B,H,KV,S,dh,win", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arithmetic_matches_reference_kernel(B, H, KV, S, dh, win,
                                                    dtype):
    """The kernel's arithmetic (split TF32 in f32; P in bf16 for bf16
    inputs) against the reference's Pallas kernel at the reference's own
    kernel tolerance, 5e-5 in f32 and 5e-2 in bf16."""
    (jq, jk, jv), (q, k, v) = _inputs(B, H, KV, S, dh, dtype, seed=S + dh)
    o_ref = jflash(jq, jk, jv, causal=True, window=win, block_q=32,
                   block_kv=32)
    o = _kernel_emulation(q, k, v, causal=True, window=win)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,win", [(False, 0), (True, 40)])
def test_kernel_arithmetic_matches_reference_oracle(causal, win):
    """Non-causal and windowed masks over several kv tiles, with a ragged
    Skv, against the reference's oracle at 5e-5."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 4, 2, 70, 48, "float32", seed=5,
                                      Skv=70 if causal else 45)
    np.testing.assert_allclose(
        _np(_kernel_emulation(q, k, v, causal=causal, window=win)),
        _np(jattention_ref(jq, jk, jv, causal=causal, window=win)),
        atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("B,H,KV,S,dh,win",
                         SWEEP + [(1, 2, 1, 512, 64, 0), (1, 2, 2, 300, 128, 70)])
def test_bf16_error_bound_holds_for_the_kernel_arithmetic(B, H, KV, S, dh,
                                                          win):
    """``ops.bf16_error_bound``, the card's per-element bf16 gate, holds
    for the kernel's bf16 arithmetic (P rounded to bf16) against the plain
    version."""
    _, (q, k, v) = _inputs(B, H, KV, S, dh, "bfloat16", seed=S + dh)
    o_ref = attention_ref(q, k, v, window=win)
    err = (_kernel_emulation(q, k, v, True, win).float()
           - o_ref.float()).abs()
    assert (err <= ops.bf16_error_bound(q, k, v, o_ref, window=win)).all()


@pytest.mark.parametrize("fault", ["dropped_tile", "window_one_wider"])
def test_bf16_error_bound_catches_faults(fault):
    """A kv tile left out late in long rows, or a window one key too wide,
    breaks ``ops.bf16_error_bound``, while the reference's 10x bf16
    tolerance (0.5) lets it pass."""
    S, win = (512, 0) if fault == "dropped_tile" else (256, 64)
    _, (q, k, v) = _inputs(1, 2, 1, S, 64, "bfloat16", seed=S)
    o_ref = attention_ref(q, k, v, window=win)
    o = (_kernel_emulation(q, k, v, True, win, skip=384)
         if fault == "dropped_tile"
         else _kernel_emulation(q, k, v, True, win + 1))
    err = (o.float() - o_ref.float()).abs()
    assert (err > ops.bf16_error_bound(q, k, v, o_ref, window=win)).any()
    tol = 10 * TOL["bfloat16"]
    assert torch.allclose(o.float(), o_ref.float(), atol=tol, rtol=tol)


def test_split_tf32_keeps_f32_accuracy():
    """Split TF32 is as close to the f64 product as f32 FFMA; one-pass TF32
    is not (about 2^-11 relative): the kernel must not drop to it."""
    rng = np.random.default_rng(0)
    a, b = (torch.tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((64, 128), (128, 64)))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    split_err = (_split_mm(a, b).double() - exact).abs().max().item()
    f32_err = ((a @ b).double() - exact).abs().max().item()
    one_pass = (_tf32_round(a) @ _tf32_round(b)).double()
    one_pass_err = (one_pass - exact).abs().max().item()
    assert split_err <= 4 * max(f32_err, 1e-7 * scale)
    assert one_pass_err > 30 * split_err
    assert one_pass_err > 1e-4 * scale


def test_tf32_rounding_is_cvt_rna():
    """Rounding the low 13 bits with ties away from zero: the split is
    exact (hi + lo == x) and |lo| is at most half a TF32 ulp of x."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      3.14159265, -2.7182817, 1e-20, 6e4])
    hi = _tf32_round(x)
    assert hi[1] == 1.0 + 2 ** -10 and hi[3] == -(1.0 + 2 ** -10)
    assert hi[2] == 1.0
    assert torch.equal(hi + (x - hi), x)
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(_tf32_round(hi), hi)


def test_vector_loads_decision():
    """The wrapper gives the kernel 16-byte cp.async tiles only when every
    row of every tensor starts on 16 bytes; otherwise per-element loads."""
    from repro_torch.kernels._layout import vector_loads
    _, (q, k, v) = _inputs(2, 4, 2, 30, 32, "float32")
    assert vector_loads(q, k, v)
    assert vector_loads(*(t.transpose(1, 2).contiguous().transpose(1, 2)
                          for t in (q, k, v)))
    assert not vector_loads(q[..., :30])                 # 120-byte rows
    q33 = _inputs(1, 1, 1, 8, 33, "float32")[1][0]
    assert not vector_loads(q33[..., :32])               # stride 33
    assert vector_loads(q.to(torch.bfloat16))
    assert not vector_loads(q.to(torch.bfloat16)[..., :20])  # 40-byte rows
