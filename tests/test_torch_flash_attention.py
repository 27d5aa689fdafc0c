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
import jax
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


# ------------------------------------------------------------- backward
# The reference has no Pallas backward: its LM differentiates plain
# attention. So the port's gradient (autograd through ``attention_ref`` on
# the CPU; the backward kernel on the card) is held against ``jax.vjp`` of
# the reference's plain version, within 1e-4 of each gradient's largest
# entry (f32 sums over up to Skv keys in another order; the kernel is at
# most 4.9e-6 from autograd of the plain version on an H100, at the
# qwen3-4b shape, ``chip_smoke.py`` 5b).
GRAD_TOL = 1e-4
GRAD_CASES = [(B, H, KV, S, S, dh, win, True) for B, H, KV, S, dh, win
              in SWEEP] + [(2, 4, 2, 50, 37, 32, 0, False),
                           (2, 4, 2, 50, 37, 32, 24, False),
                           (1, 4, 1, 97, 97, 24, 40, True)]


def _grad_inputs(B, H, KV, Sq, Skv, dh, seed):
    (jq, jk, jv), (q, k, v) = _inputs(B, H, KV, Sq, dh, "float32", seed=seed,
                                      Skv=Skv)
    do = np.random.default_rng(seed + 1).standard_normal(
        (B, H, Sq, dh)).astype(np.float32)
    return (jq, jk, jv), (q, k, v), do


def _reference_grads(jargs, do, causal, window):
    _, vjp = jax.vjp(lambda q, k, v: jattention_ref(
        q, k, v, causal=causal, window=window), *jargs)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close_grads(got, ref):
    for name, g, gr in zip("qkv", got, ref):
        np.testing.assert_allclose(_np(g), gr, atol=GRAD_TOL * np.abs(gr).max(),
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", GRAD_CASES)
def test_plain_gradient_matches_reference(B, H, KV, Sq, Skv, dh, win, causal):
    jargs, args, do = _grad_inputs(B, H, KV, Sq, Skv, dh, seed=Sq + dh)
    args = [a.requires_grad_() for a in args]
    flash_attention(*args, causal=causal, window=win).backward(
        torch.tensor(do))
    _close_grads([a.grad for a in args],
                 _reference_grads(jargs, do, causal, win))


def _split_rounded(x):
    """x = hi + lo, each rounded to TF32 (the backward kernel's split: lo
    rounded too, as the graph filter's, where the forward truncates it)."""
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def _mm3(a, b, one_pass=False):
    """a @ b as the backward kernel's split-TF32 products (lo·hi + hi·lo +
    hi·hi in f32), or as one-pass TF32 (hi·hi: a faulty kernel)."""
    (ah, al), (bh, bl) = _split_rounded(a), _split_rounded(b)
    if one_pass:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


# The backward kernel's tiles: dk/dv blocks of 128 keys over query tiles of
# 32 rows, dq blocks of 64 query rows over kv tiles of 32 keys.
KV_BKV, KV_BQ, Q_BQ, Q_BKV = 128, 32, 64, 32


def _bwd_emulation(q, k, v, do, causal, window, skip_first=False,
                   one_pass=False):
    """The backward kernel's algorithm and arithmetic in plain torch on the
    CPU. P rebuilt from the forward's row log-sum-exp (log2 units), delta
    = rowsum(do ∘ o). The dk/dv kernel per block of 128 keys: over the G
    query heads of its kv head and the query tiles of 32 rows that can see
    the block (its range arithmetic), the transposed scores Sᵀ = K Qᵀ and
    dPᵀ = V dOᵀ with keys as rows, then Pᵀ dO and dSᵀ Q, each tile's
    product added to the running dk, dv in f32. The dq kernel per query
    tile of 64 rows over the kv tiles of 32 keys it sees. Every product in
    split TF32 with lo rounded (``one_pass``: one-pass TF32, a faulty
    kernel). ``skip_first`` drops each key block's first query tile (a
    faulty range)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    sl2 = dh ** -0.5 * LOG2E
    mm = lambda a, b: _mm3(a, b, one_pass)
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (k, v))
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        live &= kj <= qi
    if window:
        live &= kj > qi - window
    s2 = (q @ kh.mT) * sl2
    lse = torch.logsumexp(torch.where(live, s2, -1e30) / LOG2E, -1) * LOG2E
    o = attention_ref(q, k, v, causal=causal, window=window)
    delta = (do * o).sum(-1)

    def probs(s, dp, heads, rows, cols, keys_as_rows):
        """P and dS of a tile from its scores and dP (keys as rows: the
        transposed tiles of the dk/dv kernel)."""
        m = live[rows, cols]
        l, dl = lse[:, heads, rows, None], delta[:, heads, rows, None]
        if keys_as_rows:
            m, l, dl = m.T, l.mT, dl.mT
        p = torch.where(m, torch.exp2(s * sl2 - l), 0.0)
        return p, p * (dp - dl)

    n_q = -(-Sq // KV_BQ)
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    for k_lo in range(0, Skv, KV_BKV):
        k_hi = min(k_lo + KV_BKV, Skv) - 1
        cols = slice(k_lo, k_hi + 1)
        i_begin = k_lo // KV_BQ if causal else 0
        i_end = (min(n_q, (k_hi + window - 1) // KV_BQ + 1) if window
                 else n_q)
        for g in range(G):
            heads = slice(g, H, G)     # the heads kv head h // G reads
            for it in range(i_begin + skip_first, i_end):
                rows = slice(it * KV_BQ, min(it * KV_BQ + KV_BQ, Sq))
                qt, dot = q[:, heads, rows], do[:, heads, rows]
                st = mm(k[:, :, cols], qt.mT)          # Sᵀ: keys x queries
                dpt = mm(v[:, :, cols], dot.mT)
                pt, dst = probs(st, dpt, heads, rows, cols, True)
                dv[:, :, cols] += mm(pt, dot)
                dk[:, :, cols] += mm(dst, qt)
    for q_lo in range(0, Sq, Q_BQ):
        q_hi = min(q_lo + Q_BQ, Sq) - 1
        rows = slice(q_lo, q_hi + 1)
        n_kv = -(-Skv // Q_BKV)
        j_end = min(n_kv, q_hi // Q_BKV + 1) if causal else n_kv
        j_begin = max(0, q_lo - window + 1) // Q_BKV if window else 0
        for jt in range(j_begin, j_end):
            cols = slice(jt * Q_BKV, min(jt * Q_BKV + Q_BKV, Skv))
            dp = mm(do[:, :, rows], vh[:, :, cols].mT)
            s = mm(q[:, :, rows], kh[:, :, cols].mT)
            dq[:, :, rows] += mm(probs(s, dp, slice(None), rows, cols,
                                       False)[1], kh[:, :, cols])
    scale = dh ** -0.5
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal",
                         GRAD_CASES + [(1, 4, 2, 200, 200, 16, 70, True),
                                       (1, 2, 1, 150, 150, 16, 0, True),
                                       (1, 4, 2, 300, 300, 24, 20, True),
                                       (1, 2, 2, 70, 140, 40, 0, False)])
def test_backward_kernel_algorithm_matches_reference(B, H, KV, Sq, Skv, dh,
                                                     win, causal):
    """The backward kernel's tiling, tile ranges and split-TF32 arithmetic
    (causal, windowed, non-causal ragged, GQA; several tiles each way at
    S = 150 to 300, a window narrower than a query tile, Skv > Sq) against
    ``jax.vjp`` of the reference."""
    jargs, args, do = _grad_inputs(B, H, KV, Sq, Skv, dh, seed=Sq + dh)
    got = _bwd_emulation(*args, torch.tensor(do), causal, win)
    _close_grads(got, _reference_grads(jargs, do, causal, win))


def test_backward_algorithm_check_catches_a_dropped_tile():
    jargs, args, do = _grad_inputs(1, 4, 2, 200, 200, 16, seed=4)
    got = _bwd_emulation(*args, torch.tensor(do), True, 70, skip_first=True)
    with pytest.raises(AssertionError):
        _close_grads(got, _reference_grads(jargs, do, True, 70))


def test_backward_algorithm_check_catches_one_pass_tf32():
    """The same products in one-pass TF32 miss the gradient gate: the
    split is what keeps the kernel at f32 accuracy (``chip_smoke.py`` 5b
    runs the same control on the card through cuBLAS's TF32 mode)."""
    jargs, args, do = _grad_inputs(1, 4, 2, 200, 200, 64, seed=4)
    ref = _reference_grads(jargs, do, True, 0)
    _close_grads(_bwd_emulation(*args, torch.tensor(do), True, 0), ref)
    got = _bwd_emulation(*args, torch.tensor(do), True, 0, one_pass=True)
    with pytest.raises(AssertionError):
        _close_grads(got, ref)


def test_cuda_style_call_keeps_the_gradient(monkeypatch):
    """A CUDA call's output comes from a ctypes launch and carries no
    ``grad_fn``. Under grad, the card path now goes through
    ``FlashAttention``, whose backward launches the backward kernel: with
    both launches stubbed by plain computations on CPU tensors (outputs
    detached, as a launch's are), q, k and v get the reference's gradients
    and the counters count one launch each way. Without grad it is one
    forward launch; bf16 inputs that require a gradient raise."""
    jargs, args, do = _grad_inputs(2, 4, 2, 40, 40, 16, seed=3)

    def launch(q, k, v, causal, window, want_lse=False):
        o = attention_ref(q, k, v, causal=causal, window=window).detach()
        return (o, torch.zeros(q.shape[:3])) if want_lse else o

    def launch_bwd(q, k, v, o, lse, do, causal, window):
        return tuple(g.detach() for g in _bwd_emulation(q, k, v, do, causal,
                                                        window))

    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops, "_launch_bwd", launch_bwd)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    args = [a.requires_grad_() for a in args]
    o = ops._on_card(*args, True, 8)
    assert o.grad_fn is not None
    o.backward(torch.tensor(do))
    assert (flash_attention.launches, flash_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    _close_grads([a.grad for a in args],
                 _reference_grads(jargs, do, True, 8))
    with torch.no_grad():
        o = ops._on_card(*args, True, 8)
    assert o.grad_fn is None and flash_attention.launches == before[0] + 2
    with pytest.raises(TypeError, match="float32"):
        ops._on_card(*(a.detach().bfloat16().requires_grad_() for a in args),
                     True, 0)
