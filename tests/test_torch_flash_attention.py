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
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention, ops)

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

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
# kernel itself runs only on the card). f32 inputs: the split-TF32 wgmma
# design (``test_torch_flash_fwd_f32._f32_forward_emulation``): each
# operand x is hi + lo, both rounded to TF32 (10 mantissa bits, round to
# nearest with ties away from zero, as cvt.rna); each product lo·hi +
# hi·lo + hi·hi in the tensor cores' truncating chains, query tiles of 128
# rows in warpgroups of 64, key tiles of 64 (dh <= 64) or 32. bf16 inputs:
# the wgmma design (``_bf16_forward_emulation``): f32 products of the bf16
# values, P rounded to bf16 before P·V, query tiles of 128 rows in
# warpgroups of 64, key tiles of 128. Both run the kernel's online softmax
# with exp2 and the scale folded into log2 units. ``_split_mm`` is split
# TF32 with lo truncated, the mma.sync kernel's before the wgmma design.
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
    """The kernel's tiled online softmax with its products: f32 inputs
    take ``_f32_forward_emulation``, bf16 inputs
    ``_bf16_forward_emulation`` (the two wgmma designs). ``skip``: the
    first key of a kv tile to leave out (a faulty kernel)."""
    if q.dtype == torch.bfloat16:
        return _bf16_forward_emulation(q, k, v, causal, window, skip)[0]
    from test_torch_flash_fwd_f32 import _f32_forward_emulation
    return _f32_forward_emulation(q, k, v, causal, window, skip)[0]


# The bf16 forward kernel's tiles (the wgmma design): 128 query rows per
# block, 64 per consumer warpgroup; key tiles of 128.
FW_QROWS, FW_KT = 128, 128


def _bf16_forward_emulation(q, k, v, causal, window, skip=None,
                            round_p=True):
    """The bf16 forward kernel's algorithm and arithmetic in plain torch:
    per block of 128 query rows the key tiles of 128 that its rows can see
    (the kernel's range arithmetic), and per consumer warpgroup of 64 rows
    the tiles its own rows see; per tile S = Q Kᵀ in f32 from the bf16
    values, m the row max of the scores times dh^-0.5 log2(e), P =
    exp2(s·scale − m) (a masked score −inf: p = 0), l summing the f32 P,
    P rounded to bf16 before O·α + P V. o = O / max(l, 1e-30) rounded to
    bf16 once; lse = m + log2(l) in the same log2 units, as written for
    the backward. ``skip``: the first key of a tile left out (a faulty
    kernel); ``round_p=False`` feeds P V an f32 P (not the design)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    sl2 = dh ** -0.5 * LOG2E
    qf = q.float()
    kh, vh = (t.float().repeat_interleave(H // KV, dim=1) for t in (k, v))
    o = torch.zeros((B, H, Sq, dh))
    lse = torch.zeros((B, H, Sq))
    n_kv = -(-Skv // FW_KT)
    for q_lo in range(0, Sq, FW_QROWS):
        q_hi = min(q_lo + FW_QROWS, Sq) - 1
        j_end = min(n_kv, q_hi // FW_KT + 1) if causal else n_kv
        j_begin = (min(max(0, q_lo - window + 1) // FW_KT, j_end) if window
                   else 0)
        for qw_lo in range(q_lo, q_hi + 1, 64):     # the two warpgroups
            qw_hi = min(qw_lo + 63, Sq - 1)
            jw_end = max(j_begin, min(j_end, qw_hi // FW_KT + 1) if causal
                         else j_end)
            jw_begin = (min(max(j_begin, max(0, qw_lo - window + 1)
                                // FW_KT), jw_end) if window else j_begin)
            rows = slice(qw_lo, qw_hi + 1)
            qi = torch.arange(qw_lo, qw_hi + 1)[:, None]
            m = torch.full((B, H, qw_hi + 1 - qw_lo, 1), -1e30)
            l = torch.zeros_like(m)
            acc = torch.zeros((B, H, qw_hi + 1 - qw_lo, dh))
            for j in range(jw_begin, jw_end):
                cols = slice(j * FW_KT, min(j * FW_KT + FW_KT, Skv))
                if j * FW_KT == skip:
                    continue
                kj = torch.arange(cols.start, cols.stop)[None, :]
                live = torch.ones((qi.shape[0], kj.shape[1]),
                                  dtype=torch.bool)
                if causal:
                    live &= kj <= qi
                if window:
                    live &= kj > qi - window
                s = torch.where(live, qf[:, :, rows] @ kh[:, :, cols].mT,
                                -torch.inf)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * sl2 - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                if round_p:
                    p = p.to(torch.bfloat16).float()
                acc = acc * alpha + p @ vh[:, :, cols]
                m = m_new
            l = l.clamp_min(1e-30)
            o[:, :, rows] = acc / l
            lse[:, :, rows] = (m + torch.log2(l))[..., 0]
    return o.to(torch.bfloat16), lse


@pytest.mark.parametrize("B,H,KV,S,dh,win", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arithmetic_matches_reference_kernel(B, H, KV, S, dh, win,
                                                    dtype):
    """The kernel's arithmetic (the split-TF32 wgmma design in f32; P in
    bf16 for bf16 inputs) against the reference's Pallas kernel at the
    reference's own kernel tolerance, 5e-5 in f32 and 5e-2 in bf16."""
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
    """``_layout.vector_loads`` (the wkv wrapper's flag): 16-byte cp.async
    tiles only when every row of every tensor starts on 16 bytes;
    otherwise per-element loads."""
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


def test_tma_operands_decision():
    """The bf16 backward reads q, k, v and do by TMA: the wrapper keeps a
    tensor whose rows TMA can read (contiguous, or the model's transposed
    views), copies one that it cannot (a row off 16 bytes, a stride not a
    multiple of 8 elements) to a contiguous tensor, and pads dh to a
    multiple of 8 with zeros (all five, the gradients sliced back after).
    o is read by plain loads and kept as it is. A stride over an axis of
    one entry is never used."""
    from repro_torch.kernels._layout import tma_rows
    _, (q, k, v) = _inputs(2, 4, 2, 30, 64, "float32")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    (q2, k2, v2, o2, d2), dhp = ops.tma_operands(q, k, v, q, q)
    assert dhp == 64 and all(a is b for a, b in zip((q2, k2, v2, o2, d2),
                                                    (q, k, v, q, q)))
    tq = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert tma_rows(tq) and ops.tma_operands(tq, k, v, q, q)[0][0] is tq
    off = torch.nn.functional.pad(q, (0, 1))[..., 1:]    # rows off 16 bytes
    odd = torch.randn(2, 4, 30, 66).to(torch.bfloat16)[..., :64]
    for bad in (off, odd):
        assert not tma_rows(bad)
        (q3, _, _, o3, d3), _ = ops.tma_operands(bad, k, v, bad, bad)
        assert q3 is not bad and q3.is_contiguous() and tma_rows(q3)
        assert torch.equal(q3, bad) and o3 is bad and d3 is not bad
    one = torch.empty((1, 1, 30, 72), dtype=torch.bfloat16)[..., :64]
    assert one.stride()[:2] == (2160, 2160) and tma_rows(one[:, :, :1])
    q20 = q[..., :20]
    (q4, k4, v4, o4, d4), dhp = ops.tma_operands(q20, k[..., :20],
                                                 v[..., :20], q20, q20)
    assert dhp == 24 and all(t.shape[-1] == 24 and tma_rows(t)
                             for t in (q4, k4, v4, o4, d4))
    assert torch.equal(q4[..., :20], q20) and not q4[..., 20:].any()


def test_fully_masked_rows_keep_each_reference_functions_semantics():
    """A non-causal windowed call with Sq > Skv + window − 1: the last rows
    see no key. The reference's Pallas kernel (interpret mode) gives them
    o = 0 (dead blocks skipped, p zeroed under the mask, l floored at
    1e-30), as the port's CUDA kernels do (``tests/test_torch_cuda.py``);
    the reference's ``attention_ref`` masks with −1e30 and softmaxes, so
    uniform weights over every key, as the port's ``attention_ref`` does.
    The port keeps each reference function's semantics."""
    Sq, Skv, win = 64, 32, 8
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, Sq, 16, "float32", seed=11,
                                      Skv=Skv)
    dead = np.arange(Sq) >= Skv + win - 1
    assert dead.sum() == Sq - (Skv + win - 1) > 0
    o_kernel = _np(jflash(jq, jk, jv, causal=False, window=win, block_q=32,
                          block_kv=32))
    assert (o_kernel[:, :, dead] == 0).all()
    assert (np.abs(o_kernel[:, :, ~dead]).max(-1) > 0).all()
    o_ref = _np(jattention_ref(jq, jk, jv, causal=False, window=win))
    o = attention_ref(q, k, v, causal=False, window=win)
    np.testing.assert_allclose(_np(o), o_ref, atol=5e-6, rtol=5e-6)
    uniform = np.repeat(_np(v).mean(2, keepdims=True), 2, axis=1)
    np.testing.assert_allclose(_np(o)[:, :, dead],
                               np.broadcast_to(uniform, o.shape)[:, :, dead],
                               atol=5e-6)
    np.testing.assert_allclose(o_kernel[:, :, ~dead], o_ref[:, :, ~dead],
                               atol=10 * TOL["float32"])


# ------------------------------------------------- bf16 forward (wgmma)
# Non-causal (ragged Sq, Skv a multiple of the reference's block for its
# non-causal rule) and windowed, over several of the kernel's 128-row and
# 128-key tiles: (B, H, KV, Sq, Skv, dh, window, causal).
FWD_BF16_CASES = [(2, 4, 2, 50, 64, 32, 0, False),
                  (1, 4, 2, 200, 160, 64, 0, False),
                  (1, 2, 2, 150, 96, 48, 24, False),
                  (1, 2, 1, 300, 300, 64, 70, True),
                  (1, 4, 1, 260, 260, 32, 129, True)]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", FWD_BF16_CASES)
def test_bf16_forward_design_matches_reference(B, H, KV, Sq, Skv, dh, win,
                                               causal):
    """The wgmma design's tiles and roundings against the reference's
    Pallas kernel (interpret mode) at its bf16 tolerance, and within
    ``ops.bf16_error_bound`` of the plain version (``SWEEP`` runs through
    ``test_kernel_arithmetic_matches_reference_kernel``); its lse against
    the plain softmax's. Rows that see no key (a non-causal window with
    Sq > Skv + window − 1) get o = 0, as from the reference's kernel."""
    (jq, jk, jv), (q, k, v) = _inputs(B, H, KV, Sq, dh, "bfloat16",
                                      seed=Sq + Skv + dh, Skv=Skv)
    o, lse = _bf16_forward_emulation(q, k, v, causal, win)
    o_ref = jflash(jq, jk, jv, causal=causal, window=win, block_q=32,
                   block_kv=32)
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])
    kh = k.float().repeat_interleave(H // KV, dim=1)
    s2 = (q.float() @ kh.mT) * dh ** -0.5 * LOG2E
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        live &= kj <= qi
    if win:
        live &= kj > qi - win
    seen = live.any(-1)
    plain = attention_ref(q, k, v, causal=causal, window=win)
    err = (o.float() - plain.float()).abs()
    bound = ops.bf16_error_bound(q, k, v, plain, causal=causal, window=win)
    assert (err <= bound)[:, :, seen].all()
    assert not o[:, :, ~seen].any()
    # lse: log2 of the softmax denominator of the scaled scores
    ref = torch.logsumexp(torch.where(live, s2, -torch.inf) / LOG2E,
                          -1) * LOG2E
    torch.testing.assert_close(lse[..., seen], ref[..., seen], atol=1e-5,
                               rtol=1e-6)


def _rounding_probe():
    """One query over two keys (non-causal, dh = 16) whose scores give
    p0 = 1 and p1 = exp2(-0.01171875 · 16^-0.5 log2 e) = 0.99707, which
    bf16 holds as 1 − 2⁻⁸; v0 = 0, v1 = 256 in the first column. With P
    rounded to bf16 before P·V and l summing the f32 P, o = 256 · bf16(p1)
    / (1 + p1) = 127.687, which rounds to 127.5 in bf16; with an f32 P it
    is 127.813, which rounds to 128."""
    q = torch.zeros((1, 1, 1, 16))
    k = torch.zeros((1, 1, 2, 16))
    v = torch.zeros((1, 1, 2, 16))
    q[..., 0] = 1.0
    k[0, 0, 1, 0] = -0.01171875
    v[0, 0, 1, 0] = 256.0
    return [t.to(torch.bfloat16) for t in (q, k, v)]


@pytest.mark.parametrize("fault", [None, "dropped_tile", "p_in_f32"])
def test_bf16_forward_checks_catch_faults(fault):
    """The design passes both checks; a key tile left out leaves
    ``ops.bf16_error_bound`` (long rows, the last tile of 128), and P left
    in f32 (more accurate, so no bound against the plain version can see
    it) misses the rounding probe, whose answer the card's kernel must
    give too (``tests/test_torch_cuda.py``)."""
    _, (q, k, v) = _inputs(1, 2, 1, 512, 64, "bfloat16", seed=512)
    plain = attention_ref(q, k, v)
    o = _bf16_forward_emulation(q, k, v, True, 0,
                                skip=384 if fault == "dropped_tile" else None,
                                round_p=fault != "p_in_f32")[0]
    within = ((o.float() - plain.float()).abs()
              <= ops.bf16_error_bound(q, k, v, plain)).all().item()
    probe = _bf16_forward_emulation(*_rounding_probe(), False, 0,
                                    round_p=fault != "p_in_f32")[0]
    rounded = probe[0, 0, 0, 0].item() == 127.5
    assert (within and rounded) == (fault is None)
    assert within == (fault != "dropped_tile")
    assert rounded == (fault != "p_in_f32")


def _at(ptr, shape, strides):
    """A bf16 CPU tensor over the memory at ``ptr`` (what a launch reads
    through the pointer and strides it is given)."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = (ctypes.c_uint16 * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.bfloat16).as_strided(shape,
                                                                  strides)


def test_bf16_call_passes_tma_legal_operands(monkeypatch):
    """A bf16 CUDA call, with the library stubbed by a plain computation
    on CPU tensors that reads its operands through the pointers, dh and
    strides it is given (as the kernel does): the model's transposed views
    at dh = 80 pass as they are (TMA reads their rows; o keeps q's
    strides); dh = 20 passes zero-padded to 24 and rows off 16 bytes pass
    as contiguous copies, o sliced back to 20; the scale is always that
    of the true dh; one launch is counted per call."""
    import contextlib
    import types
    seen = []

    class Lib:
        def flash_attention_bf16(self, qp, kp, vp, op, B, H, KV, Sq, Skv, dh,
                                 strides, causal, window, scale_log2, vec,
                                 lse, stream):
            st = [[strides[3 * i + j] for j in range(3)] + [1]
                  for i in range(4)]
            q, k, v, o = (_at(p, (B, n, S, dh), s) for p, n, S, s in zip(
                (qp, kp, vp, op), (H, KV, KV, H), (Sq, Skv, Skv, Sq), st))
            seen.append({"ptrs": (qp, kp, vp), "dh": dh, "scale": scale_log2,
                         "operands": [t.clone() for t in (q, k, v)],
                         "strides": st})
            kh, vh = (t.float().repeat_interleave(H // KV, dim=1)
                      for t in (k, v))
            s = (q.float() @ kh.mT) * scale_log2
            i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
            live = (j <= i) if causal else torch.ones_like(i * j, dtype=bool)
            p = torch.softmax(torch.where(live, s, -1e30) / LOG2E, -1)
            o.copy_((p @ vh).to(torch.bfloat16))
            return 0

    monkeypatch.setattr(ops.LIB, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    rng = np.random.default_rng(7)

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)

    # the model's (B, S, H, dh) projections as transposed views, dh = 80
    q, k, v = (draw(2, 40, n, 80).transpose(1, 2) for n in (4, 2, 2))
    before = flash_attention.launches
    with torch.no_grad():
        o = ops._on_card(q, k, v, True, 0)
    call = seen[-1]
    assert call["ptrs"] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert call["dh"] == 80 and call["scale"] == 80 ** -0.5 * LOG2E
    assert o.stride() == q.stride() and o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    # dh = 20: padded with zeros to 24, o sliced back
    q, k, v = (draw(1, n, 30, 20) for n in (4, 2, 2))
    o = ops._on_card(q, k, v, True, 0)
    call = seen[-1]
    assert call["dh"] == 24 and call["scale"] == 20 ** -0.5 * LOG2E
    for got, x in zip(call["operands"], (q, k, v)):
        assert torch.equal(got[..., :20], x) and not got[..., 20:].any()
    assert o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o.float(), attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    # rows off 16 bytes (a 41-element row stride): contiguous copies
    q, k, v = (draw(1, n, 30, 41)[..., 1:] for n in (4, 2, 2))
    o = ops._on_card(q, k, v, True, 0)
    call = seen[-1]
    assert call["dh"] == 40 and call["ptrs"][0] != q.data_ptr()
    assert all(s[:3] == [n * 30 * 40, 30 * 40, 40] for s, n in
               zip(call["strides"][:3], (4, 2, 2)))
    torch.testing.assert_close(o.float(), attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    assert flash_attention.launches == before + 3
