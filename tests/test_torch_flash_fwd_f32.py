"""The f32 flash-attention forward's design on the CPU: a plain-torch
emulation of the kernel's tiles and arithmetic, against the reference's
Pallas kernel (interpret mode) and an f64 oracle.

The kernel (``fwd_tf32_kernel`` in ``csrc/flash_attention.cu``) runs only
on the card (``tests/test_torch_cuda.py``); here its arithmetic is
emulated tile by tile (``_f32_forward_emulation``): blocks of 128 query
rows in two warpgroups of 64, key tiles of 64 keys (dh <= 64) or 32
(dh <= 128) in the kernel's range arithmetic, split TF32 with hi and lo
both rounded to nearest, the wgmma chains' truncating adds (the scores in
a fresh accumulator per tile; P·V per tile in fresh accumulators added to
the running O in f32 registers, or chained through O), the online softmax
in log2 units with the scale folded in, and the keys of each k-step of
P·V permuted as the kernel stores Vᵀ (a relabelling of the sum, so no
change to the result). Inputs come from numpy with a seed. Faulty
variants (a dropped tile, one-pass TF32, lo dropped) must miss the same
checks."""
import ctypes

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention as jflash
from test_torch_flash_attention import LOG2E, SWEEP, TOL, _inputs, _np, \
    _tf32_round

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

# The kernel's tiles: 128 query rows per block, 64 per consumer
# warpgroup; each product advances 8 along its sum per wgmma.
QROWS, WG_ROWS, KSTEP = 128, 64, 8


def _keys(dh):
    """Keys per tile of the instance that takes dh: 64 at dh <= 64, 32 at
    dh <= 128 (split tiles of 64 keys do not fit beside Q there)."""
    return 64 if dh <= 64 else 32


def _trunc(x):
    """f64 values to f32, rounded toward zero: an add into a tensor-core
    accumulator truncates."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _split(x, lo="round"):
    """x = hi + lo: hi rounded to TF32; lo = x − hi rounded to TF32
    (``"round"``, the design), truncated (``"trunc"``, the mma.sync kernel
    before it) or dropped (``"drop"``)."""
    hi = _tf32_round(x)
    if lo == "drop":
        return hi, torch.zeros_like(x)
    r = x - hi
    return hi, (_tf32_round(r) if lo == "round"
                else (r.contiguous().view(torch.int32) & ~0x1FFF).view(
                    torch.float32))


def _chain(acc, a, b, products=("lh", "hl", "hh"), lo="round",
           lo_b=None):
    """acc + a @ b as one of the kernel's wgmma chains: per k-step of 8
    the split-TF32 products named (``"lh"`` a_lo b_hi, ``"hl"`` a_hi
    b_lo, ``"hh"`` a_hi b_hi; each exact, the 8 terms summed exactly), in
    that order, each added to the f32 accumulator with truncation.
    ``acc`` None is a fresh accumulator (scale-d 0). ``lo`` splits both
    operands, ``lo_b`` (default ``lo``) the B operand alone: the key
    tiles the split pass writes."""
    (ah, al), (bh, bl) = _split(a, lo), _split(b, lo_b or lo)
    ops = {"lh": (al, bh), "hl": (ah, bl), "hh": (ah, bh)}
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], KSTEP):
        s = slice(k0, k0 + KSTEP)
        for name in products:
            x, y = ops[name]
            acc = _trunc(acc.double() + x[..., s].double()
                         @ y[..., s, :].double())
    return acc


def _kperm(n):
    """The kernel's order of n keys (a multiple of 8) in Vᵀ: within each
    k-step of 8, key 2t at column t and key 2t + 1 at column t + 4 (P's
    accumulator registers are then the A fragment as they stand)."""
    x = torch.arange(n)
    return (x & ~7) | ((x & 7) >> 1) | ((x & 1) << 2)


def _f32_forward_emulation(q, k, v, causal, window, skip=None,
                           one_pass=False, lo_b=None, chain="fresh"):
    """The f32 forward kernel's algorithm and arithmetic in plain torch:
    per block of 128 query rows the key tiles that its rows can see (the
    kernel's range arithmetic), and per consumer warpgroup of 64 rows the
    tiles its own rows see; per tile S = Q Kᵀ over dh in two fresh wgmma
    chains (hi·hi in one, lo·hi and hi·lo in the other, added in f32), m
    the row max of the scores times dh^-0.5 log2(e), P = exp2(s·scale −
    m) (a masked score −inf: p = 0), l summing the f32 P; P·V with P split
    and the tile's keys in the kernel's Vᵀ order, one chain (lo·hi, hi·lo,
    hi·hi per k-step). ``chain="fresh"`` (the design): each tile's P·V in
    fresh accumulators, then O = (O + part) · α in f32; ``"chained"``:
    O · α, then P·V added into O by the chain. o = O / max(l, 1e-30);
    lse = m + log2(l) in the same log2 units, as written for the backward.
    Faulty kernels: ``skip``, the first key of a tile left out;
    ``one_pass``, one-pass TF32; ``lo_b="drop"``, the lo planes of the
    split key tiles (K and Vᵀ) dropped."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    keys = _keys(dh)
    sl2 = torch.tensor(dh ** -0.5 * LOG2E, dtype=torch.float32)
    kh, vh = (t.float().repeat_interleave(H // KV, dim=1) for t in (k, v))
    qf = q.float()
    o = torch.zeros((B, H, Sq, dh))
    lse = torch.zeros((B, H, Sq))
    n_kv = -(-Skv // keys)
    big = ("hh",)
    small = () if one_pass else ("lh", "hl")

    def scores(a, b):                    # two fresh chains, added in f32
        s = _chain(None, a, b, big, lo_b=lo_b)
        return s + _chain(None, a, b, small, lo_b=lo_b) if small else s

    def pv(acc, a, b):                   # one chain, the small ones first
        return _chain(acc, a, b, small + big, lo_b=lo_b)

    for q_lo in range(0, Sq, QROWS):
        q_hi = min(q_lo + QROWS, Sq) - 1
        j_end = min(n_kv, q_hi // keys + 1) if causal else n_kv
        j_begin = (min(max(0, q_lo - window + 1) // keys, j_end) if window
                   else 0)
        for qw_lo in range(q_lo, q_hi + 1, WG_ROWS):
            qw_hi = min(qw_lo + WG_ROWS - 1, Sq - 1)
            jw_end = max(j_begin, min(j_end, qw_hi // keys + 1) if causal
                         else j_end)
            jw_begin = (min(max(j_begin, max(0, qw_lo - window + 1) // keys),
                            jw_end) if window else j_begin)
            rows = slice(qw_lo, qw_hi + 1)
            qi = torch.arange(qw_lo, qw_hi + 1)[:, None]
            m = torch.full((B, H, qi.shape[0], 1), -1e30)
            l = torch.zeros_like(m)
            acc = torch.zeros((B, H, qi.shape[0], dh))
            part = None
            for j in range(jw_begin, jw_end):
                if j * keys == skip:
                    continue
                cols = slice(j * keys, min(j * keys + keys, Skv))
                kj = torch.arange(cols.start, cols.stop)[None, :]
                live = torch.ones((qi.shape[0], kj.shape[1]),
                                  dtype=torch.bool)
                if causal:
                    live &= kj <= qi
                if window:
                    live &= kj > qi - window
                s = torch.where(live, scores(qf[:, :, rows],
                                             kh[:, :, cols].mT), -torch.inf)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2((s.double() * sl2.double()
                                - m_new.double()).float())
                l = l * alpha + p.sum(-1, keepdim=True)
                m = m_new
                # the tile's keys padded to whole k-steps (zeros: TMA's
                # fill) and put in the kernel's Vᵀ order
                n = -(-p.shape[-1] // KSTEP) * KSTEP
                pp = torch.zeros(p.shape[:-1] + (n,))
                pp[..., :p.shape[-1]] = p
                vv = torch.zeros((B, H, n, dh))
                vv[:, :, :p.shape[-1]] = vh[:, :, cols]
                order = torch.argsort(_kperm(n))
                pp, vv = pp[..., order], vv[:, :, order]
                if chain == "fresh":
                    if part is not None:
                        acc = (acc + part) * alpha
                    part = pv(None, pp, vv)
                else:
                    acc = pv(acc * alpha, pp, vv)
            if part is not None:
                acc = acc + part
            l = l.clamp_min(1e-30)
            o[:, :, rows] = acc / l
            lse[:, :, rows] = (m + torch.log2(l))[..., 0]
    return o, lse


def _mma_sync_emulation(q, k, v, causal, window):
    """The mma.sync kernel this design replaces, under the same
    model of the tensor cores' accumulation: kv tiles of 32 keys over all
    rows, lo truncated; per tile the scores' hi·hi in one fresh chain and
    lo·hi, hi·lo in another (added in f32); O chained through every tile
    (O · α, then lo·hi, hi·lo, hi·hi per k-step of 8 added into it with
    truncation)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qf, kf, vf = (t.float() for t in (q, k, v))
    kf, vf = (t.repeat_interleave(H // KV, dim=1) for t in (kf, vf))
    sl2 = torch.tensor(dh ** -0.5 * LOG2E, dtype=torch.float32)
    qi = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, dh))
    for k_lo in range(0, Skv, 32):
        kj = torch.arange(k_lo, min(k_lo + 32, Skv))[None, :]
        live = torch.ones((Sq, kj.shape[1]), dtype=torch.bool)
        if causal:
            live &= kj <= qi
        if window:
            live &= kj > qi - window
        kt = kf[:, :, k_lo:k_lo + 32].mT
        s = (_chain(None, qf, kt, ("hh",), "trunc")
             + _chain(None, qf, kt, ("lh", "hl"), "trunc"))
        s = torch.where(live, s * sl2, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(live, torch.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = _chain(acc * alpha, p, vf[:, :, k_lo:k_lo + 32], lo="trunc")
        m = m_new
    return acc / l.clamp_min(1e-30)


def _oracle(q, k, v, causal, window):
    """softmax(q kᵀ / sqrt(dh) + mask) v in f64; rows that see no key 0."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    kd, vd = (t.double().repeat_interleave(H // KV, dim=1) for t in (k, v))
    s = q.double() @ kd.mT * dh ** -0.5
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        live &= kj <= qi
    if window:
        live &= kj > qi - window
    p = torch.softmax(torch.where(live, s, -torch.inf), -1)
    return torch.nan_to_num(p) @ vd


# The card's f32 gate (chip_smoke.py FLASH_F32_ERR_MAX), here against f64.
F32_ERR_MAX = 1e-5
# SWEEP (causal) and: non-causal with a ragged Skv in each instance, Sq >
# Skv and Sq < Skv, windows over several tiles in each instance, a
# non-causal window whose last rows see no key (o = 0, as from the
# reference's kernel). (B, H, KV, Sq, Skv, dh, window, causal)
FWD_F32_CASES = ([(B, H, KV, S, S, dh, win, True)
                  for B, H, KV, S, dh, win in SWEEP]
                 + [(2, 4, 2, 50, 45, 32, 0, False),
                    (1, 2, 1, 70, 45, 96, 0, False),
                    (1, 4, 2, 150, 96, 48, 0, False),
                    (1, 2, 2, 40, 200, 80, 0, False),
                    (1, 2, 1, 300, 300, 64, 70, True),
                    (1, 4, 2, 260, 260, 128, 40, True),
                    (1, 4, 2, 96, 40, 32, 16, False)])


def _reference_kernel(jq, jk, jv, causal, window):
    """The reference's Pallas kernel in interpret mode, in blocks of 64
    (a non-causal Skv off that multiple in one block of Skv keys: its
    non-causal rule)."""
    Skv = jk.shape[2]
    bkv = Skv if not causal and Skv % 64 else 64
    return jflash(jq, jk, jv, causal=causal, window=window, block_q=64,
                  block_kv=bkv)


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", FWD_F32_CASES)
def test_f32_forward_design_matches_reference_kernel(B, H, KV, Sq, Skv, dh,
                                                     win, causal):
    """The design's tiles, ranges and split-TF32 chains against the
    reference's Pallas kernel at its flash tolerance (10 x 5e-5), and its
    log-sum-exp (log2 units, the backward's input) against the plain
    softmax's. Rows that see no key get o = 0."""
    (jq, jk, jv), (q, k, v) = _inputs(B, H, KV, Sq, dh, "float32",
                                      seed=Sq + Skv + dh, Skv=Skv)
    o, lse = _f32_forward_emulation(q, k, v, causal, win)
    tol = 10 * TOL["float32"]
    np.testing.assert_allclose(_np(o), _np(_reference_kernel(
        jq, jk, jv, causal, win)), atol=tol, rtol=tol)
    kh = k.repeat_interleave(H // KV, dim=1)
    s2 = (q @ kh.mT) * dh ** -0.5 * LOG2E
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        live &= kj <= qi
    if win:
        live &= kj > qi - win
    seen = live.any(-1)
    assert not o[:, :, ~seen].any()
    ref = torch.logsumexp(torch.where(live, s2, -torch.inf) / LOG2E,
                          -1) * LOG2E
    torch.testing.assert_close(lse[..., seen], ref[..., seen], atol=1e-5,
                               rtol=1e-6)


# Several tiles each way in each instance: causal, a window, non-causal
# with Sq > Skv and Sq < Skv. (B, H, KV, Sq, Skv, dh, window, causal)
ORACLE_CASES = [(1, 2, 1, 512, 512, 128, 0, True),
                (1, 2, 1, 512, 512, 64, 0, True),
                (1, 2, 1, 512, 512, 128, 100, True),
                (1, 2, 2, 300, 200, 64, 0, False),
                (1, 2, 2, 200, 300, 96, 0, False)]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", ORACLE_CASES)
def test_f32_forward_design_is_no_farther_from_f64_than_mma_sync(
        B, H, KV, Sq, Skv, dh, win, causal):
    """Against softmax(q kᵀ / sqrt(dh)) v in f64, the design (lo rounded,
    the scores' small products in their own chain, each tile's P·V in
    fresh accumulators) is no farther than the mma.sync kernel it
    replaces, under the same model of the tensor cores' truncating adds
    (1.30e-6 against 2.16e-6 at the first case), and within the card's
    f32 gate. O chained through the tiles would drift (2.07e-6 there,
    ``chain="chained"``)."""
    _, (q, k, v) = _inputs(B, H, KV, Sq, dh, "float32", seed=Sq + dh,
                           Skv=Skv)
    exact = _oracle(q, k, v, causal, win)
    design = (_f32_forward_emulation(q, k, v, causal, win)[0].double()
              - exact).abs().max().item()
    mma_sync = (_mma_sync_emulation(q, k, v, causal, win).double()
                - exact).abs().max().item()
    assert design <= mma_sync and design <= F32_ERR_MAX


@pytest.mark.parametrize("fault", [None, "dropped_tile", "one_pass_tf32",
                                   "lo_dropped"])
def test_f32_forward_design_faults_miss_the_checks(fault):
    """At an input the design holds (causal, S = 512, dh = 128): a key
    tile left out (keys 256–287), one-pass TF32 products, and the lo
    planes of the split key tiles dropped (hi alone in K and Vᵀ) each miss
    the card's f32 gate against f64 (1.13e-3 and 9.0e-4 for the last two)
    and the reference kernel's tolerance (10 x 5e-5)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, 1, 512, 128, "float32",
                                      seed=640)
    kw = {None: {}, "dropped_tile": {"skip": 256},
          "one_pass_tf32": {"one_pass": True},
          "lo_dropped": {"lo_b": "drop"}}[fault]
    o = _f32_forward_emulation(q, k, v, True, 0, **kw)[0]
    gate = (o.double() - _oracle(q, k, v, True, 0)).abs().max().item()
    tol = 10 * TOL["float32"]
    ref = _np(_reference_kernel(jq, jk, jv, True, 0))
    within = np.allclose(_np(o), ref, atol=tol, rtol=tol)
    assert (gate <= F32_ERR_MAX) == (fault is None)
    assert within == (fault is None)


def test_vt_key_order_is_a_relabelling():
    """Vᵀ's key order within each k-step of 8 (key 2t at column t, 2t + 1
    at t + 4) is a permutation whose inverse is the split pass's
    ``(c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1)``; P's accumulator
    registers (keys 2t, 2t + 1 of rows g, g + 8) then land on A's columns
    t and t + 4. Applied to both P and V, it leaves each wgmma chain's
    result bit-equal (each k-step's 8 terms are summed exactly)."""
    c = torch.arange(64)
    kp = _kperm(64)
    assert torch.equal(kp.sort().values, c)
    inverse = (c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1)
    assert torch.equal(kp[inverse], c) and torch.equal(inverse[kp], c)
    t = torch.arange(4)
    assert torch.equal(kp[2 * t], t) and torch.equal(kp[2 * t + 1], t + 4)
    rng = np.random.default_rng(1)
    p = torch.tensor(rng.random((2, 64, 32)).astype(np.float32))
    v = torch.tensor(rng.standard_normal((2, 32, 48)).astype(np.float32))
    order = torch.argsort(_kperm(32))
    assert torch.equal(_chain(None, p, v),
                       _chain(None, p[..., order], v[:, order]))


def _f32_at(ptr, shape, strides):
    """An f32 CPU tensor over the memory at ``ptr`` (what a launch reads
    through the pointer and strides it is given)."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = (ctypes.c_float * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.float32).as_strided(shape,
                                                                 strides)


def test_f32_call_passes_tma_legal_operands(monkeypatch):
    """An f32 CUDA call (``ops._launch``), with the library stubbed by a
    plain computation on CPU tensors that reads its operands through the
    pointers, dh and strides it is given and refuses what the C entry
    refuses (dh off a multiple of 4, a q or o row off 16 bytes, scratch
    off 16 bytes): the model's transposed views at dh = 64 pass as they
    are (o keeps q's strides); dh = 18 passes zero-padded to 20 and rows
    off 16 bytes pass as contiguous copies, o sliced back; the scale is
    always that of the true dh; the scratch holds ``fwd_scratch_floats``
    of the padded dh; one launch is counted per call."""
    import contextlib
    import types
    from repro_torch.kernels._layout import tma_rows
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention, ops)
    seen = []

    class Lib:
        def flash_attention_f32(self, qp, kp, vp, op, B, H, KV, Sq, Skv, dh,
                                strides, causal, window, scale_log2, sp,
                                lse, stream):
            st = [[strides[3 * i + j] for j in range(3)] + [1]
                  for i in range(4)]
            q, k, v, o = (_f32_at(p, (B, n, S, dh), s) for p, n, S, s in zip(
                (qp, kp, vp, op), (H, KV, KV, H), (Sq, Skv, Skv, Sq), st))
            legal = (dh % 4 == 0 and tma_rows(q) and tma_rows(o)
                     and sp % 16 == 0)
            seen.append({"ptrs": (qp, kp, vp), "dh": dh, "scale": scale_log2,
                         "legal": legal, "scratch": sp,
                         "operands": [t.clone() for t in (q, k, v)]})
            if not legal:
                return 716                   # cudaErrorMisalignedAddress
            kh, vh = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
            s = (q @ kh.mT) * scale_log2
            i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
            live = (j <= i) if causal else torch.ones_like(i * j, dtype=bool)
            o.copy_(torch.softmax(torch.where(live, s, -1e30) / LOG2E, -1)
                    @ vh)
            return 0

    scratch = []
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        scratch.append(t)
        return t

    monkeypatch.setattr(ops.LIB, "load", lambda: Lib())
    monkeypatch.setattr(ops.torch, "empty", record_empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    rng = np.random.default_rng(7)

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32))

    def call(q, k, v, dhp):
        scratch.clear()
        o = ops._on_card(q, k, v, True, 0)
        c = seen[-1]
        assert c["legal"] and c["dh"] == dhp
        assert c["scale"] == q.shape[-1] ** -0.5 * LOG2E
        B, KV, Skv = k.shape[0], k.shape[1], k.shape[2]
        sc = [t for t in scratch if t.data_ptr() == c["scratch"]]
        assert len(sc) == 1
        assert sc[0].numel() == ops.fwd_scratch_floats(B, KV, Skv, dhp)
        assert o.shape == q.shape
        torch.testing.assert_close(o, attention_ref(q, k, v), atol=1e-5,
                                   rtol=1e-5)
        return c, o

    before = flash_attention.launches
    # the model's (B, S, H, dh) projections as transposed views, dh = 64
    q, k, v = (draw(2, 40, n, 64).transpose(1, 2) for n in (4, 2, 2))
    with torch.no_grad():
        c, o = call(q, k, v, 64)
    assert c["ptrs"] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert o.stride() == q.stride()
    # dh = 18: padded with zeros to 20, o sliced back
    q, k, v = (draw(1, n, 30, 18) for n in (4, 2, 2))
    c, o = call(q, k, v, 20)
    for got, x in zip(c["operands"], (q, k, v)):
        assert torch.equal(got[..., :18], x) and not got[..., 18:].any()
    assert o.is_contiguous()
    # rows off 16 bytes (a 41-element row stride): contiguous copies
    q, k, v = (draw(1, n, 30, 41)[..., 1:] for n in (4, 2, 2))
    c, _ = call(q, k, v, 40)
    assert c["ptrs"][0] != q.data_ptr()
    assert flash_attention.launches == before + 3
    # the stub refuses what the entry refuses: a q row off 16 bytes
    x = draw(1, 2, 8, 44)
    assert Lib().flash_attention_f32(
        x[..., 1:].data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), 1,
        2, 2, 8, 8, 40, (ctypes.c_longlong * 12)(*([352, 44, 44] * 4)), 1, 0,
        0.2, x.data_ptr(), None, 0) == 716
