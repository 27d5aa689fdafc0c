"""The f32 flash-attention backward on the CPU: the plain version's
gradient and a plain-torch emulation of the kernel's design, against
``jax.vjp`` of the reference's plain attention.

The reference has no Pallas backward (its LM differentiates plain
attention), so the port's gradient (autograd through ``attention_ref`` on
the CPU; the backward kernel on the card) is held against ``jax.vjp`` of
``repro.kernels.flash_attention.attention_ref``. The kernel itself runs
only on the card (``tests/test_torch_cuda.py``); here its arithmetic is
emulated tile by tile (``_bwd_emulation``): split TF32 with hi and lo
rounded, the wgmma chains' truncating adds, fresh accumulators per tile,
the centred keys and the shifted log-sum-exp. Inputs come from numpy with
a seed. Faulty variants (a dropped tile, one-pass TF32, raw keys in dq at
a shifted-key input) must miss the same checks."""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention, ops)
from test_torch_flash_attention import LOG2E, SWEEP, _inputs, _np, \
    _tf32_round

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

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


# The backward kernel's tiles (the split-TF32 wgmma design): dk/dv blocks
# of KEYS keys over query tiles of 64 rows, dq blocks of 64 query rows
# over key tiles of KEYS; each product advances 8 along its sum per wgmma.
QROWS, KSTEP = 64, 8


def _tiles(dh):
    """KEYS and how many parts dq's sum is cut into, for the kernel
    instance that takes dh: at dh <= 64 tiles of 64 keys, and the two
    consumers each sum half of dq's k-steps (added once at the end); at
    dh <= 128 tiles of 32 keys, each consumer half of the dh rows (every
    sum whole). dk and dv are summed whole by one consumer each."""
    return (64, 2) if dh <= 64 else (32, 1)


def _halves(lo, hi, n, width):
    """The slices of [lo, hi) that the n parts of a tile of ``width`` take
    (the second may be empty on a ragged edge)."""
    if n == 1:
        return [slice(lo, hi)]
    mid = min(lo + width // 2, hi)
    return [slice(lo, mid), slice(mid, hi)]


def _trunc(x):
    """f64 values to f32, rounded toward zero: an add into a tensor-core
    accumulator truncates."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _product(a, b, one_pass=False):
    """a @ b (f32, over the last axis of a) as the kernel's wgmma chain: per
    k-step of 8 the split-TF32 products lo·hi, hi·lo, hi·hi (each exact,
    the 8 terms summed exactly; ``one_pass``: hi·hi alone, a faulty
    kernel), each added to a fresh f32 accumulator with truncation."""
    (ah, al), (bh, bl) = _split_rounded(a), _split_rounded(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], KSTEP):
        s = slice(k0, k0 + KSTEP)
        pairs = [(ah, bh)] if one_pass else [(al, bh), (ah, bl), (ah, bh)]
        for x, y in pairs:
            acc = _trunc(acc.double() + x[..., s].double()
                         @ y[..., s, :].double())
    return acc


def _bwd_emulation(q, k, v, do, causal, window, skip_first=False,
                   one_pass=False, centred=True, project=True,
                   dq_keys=None):
    """The backward kernel's algorithm and arithmetic in plain torch on the
    CPU. Every product reads the keys centred on their mean over the kv
    head, and P is rebuilt from the forward's row log-sum-exp (log2
    units) shifted by q · k̄; delta = rowsum(do ∘ o). Each product is the
    kernel's wgmma chain (``_product``: split TF32 with hi and lo rounded,
    truncating adds); the scores S = Q Kcᵀ and dP = dO Vᵀ chain over dh,
    so their entries do not depend on the tiling. The dk/dv kernel per
    block of KEYS keys, over the G query heads of its kv head and the query
    tiles of 64 rows that can see the block (its range arithmetic):
    dvᵀ = dOᵀ P and dkᵀ = Qᵀ dS over the tile's rows in fresh
    accumulators, each tile's part added to the running f32 sums in
    order (dS there from P's split, hi + lo). The dq kernel per query tile
    of 64 rows over the key tiles it sees: dqᵀ = Kcᵀ dSᵀ likewise. KEYS
    and the consumers' parts of dq follow dh (``_tiles``). Last, dk's mean over the keys is
    taken out. ``centred=False``: the keys as given; ``project=False``:
    dk as summed; both False: the kernel before either; ``dq_keys="raw"``:
    dq's product alone on the raw keys (a faulty kernel). ``one_pass``:
    one-pass TF32 (a faulty kernel); ``skip_first`` drops each key
    block's first query tile (a faulty range)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    KEYS, parts = _tiles(dh)
    G = H // KV
    sl2 = dh ** -0.5 * LOG2E
    mm = lambda a, b: _product(a, b, one_pass)
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        live &= kj <= qi
    if window:
        live &= kj > qi - window
    s2 = (q @ k.repeat_interleave(G, dim=1).mT) * sl2
    lse = torch.logsumexp(torch.where(live, s2, -1e30) / LOG2E, -1) * LOG2E
    o = attention_ref(q, k, v, causal=causal, window=window)
    delta = (do * o).sum(-1)
    k_raw = k
    if centred:                  # the forward's o and lse, centred keys
        kbar = k.mean(2, keepdim=True)
        lse = lse - sl2 * (q * kbar.repeat_interleave(G, dim=1)).sum(-1)
        k = k - kbar
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = mm(q, kh.mT)
    dp = mm(do, vh.mT)
    p = torch.where(live, torch.exp2(s * sl2 - lse[..., None]), 0.0)
    ds = p * (dp - delta[..., None])
    kq = (k_raw if dq_keys == "raw" else k).repeat_interleave(G, dim=1)

    # dq's running sums (one per consumer at dh <= 64); dk's products read
    # P as its split, hi + lo (the dk/dv kernel's consumer 1 gets P so)
    dqs = [torch.zeros_like(q) for _ in range(parts)]
    ph, pl = _split_rounded(p)
    ds_kv = (ph + pl) * (dp - delta[..., None])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q_lo in range(0, Sq, QROWS):
        q_hi = min(q_lo + QROWS, Sq) - 1
        rows = slice(q_lo, q_hi + 1)
        n_kv = -(-Skv // KEYS)
        j_end = min(n_kv, q_hi // KEYS + 1) if causal else n_kv
        j_begin = max(0, q_lo - window + 1) // KEYS if window else 0
        for jt in range(j_begin, j_end):
            for dq_c, cols in zip(dqs, _halves(
                    jt * KEYS, min(jt * KEYS + KEYS, Skv), parts, KEYS)):
                dq_c[:, :, rows] += mm(kq[:, :, cols].mT,
                                       ds[:, :, rows, cols].mT).mT
    n_q = -(-Sq // QROWS)
    for k_lo in range(0, Skv, KEYS):
        k_hi = min(k_lo + KEYS, Skv) - 1
        cols = slice(k_lo, k_hi + 1)
        i_begin = min(k_lo // QROWS, n_q) if causal else 0
        i_end = (min(n_q, (k_hi + window - 1) // QROWS + 1) if window
                 else n_q)
        for g in range(G):
            heads = slice(g, H, G)     # the heads kv head h // G reads
            for it in range(i_begin + skip_first, i_end):
                rows = slice(it * QROWS, min(it * QROWS + QROWS, Sq))
                pt = p[:, heads, rows, cols]
                dst = ds_kv[:, heads, rows, cols]
                dv[:, :, cols] += mm(do[:, heads, rows].mT, pt).mT
                dk[:, :, cols] += mm(q[:, heads, rows].mT, dst).mT
    dq = sum(dqs[1:], dqs[0])
    scale = dh ** -0.5
    dk = dk * scale
    if project:
        dk = dk - dk.mean(2, keepdim=True)
    return dq * scale, dk, dv


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


# Σ_j dk_j (a key bias's gradient) is 0 analytically; f32 leaves noise.
# The reference reads 9.0e-7 of the largest |dk| on the test's inputs.
KEY_BIAS_TOL = 4e-6


@pytest.mark.parametrize("fixed", [False, True])
def test_backward_algorithm_ignores_a_common_key_component(fixed):
    """A vector c added to every key moves no gradient analytically
    (softmax ignores a shift of a score row). The kernel takes delta =
    rowsum(dO ∘ O) from the forward's O and P from its own split-TF32
    scores; their rounding gap ε_i adds −ε_i Σ_j P_ij k_j to dq (a multiple
    of c) and makes Σ_j dk_j = Σ_i q_i Σ_j dS_ij nonzero, which a weight
    gradient multiplies by its inputs' common component. At ‖c‖ = 30 rms
    key norms (whisper's cross-attention keys, all projected from one
    encoder output, share a large component) the kernel before the fix
    (dS K; dk as summed) misses the gate on dq and leaves Σ_j dk_j at
    1.6e-5 of the largest |dk|; the kernel's dS (K − k̄) and dk less its
    mean over the keys hold both (``scripts/flash_delta_probe.py`` reads
    both on the card)."""
    jargs, args, do = _grad_inputs(1, 2, 2, 64, 150, 64, seed=3)
    q, k, v = args
    u = np.random.default_rng(0).standard_normal(64)
    c = 30 * k.square().sum(-1).mean().sqrt() * torch.tensor(
        u / np.linalg.norm(u), dtype=torch.float32)
    ref = _reference_grads(jargs, do, False, 0)
    got = _bwd_emulation(q, k + c, v, torch.tensor(do), False, 0,
                         centred=fixed, project=fixed)
    for name, g, gr in zip(("dk", "dv"), got[1:], ref[1:]):
        np.testing.assert_allclose(_np(g), gr, rtol=GRAD_TOL, err_msg=name,
                                   atol=GRAD_TOL * np.abs(gr).max())
    bias = (got[1].sum(2).abs().max() / got[1].abs().max()).item()
    ref_bias = np.abs(ref[1].sum(2)).max() / np.abs(ref[1]).max()
    assert ref_bias < KEY_BIAS_TOL
    if fixed:
        _close_grads(got, ref)
        assert bias < KEY_BIAS_TOL
    else:
        with pytest.raises(AssertionError, match="dq"):
            _close_grads(got, ref)
        assert bias > KEY_BIAS_TOL


def test_cuda_style_call_keeps_the_gradient(monkeypatch):
    """A CUDA call's output comes from a ctypes launch and carries no
    ``grad_fn``. Under grad, the card path now goes through
    ``FlashAttention``, whose backward launches the backward kernel: with
    both launches stubbed by plain computations on CPU tensors (outputs
    detached, as a launch's are), q, k and v get the reference's gradients
    and the counters count one launch each way. Without grad it is one
    forward launch. bf16 inputs that require a gradient take the same
    route (the backward kernel's bf16 entry); mixed dtypes raise."""
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
    seen = []

    def record(*a):
        seen.append(a)
        return tuple(torch.zeros_like(t) for t in a[:3])

    monkeypatch.setattr(ops, "_launch_bwd", record)
    xb = [a.detach().bfloat16().requires_grad_() for a in args]
    o = ops._on_card(*xb, True, 0)
    assert o.dtype == torch.bfloat16 and o.grad_fn is not None
    o.float().sum().backward()
    assert len(seen) == 1 and seen[0][0].dtype == torch.bfloat16
    assert all(a.grad.dtype == torch.bfloat16 for a in xb)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention(xb[0], xb[1].float(), xb[2])


# tests/test_kernels.py's gradient tolerance (absolute and relative).
REF_TOL = 5e-4
# GQA causal, a window, non-causal with Sq != Skv both ways; the kernel's
# two instances (dh = 64 and 128); several tiles each way.
DESIGN_CASES = [(1, 4, 2, 200, 200, 64, 0, True),
                (1, 4, 2, 150, 150, 128, 30, True),
                (2, 2, 1, 130, 290, 64, 0, False),
                (1, 2, 2, 260, 140, 128, 0, False)]


def _close_ref(got, ref):
    for name, g, gr in zip("qkv", got, ref):
        np.testing.assert_allclose(_np(g), gr, atol=REF_TOL, rtol=REF_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", DESIGN_CASES)
def test_f32_backward_design_matches_reference_vjp(B, H, KV, Sq, Skv, dh,
                                                   win, causal):
    """The wgmma design's tiles, chains and split-TF32 roundings within
    5e-4 of ``jax.vjp`` of the reference, element by element."""
    jargs, args, do = _grad_inputs(B, H, KV, Sq, Skv, dh, seed=Sq + Skv)
    got = _bwd_emulation(*args, torch.tensor(do), causal, win)
    _close_ref(got, _reference_grads(jargs, do, causal, win))


def _shifted_keys(seed, shift=30.0):
    """Non-causal inputs (Sq 64, Skv 150, dh 64) with a vector of
    ``shift`` times the keys' rms row norm added to every key (it moves
    no gradient analytically), and the reference's gradients."""
    (jq, jk, jv), (q, k, v), do = _grad_inputs(1, 2, 2, 64, 150, 64,
                                               seed=seed)
    u = np.random.default_rng(seed).standard_normal(64)
    c = (shift * np.sqrt(np.square(np.asarray(k)).sum(-1).mean())
         * u / np.linalg.norm(u)).astype(np.float32)
    k = k + torch.tensor(c)
    jargs = (jq, jnp.asarray(k.numpy()), jv)
    return (q, k, v), do, _reference_grads(jargs, do, False, 0)


@pytest.mark.parametrize("fault", ["dropped_tile", "one_pass_tf32",
                                   "raw_keys_in_dq"])
def test_f32_backward_design_faults_miss_the_reference(fault):
    """Each fault, at an input the faithful design holds: a key block's
    first query tile dropped (causal, a window), every product in one-pass
    TF32, and dq's product on the raw keys where every key carries a
    shared vector of 100 rms norms (the f32 gap between delta and P's row
    sums then reaches dq times that vector: 4.2e-3 against the design's
    6.3e-5; at 30 rms norms it is 2.5e-4, under this absolute tolerance
    but not under the card's gate of 1e-4 of the largest entry, which
    ``test_backward_algorithm_ignores_a_common_key_component`` holds)."""
    if fault == "raw_keys_in_dq":
        args, do, ref = _shifted_keys(3, shift=100.0)
        causal, win, kw = False, 0, {"dq_keys": "raw"}
    else:
        jargs, args, do = _grad_inputs(1, 4, 2, 200, 200, 64, seed=4)
        causal, win = True, 70 if fault == "dropped_tile" else 0
        ref = _reference_grads(jargs, do, causal, win)
        kw = ({"skip_first": True} if fault == "dropped_tile"
              else {"one_pass": True})
    do = torch.tensor(do)
    _close_ref(_bwd_emulation(*args, do, causal, win), ref)
    with pytest.raises(AssertionError):
        _close_ref(_bwd_emulation(*args, do, causal, win, **kw), ref)


def _f32_at(ptr, shape, strides):
    """An f32 CPU tensor over the memory at ``ptr`` (what a launch reads
    through the pointer and strides it is given)."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = (ctypes.c_float * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=torch.float32).as_strided(shape,
                                                                 strides)


def test_f32_backward_call_passes_tma_legal_operands(monkeypatch):
    """The f32 backward's wrapper (``ops._launch_bwd``), with the library
    stubbed by a plain computation on CPU tensors that reads its operands
    through the pointers, dh and strides it is given (as the kernel does)
    and refuses what the C entry refuses (dh off a multiple of 4, a q or
    do row off 16 bytes): the model's transposed views at dh = 64 pass
    as they are; dh = 18 passes zero-padded to 20 and rows off 16 bytes
    pass as contiguous copies, the gradients sliced back to the true dh;
    the scales are always those of the true dh. Every call's gradients
    match autograd through the plain version."""
    import contextlib
    import types
    seen = []

    class Lib:
        def flash_attention_bwd_f32(self, qp, kp, vp, op, gp, lp, dqp, dkp,
                                    dvp, sp, B, H, KV, Sq, Skv, dh, strides,
                                    causal, window, scale_log2, scale,
                                    stream):
            st = [[strides[3 * i + j] for j in range(3)] + [1]
                  for i in range(5)]
            shapes = [(B, n, S, dh) for n, S in
                      ((H, Sq), (KV, Skv), (KV, Skv), (H, Sq), (H, Sq))]
            legal = dh % 4 == 0 and all(
                p % 16 == 0 and all(x % 4 == 0 for x in s[:3])
                for i, (p, s) in enumerate(zip((qp, kp, vp, op, gp), st))
                if i in (0, 4))
            seen.append({"ptrs": (qp, kp, vp, gp), "dh": dh, "legal": legal,
                         "scales": (scale_log2, scale)})
            if not legal:
                return 716                   # cudaErrorMisalignedAddress
            q, k, v, o, do = (_f32_at(p, sh, s) for p, sh, s in
                              zip((qp, kp, vp, op, gp), shapes, st))
            xs = [t.clone().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():    # causal attention at `scale`
                kh, vh = (t.repeat_interleave(H // KV, dim=1)
                          for t in xs[1:])
                i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None]
                s = torch.where(j <= i, xs[0] @ kh.mT * scale, -1e30)
                got = torch.autograd.grad(torch.softmax(s, -1) @ vh, xs, do)
            for p, g in zip((dqp, dkp, dvp), got):
                _f32_at(p, g.shape, g.contiguous().stride()).copy_(g)
            return 0

    monkeypatch.setattr(ops.BWD_LIB, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    rng = np.random.default_rng(9)

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32))

    def call(q, k, v, do):
        o = attention_ref(q, k, v, causal=True)
        got = ops._launch_bwd(q, k, v, o, torch.zeros(q.shape[:3]), do,
                              True, 0)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(attention_ref(*xs, causal=True), xs, do)
        for g, r in zip(got, ref):
            assert g.shape == r.shape and g.is_contiguous()
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
        call_ = seen[-1]
        assert call_["legal"]
        assert call_["scales"] == (q.shape[-1] ** -0.5 * LOG2E,
                                   q.shape[-1] ** -0.5)
        return call_

    # the model's (B, S, H, dh) projections as transposed views, dh = 64
    q, k, v, do = (draw(2, 40, n, 64).transpose(1, 2) for n in (4, 2, 2, 4))
    c = call(q, k, v, do)
    assert c["dh"] == 64
    assert c["ptrs"] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr())
    # dh = 18: padded with zeros to 20, the gradients sliced back
    q, k, v, do = (draw(1, n, 30, 18) for n in (4, 2, 2, 4))
    assert call(q, k, v, do)["dh"] == 20
    # rows off 16 bytes (a 41-element row stride): contiguous copies
    q, k, v, do = (draw(1, n, 30, 41)[..., 1:] for n in (4, 2, 2, 4))
    c = call(q, k, v, do)
    assert c["dh"] == 40 and c["ptrs"][0] != q.data_ptr()
    # the stub refuses what the entry refuses
    assert not (Lib().flash_attention_bwd_f32(
        *([q.data_ptr()] * 10), 1, 4, 2, 30, 30, 40,
        (ctypes.c_longlong * 15)(*(list(q.stride()[:3]) * 5)), 1, 0, 0.2,
        0.1, 0) == 0)
