"""The bf16 flash-attention backward on the CPU: a plain-torch emulation
of the kernel's wgmma design (query tiles of 64, key tiles of 128 in
warpgroups of 64, chained f32 sums, P and dS rounded to bf16 as operands,
dq's product on the centred keys) within ``ops.bf16_grad_error_bound`` of
the plain version and within the reference's bf16 tolerance of
``jax.vjp`` of its plain attention; faulty variants (a dropped tile, raw
keys in dq) leave the bound. Inputs come from numpy with a seed, rounded
to bf16 by both frameworks (bit-equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import attention_ref, ops
from test_torch_flash_attention import (LOG2E, TOL, _bf16_forward_emulation,
                                        _np)
from test_torch_flash_bwd_f32 import _grad_inputs, _reference_grads

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


# The bf16 backward kernel's tiles (the wgmma design): dk/dv blocks of 128
# keys, 64 per consumer warpgroup, over query tiles of 64 rows; dq blocks
# of 128 query rows, 64 per warpgroup, over key tiles of 64.
BF_KEYS, BF_QT, BF_QROWS, BF_KT = 128, 64, 128, 64


def _bf16_backward_emulation(q, k, v, do, centred, causal=False, window=0,
                             skip_first=False, round_ds=True, fwd=None):
    """The bf16 backward kernel's algorithm and arithmetic in plain torch
    (``scripts/flash_delta_probe.py --dtype bf16`` runs its non-causal sums
    beside the kernel): the forward's o with P rounded to bf16 before P·V,
    its lse from the raw keys, delta = do·o. The dk/dv kernel per block of
    128 keys (two warpgroups of 64), over the G query heads of its kv head
    and the query tiles of 64 rows that can see the block (its range
    arithmetic): Sᵀ = K Qᵀ and dPᵀ = V dOᵀ in f32 from the bf16 inputs, P
    from the lse, Pᵀ and dSᵀ rounded to bf16 as the operands of dv += Pᵀ dO
    and dk += dSᵀ Q, each tile's product added to the running f32 sums in
    order (the chained accumulators). The dq kernel per block of 128 query
    rows over the key tiles of 64 it sees, dq += bf16(dS) KC. Each gradient
    rounded to bf16 once. With ``centred`` KC = bf16(k − k̄) and dk less its
    mean over the keys, as the kernel does; else the raw keys and dk as
    summed. ``skip_first`` drops each key block's first query tile (a
    faulty range); ``round_ds=False`` feeds dq's product an f32 dS.
    ``fwd``: the forward's (o, lse) to read instead (the forward kernel's,
    as the model's backward does)."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    sl2, scale = dh ** -0.5 * LOG2E, dh ** -0.5
    bf = lambda t: t.to(torch.bfloat16).float()
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (kf, vf))
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        live &= kj <= qi
    if window:
        live &= kj > qi - window
    s2 = (qf @ kh.mT) * sl2
    lse = torch.logsumexp(torch.where(live, s2, -1e30) / LOG2E, -1) * LOG2E
    p = torch.where(live, torch.exp2(s2 - lse[..., None]), 0.0)
    o = bf(bf(p) @ vh)
    if fwd is not None:
        o, lse = fwd[0].float(), fwd[1]
    delta = (dof * o).sum(-1)
    kc = bf(kf - kf.mean(2, keepdim=True)) if centred else kf
    kch = kc.repeat_interleave(G, dim=1)

    def probs(s, dp, heads, rows, cols):
        """P and dS of a tile (queries as rows) from its scores and dP."""
        m = live[rows, cols]
        pt = torch.where(m, torch.exp2(s * sl2 - lse[:, heads, rows, None]),
                         0.0)
        return pt, pt * (dp - delta[:, heads, rows, None])

    dq = torch.zeros_like(qf)
    for q_lo in range(0, Sq, BF_QROWS):
        q_hi = min(q_lo + BF_QROWS, Sq) - 1
        n_kv = -(-Skv // BF_KT)
        j_end = min(n_kv, q_hi // BF_KT + 1) if causal else n_kv
        j_begin = max(0, q_lo - window + 1) // BF_KT if window else 0
        for wg in range(2):
            rows = slice(q_lo + 64 * wg, min(q_lo + 64 * wg + 64, Sq))
            for jt in range(j_begin, j_end):
                cols = slice(jt * BF_KT, min(jt * BF_KT + BF_KT, Skv))
                s = qf[:, :, rows] @ kh[:, :, cols].mT
                dp = dof[:, :, rows] @ vh[:, :, cols].mT
                _, ds = probs(s, dp, slice(None), rows, cols)
                a = bf(ds) if round_ds else ds
                dq[:, :, rows] += a @ kch[:, :, cols]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    n_q = -(-Sq // BF_QT)
    for k_lo in range(0, Skv, BF_KEYS):
        k_hi = min(k_lo + BF_KEYS, Skv) - 1
        i_begin = min(k_lo // BF_QT, n_q) if causal else 0
        i_end = (min(n_q, (k_hi + window - 1) // BF_QT + 1) if window
                 else n_q)
        for wg in range(2):
            cols = slice(k_lo + 64 * wg, min(k_lo + 64 * wg + 64, Skv))
            for g in range(G):
                heads = slice(g, H, G)     # the heads kv head h // G reads
                for it in range(i_begin + skip_first, i_end):
                    rows = slice(it * BF_QT, min(it * BF_QT + BF_QT, Sq))
                    qt, dot = qf[:, heads, rows], dof[:, heads, rows]
                    st = kf[:, :, cols] @ qt.mT    # Sᵀ: keys x queries
                    dpt = vf[:, :, cols] @ dot.mT
                    pt, dst = probs(st.mT, dpt.mT, heads, rows, cols)
                    dv[:, :, cols] += bf(pt).mT @ dot
                    dk[:, :, cols] += bf(dst).mT @ qt
    dk = dk * scale
    if centred:
        dk = dk - dk.mean(2, keepdim=True)
    return [t.to(torch.bfloat16) for t in (dq * scale, dk, dv)]


def _bf16_case(B, H, KV, Sq, Skv, dh, seed, shift=0.0):
    """bf16 q, k, v, do from numpy (a vector of ``shift`` times the keys'
    rms row norm added to every key first) and autograd's gradients
    through the plain version on them."""
    _, (q, k, v), do = _grad_inputs(B, H, KV, Sq, Skv, dh, seed=seed)
    u = torch.tensor(np.random.default_rng(seed + 1).standard_normal(dh),
                     dtype=torch.float32)
    k = k + shift * k.square().sum(-1).mean().sqrt() * u / u.norm()
    return [torch.as_tensor(t).to(torch.bfloat16) for t in (q, k, v, do)]


def _bound_use(args, got, causal, window):
    """The largest fraction of ``bf16_grad_error_bound`` each gradient of
    ``got`` uses against autograd through the plain version."""
    q, k, v, do = args
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(attention_ref(*xs, causal=causal,
                                            window=window), xs, do)
    bounds = ops.bf16_grad_error_bound(q, k, v, do, ref, causal=causal,
                                       window=window)
    return [((g.float() - r.float()).abs() / b).max().item()
            for g, r, b in zip(got, ref, bounds)]


# causal, windowed (narrower than a tile and wider), non-causal ragged
# with Skv > Sq and Sq > Skv, GQA and MQA; several tiles each way.
BF16_BWD_CASES = [(1, 4, 2, 200, 200, 32, 0, True),
                  (1, 4, 1, 300, 300, 24, 20, True),
                  (1, 2, 2, 150, 150, 16, 70, True),
                  (2, 4, 2, 70, 190, 40, 0, False),
                  (1, 6, 3, 257, 129, 16, 0, False)]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", BF16_BWD_CASES)
def test_bf16_backward_design_within_bound_and_reference(B, H, KV, Sq, Skv,
                                                         dh, win, causal):
    """The wgmma design's order (query tiles of 64, key tiles of 128 in
    warpgroups of 64, chained f32 sums) and roundings within
    ``bf16_grad_error_bound`` of the plain version on the same bf16
    inputs, and within the reference's bf16 tolerance of its ``jax.vjp``
    (each gradient's largest entry)."""
    args = _bf16_case(B, H, KV, Sq, Skv, dh, seed=Sq + Skv + dh)
    got = _bf16_backward_emulation(*args, True, causal=causal, window=win)
    assert max(_bound_use(args, got, causal, win)) <= 1
    jargs = [jnp.asarray(t.float().numpy()) for t in args[:3]]
    ref = _reference_grads(jargs, args[3].float().numpy(), causal, win)
    for name, g, gr in zip("qkv", got, ref):
        np.testing.assert_allclose(_np(g.float()), gr,
                                   atol=TOL["bfloat16"] * np.abs(gr).max(),
                                   rtol=TOL["bfloat16"], err_msg=f"d{name}")


def test_bf16_backward_check_catches_a_dropped_tile():
    args = _bf16_case(1, 4, 2, 200, 200, 32, seed=4)
    got = _bf16_backward_emulation(*args, True, causal=True, window=70,
                                   skip_first=True)
    assert max(_bound_use(args, got, True, 70)) > 1


@pytest.mark.parametrize("round_ds", [True, False])
def test_bf16_backward_check_catches_raw_keys_in_dq(round_ds):
    """At a key shift of 30 rms norms, dq's product on the raw keys leaves
    the bound whether dS is rounded to bf16 before it (the kernel's
    operand: its rows then no longer sum to 0) or not (an f32 dS: delta
    from the forward's bf16 o still differs from P's row sum by far more
    than in f32). Either way dq carries the keys' shared component, which
    the centred keys remove; the design stays inside. (An f32 dS on the
    centred keys is more accurate than the kernel, so no bound can catch
    it: it is checked here on the raw keys.)"""
    args = _bf16_case(1, 4, 2, 130, 140, 16, seed=8, shift=30.0)
    got = _bf16_backward_emulation(*args, False, causal=True,
                                   round_ds=round_ds)
    assert _bound_use(args, got, True, 0)[0] > 1
    got = _bf16_backward_emulation(*args, True, causal=True,
                                   round_ds=round_ds)
    assert max(_bound_use(args, got, True, 0)) <= 1


@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_bf16_backward_arithmetic_within_its_derived_bound(shift):
    """``ops.bf16_grad_error_bound`` holds the bf16 backward kernel's
    arithmetic (emulated) against autograd through the plain version on
    the same bf16 inputs, also with a vector of ``shift`` times the keys'
    rms row norm added to every key (which moves no gradient
    analytically). Without the centred keys dq's product carries that
    vector times dS's bf16 rounding and leaves the bound: the reason the
    kernel centres them."""
    _, (q, k, v), do = _grad_inputs(1, 4, 2, 40, 90, 16, seed=21)
    u = torch.tensor(np.random.default_rng(22).standard_normal(16),
                     dtype=torch.float32)
    k = k + shift * k.square().sum(-1).mean().sqrt() * u / u.norm()
    q, k, v, do = (torch.as_tensor(t).to(torch.bfloat16)
                   for t in (q, k, v, do))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(attention_ref(*xs, causal=False), xs, do)
    bounds = ops.bf16_grad_error_bound(q, k, v, do, ref, causal=False)
    use = lambda got: [((g.float() - r.float()).abs() / b).max().item()
                       for g, r, b in zip(got, ref, bounds)]
    assert max(use(_bf16_backward_emulation(q, k, v, do, True))) <= 1
    if shift:
        assert use(_bf16_backward_emulation(q, k, v, do, False))[0] > 1



@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal",
                         [c for c in BF16_BWD_CASES if c[-1]]
                         + [(2, 4, 2, 70, 190, 40, 0, False)])
def test_bf16_forward_lse_feeds_the_backward_design(B, H, KV, Sq, Skv, dh,
                                                    win, causal):
    """The forward design's o and lse, as written for the backward,
    through the bf16 backward design: every gradient within
    ``bf16_grad_error_bound`` (the backward rebuilds P from this lse
    unshifted and takes delta from this o)."""
    args = _bf16_case(B, H, KV, Sq, Skv, dh, seed=Sq + Skv + dh)
    fwd = _bf16_forward_emulation(*args[:3], causal, win)
    got = _bf16_backward_emulation(*args, True, causal=causal, window=win,
                                   fwd=fwd)
    assert max(_bound_use(args, got, causal, win)) <= 1
