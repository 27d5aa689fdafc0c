"""The port's graph filter against the reference's Pallas kernel.

On the CPU the port's ``ops.graph_filter`` takes its plain version (the
tensors lie on the CPU); the reference runs its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it. Inputs come from
numpy with a seed. Tolerances are the reference's own
(``tests/test_kernels.py``): 5e-5 in f32 (the two sum in different
orders), 5e-2 in bf16 (one bf16 rounding of the output), and 5e-4 for
the gradients (dS, dW, dh), the reference's VJP tolerance. The port's
``autograd.Function`` runs the same backward formulas on both devices;
here its dW takes the plain filter on Sᵀ, on the card the kernel. The
kernel itself runs only on the card: ``tests/test_torch_cuda.py``; its
arithmetic (split TF32 on the tensor cores) is emulated here in plain
torch and held against the reference's kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unroll as junroll
from repro.kernels.graph_filter import graph_filter as jgraph_filter
from repro_torch.core import unroll as tunroll
from repro_torch.kernels.graph_filter import (RESIDENT_N, bf16_error_bound,
                                              graph_filter, graph_filter_ref,
                                              make_plain_mix, ops)
from repro_torch.serve import BucketSpec

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# tests/test_kernels.py::GF_SHAPES: non-aligned n (not x8) and d (not x128)
GF_SHAPES = [(8, 16, 1), (100, 650, 2), (64, 128, 4), (33, 100, 2),
             (9, 5, 1)]
# Agent counts past the kernel's resident limit (128): n = 256 is DRYRUN's
LARGE_N_SHAPES = [(129, 300, 2), (256, 130, 2)]


def _inputs(n, d, K, dtype, B=None, seed=0):
    """S, W, h as torch tensors of ``dtype`` (values exactly representable,
    so the reference sees the same numbers)."""
    rng = np.random.default_rng(seed + n + d + K)
    lead = () if B is None else (B,)
    S = rng.random(lead + (n, n)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    W = rng.standard_normal(lead + (n, d)).astype(np.float32)
    h = (0.5 * rng.standard_normal(K + 1)).astype(np.float32)
    return [torch.from_numpy(x).to(dtype) for x in (S, W, h)]


def _jax(t, dtype):
    return jnp.asarray(t.float().numpy()).astype(JNP[dtype])


def _close(a, b, dtype):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("n,d,K", GF_SHAPES + LARGE_N_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_filter_matches_pallas(n, d, K, dtype):
    S, W, h = _inputs(n, d, K, dtype)
    y = graph_filter(S, W, h)
    assert y.dtype == dtype and y.shape == W.shape
    yj = jgraph_filter(_jax(S, dtype), _jax(W, dtype), _jax(h, dtype),
                       impl="pallas")
    _close(y.float().numpy(), yj, dtype)
    # the dense Horner filter of core.unroll agrees with both
    _close(tunroll.graph_filter(S.float(), W.float(), h.float()).numpy(),
           junroll.graph_filter(_jax(S, dtype).astype(jnp.float32),
                                _jax(W, dtype).astype(jnp.float32),
                                _jax(h, dtype).astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_graph_filter_matches_per_item_pallas(dtype):
    """The port's batched call (B, n, n) x (B, n, d), one shared h, equals
    the reference's unbatched kernel on each item (the serve vmap)."""
    S, W, h = _inputs(33, 100, 2, dtype, B=3)
    y = graph_filter(S, W, h)
    assert y.shape == W.shape
    for b in range(3):
        yj = jgraph_filter(_jax(S[b], dtype), _jax(W[b], dtype),
                           _jax(h, dtype), impl="pallas")
        _close(y[b].float().numpy(), yj, dtype)


def test_cpu_takes_plain_version_without_launching():
    S, W, h = _inputs(64, 128, 4, torch.float32)
    before = graph_filter.launches
    y = graph_filter(S, W, h)
    assert graph_filter.launches == before
    torch.testing.assert_close(y, graph_filter_ref(S, W, h), rtol=0, atol=0)


def test_cpu_path_is_differentiable():
    """CPU tensors that require grad go through the port's
    ``autograd.Function``; its gradient equals autograd through the plain
    version."""
    S, W, h = _inputs(8, 16, 1, torch.float32)
    W.requires_grad_(True)
    graph_filter(S, W, h).sum().backward()
    assert W.grad is not None and W.grad.shape == W.shape
    Wr = W.detach().clone().requires_grad_(True)
    graph_filter_ref(S, Wr, h).sum().backward()
    torch.testing.assert_close(W.grad, Wr.grad, atol=5e-6, rtol=5e-6)


# tests/test_kernels.py::test_graph_filter_vjp_parity shapes
VJP_SHAPES = [(8, 16, 1), (33, 100, 2), (64, 128, 4)]


@pytest.mark.parametrize("n,d,K", VJP_SHAPES + LARGE_N_SHAPES)
def test_backward_matches_reference_vjp(n, d, K):
    """(dS, dW, dh) of the port's Function against ``jax.vjp`` of the
    reference's custom-VJP filter (Pallas in interpret mode), at 5e-4."""
    S, W, h = _inputs(n, d, K, torch.float32)
    G = torch.from_numpy(np.random.default_rng(n * d + K).standard_normal(
        (n, d)).astype(np.float32))
    _, vjp = jax.vjp(lambda S, W, h: jgraph_filter(S, W, h, impl="pallas",
                                                   interpret=True),
                     *(jnp.asarray(t.numpy()) for t in (S, W, h)))
    want = vjp(jnp.asarray(G.numpy()))
    St, Wt, ht = (t.clone().requires_grad_(True) for t in (S, W, h))
    got = torch.autograd.grad(graph_filter(St, Wt, ht), (St, Wt, ht), G)
    for name, a, b in zip(("dS", "dW", "dh"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4, err_msg=name)


def test_batched_backward_matches_per_item_reference():
    """With a batch axis, dS and dW are per item and dh sums the items
    (h is shared)."""
    S, W, h = _inputs(33, 100, 2, torch.float32, B=3)
    G = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 33, 100)).astype(np.float32))
    St, Wt, ht = (t.clone().requires_grad_(True) for t in (S, W, h))
    dS, dW, dh = torch.autograd.grad(graph_filter(St, Wt, ht), (St, Wt, ht),
                                     G)
    dh_want = 0
    for b in range(3):
        _, vjp = jax.vjp(lambda S, W, h: jgraph_filter(
            S, W, h, impl="pallas", interpret=True),
            *(jnp.asarray(t.numpy()) for t in (S[b], W[b], h)))
        wS, wW, wh = vjp(jnp.asarray(G[b].numpy()))
        np.testing.assert_allclose(dS[b].numpy(), wS, atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(dW[b].numpy(), wW, atol=5e-4, rtol=5e-4)
        dh_want = dh_want + np.asarray(wh)
    np.testing.assert_allclose(dh.numpy(), dh_want, atol=5e-4, rtol=5e-4)


def test_backward_computes_only_the_gradients_asked_for(monkeypatch):
    """dS is computed only when S needs a gradient (SURF's graphs are
    fixed), dW only when W does."""
    def never(*args):
        raise AssertionError("computed a gradient nobody asked for")

    S, W, h = _inputs(33, 100, 2, torch.float32)
    monkeypatch.setattr(ops, "_grad_S", never)
    Wt, ht = W.clone().requires_grad_(True), h.clone().requires_grad_(True)
    dW, dh = torch.autograd.grad(graph_filter(S, Wt, ht).sum(), (Wt, ht))
    assert dW.shape == W.shape and dh.shape == h.shape
    # the Function is first-order only: the meta-gradient never needs more
    y = graph_filter(S, Wt, h)
    (g,) = torch.autograd.grad(y.square().sum(), Wt, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        g.sum().backward()
    monkeypatch.setattr(ops, "graph_filter_bwd", never)
    (dh2,) = torch.autograd.grad(graph_filter(S, W, ht).sum(), (ht,))
    torch.testing.assert_close(dh2, dh)


def test_shape_and_dtype_validation():
    S, W, h = _inputs(8, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="does not match"):
        graph_filter(S[:4, :4], W, h)
    with pytest.raises(ValueError, match="expected S"):
        graph_filter(S, W[None], h)
    with pytest.raises(ValueError, match="h must be"):
        graph_filter(S, W, h[None])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        graph_filter(S, W.double(), h)


def test_cuda_mix_protocol():
    """Every dense mix name ("cuda" among them) selects the default
    mixer, ``graph_filter``; the server refuses the baked-S halo names;
    the plain filter is the one explicit S-as-argument mixer."""
    from repro_torch.serve import resolve_serve_mix
    assert "cuda" in tunroll.DENSE_MIXES
    assert all(resolve_serve_mix(m) is None for m in tunroll.DENSE_MIXES)
    for m in set(tunroll.MIXES) - set(tunroll.DENSE_MIXES):
        with pytest.raises(ValueError, match="baked-S"):
            resolve_serve_mix(m)
    plain = make_plain_mix()
    assert plain.takes_S and plain.tag == ("plain",)
    S, W, h = _inputs(9, 5, 1, torch.float32)
    torch.testing.assert_close(tunroll._mix(None, S, W, h),
                               graph_filter(S, W, h))
    torch.testing.assert_close(tunroll._mix(plain, S, W, h),
                               tunroll._mix(None, S, W, h))
    # the default serve bucket ladder keeps S resident in the kernel; no
    # agent count is refused past it (the CPU path here, the kernel's
    # streamed path on the card)
    assert RESIDENT_N >= max(BucketSpec().agent_sizes)
    S, W, h = _inputs(RESIDENT_N + 1, 5, 2, torch.float32)
    torch.testing.assert_close(tunroll._mix(None, S, W, h),
                               graph_filter_ref(S, W, h))


# The CUDA kernel's arithmetic, emulated in plain torch on the CPU (the
# kernel itself runs only on the card): Horner's rule with every S·Y
# product in split TF32. Each operand x is hi + lo, hi = x rounded to TF32
# (10 mantissa bits, to nearest with ties away from zero, as the kernel's
# integer add and mask), lo = x − hi rounded to TF32 the same way. Up to
# 128 agents (wgmma) one f32
# accumulator takes, for each k-step of 8, lo·hi, then hi·lo, then hi·hi;
# past 128 (mma.sync) the small products have their own accumulator:
# (lo·hi + hi·lo) + hi·hi. W is widened to f32 and Y rounded to W's dtype
# once.
def _tf32_round(x):
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def _split_mm(a, b):
    """a @ b in split TF32 as the kernel sums it (see above)."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_round(a - ah), _tf32_round(b - bh)
    if a.shape[-1] > RESIDENT_N:
        return (al @ bh + ah @ bl) + ah @ bh
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        acc = acc + al[..., ks] @ bh[..., ks, :]
        acc = acc + ah[..., ks] @ bl[..., ks, :]
        acc = acc + ah[..., ks] @ bh[..., ks, :]
    return acc


def _one_pass_mm(a, b):
    """a @ b in one TF32 pass (the control)."""
    return _tf32_round(a) @ _tf32_round(b)


def _kernel_emulation(S, W, h, mm=_split_mm, drop=None):
    """Σ_k h_k S^k W as the kernel computes it. ``drop=(k, a)``: the hop
    for h_k loses the k-tile of agents a .. a+7 (a faulty kernel)."""
    K = h.shape[0] - 1
    Wf = W.float()
    Y = h[K] * Wf
    for k in range(K - 1, -1, -1):
        Sk = S
        if drop is not None and drop[0] == k:
            Sk = S.clone()
            Sk[..., drop[1]:drop[1] + 8] = 0
        Y = mm(Sk, Y) + h[k] * Wf
    return Y.to(W.dtype)


@pytest.mark.parametrize("n,d,K", GF_SHAPES + [(256, 130, 2)])
def test_kernel_arithmetic_matches_pallas(n, d, K):
    """The kernel's split-TF32 Horner against the reference's Pallas
    kernel at the reference's f32 tolerance, 5e-5."""
    S, W, h = _inputs(n, d, K, torch.float32)
    yj = jgraph_filter(_jax(S, torch.float32), _jax(W, torch.float32),
                       _jax(h, torch.float32), impl="pallas")
    _close(_kernel_emulation(S, W, h).numpy(), yj, torch.float32)


@pytest.mark.parametrize("n,d,K", [(100, 650, 2), (64, 128, 4),
                                   (33, 100, 2)])
def test_one_pass_tf32_fails_the_f32_tolerance(n, d, K):
    """Control: the same Horner with one TF32 pass per product (about
    2⁻¹¹ per operand) misses 5e-5 against the reference's kernel at the
    reference's VJP shapes, so the split is what holds f32 accuracy. (At
    (8, 16, 1), one hop over 8 agents, and at (256, 130, 2) its error
    happens to stay under 5e-5; the control is held where it can bite.)"""
    S, W, h = _inputs(n, d, K, torch.float32)
    yj = jgraph_filter(_jax(S, torch.float32), _jax(W, torch.float32),
                       _jax(h, torch.float32), impl="pallas")
    with pytest.raises(AssertionError):
        _close(_kernel_emulation(S, W, h, mm=_one_pass_mm).numpy(), yj,
               torch.float32)


@pytest.mark.parametrize("n,d,K", GF_SHAPES + LARGE_N_SHAPES
                         + [(100, 5130, 2)])
def test_bf16_error_bound_holds_for_the_kernel_arithmetic(n, d, K):
    """``ops.bf16_error_bound``, the card's per-element bf16 gate, holds
    for the kernel's arithmetic on bf16 W against the plain version."""
    S, W, h = _inputs(n, d, K, torch.bfloat16)
    S, h = S.float(), h.float()
    y_ref = graph_filter_ref(S, W, h)
    err = (_kernel_emulation(S, W, h).float() - y_ref.float()).abs()
    assert (err <= bf16_error_bound(y_ref)).all()


@pytest.mark.parametrize("d", [650, 5130])
def test_bf16_error_bound_rejects_a_dropped_k_tile(d):
    """A kernel that loses one k-tile of 8 agents in the last hop is far
    outside ``bf16_error_bound``, yet inside the reference's bf16
    tolerance, 5e-2, at n = 100 (PAPER's cohort, up to PAPER's width)."""
    S, W, h = _inputs(100, d, 2, torch.bfloat16)
    S, h = S.float(), h.float()
    y_ref = graph_filter_ref(S, W, h)
    y_bad = _kernel_emulation(S, W, h, drop=(0, 0)).float()
    assert not (((y_bad - y_ref.float()).abs()
                 <= bf16_error_bound(y_ref)).all())
    _close(y_bad.numpy(), y_ref.float().numpy(), torch.bfloat16)
