"""The port's RWKV6 wkv recurrence against the reference's, on the CPU.

The reference's kernel (``repro.kernels.ssm_scan.wkv``) runs in Pallas
interpret mode, as ``tests/test_kernels.py`` runs it; the port's wrapper
takes its plain version for CPU tensors. Inputs come from numpy with a
seed (bf16: the same draws rounded by both frameworks).

Tolerance: 20x the reference's kernel tolerance (5e-5 f32, 5e-2 bf16)
for y and the final state, the reference's own (``test_wkv_sweep``);
the emulated CUDA summation order is also held to
``ops.bf16_error_bound``, the card's per-element gate on bf16's y."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import wkv as jwkv
from repro.kernels.ssm_scan import wkv_ref as jwkv_ref
from repro_torch.kernels.ssm_scan import ops, wkv, wkv_ref

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
SWEEP = [(1, 2, 32, 16, 8), (2, 3, 50, 16, 16), (1, 4, 64, 64, 64),
         (2, 1, 17, 8, 8)]


def _inputs(B, H, T, dk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, dk))).astype(np.float32)
    arrs = (r, k, v, w, u)
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,H,T,dk,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_kernel(B, H, T, dk, chunk, dtype):
    jargs, args = _inputs(B, H, T, dk, dtype, seed=T + dk)
    y_ref, S_ref = jwkv(*jargs, chunk=chunk)
    y, S = wkv(*args)
    assert y.dtype == args[0].dtype and S.dtype == torch.float32
    tol = 20 * TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(S), _np(S_ref), atol=tol, rtol=tol)


def test_state_resumes():
    """The final state of the first half, fed to the plain recurrence for
    the second half, gives the state of the whole sequence: serving can
    resume from the prefill's state."""
    jargs, args = _inputs(1, 2, 24, 16, "float32", seed=1)
    *rkvw, u = args
    _, S_half = wkv(*(a[:, :, :12] for a in rkvw), u)
    _, S_half_ref = jwkv(*(a[:, :, :12] for a in jargs[:4]), jargs[4],
                         chunk=4)
    np.testing.assert_allclose(_np(S_half), _np(S_half_ref), atol=1e-5)
    _, S_full = wkv_ref(*(a[:, :, 12:] for a in rkvw), u, S0=S_half)
    _, S_direct = jwkv_ref(*jargs)
    np.testing.assert_allclose(_np(S_full), _np(S_direct), atol=1e-5)


def test_wrapper_checks():
    _, (r, k, v, w, u) = _inputs(1, 2, 5, 8, "float32")
    with pytest.raises(ValueError, match="one shape"):
        wkv(r, k[:, :, :4], v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv(r, k, v, w, u[:, :4])
    with pytest.raises(TypeError, match="one dtype"):
        wkv(r, k, v, w.double(), u)
    with pytest.raises(ValueError, match="unsupported device"):
        wkv(*(a.to("meta") for a in (r, k, v, w, u)))
    before = wkv.launches
    wkv(r, k, v, w, u)                  # the CPU path launches nothing
    assert wkv.launches == before


def _kernel_emulation(r, k, v, w, u):
    """The CUDA kernel's summation order, emulated in f32 on the CPU (the
    kernel runs only on the card): dk padded with zero channels to its
    instance width (16, 32 or 64); each lane of a value column owns 4 key
    rows and takes sum_i r_i S[i][j] + (sum_i r_i u_i k_i) v_j over them;
    the lanes' shares are summed by a butterfly (the halves at distance
    R/2 first, then R/4, ..); S_t = w S_{t-1} + k vᵀ."""
    B, H, T, dk = r.shape
    DK = 16 if dk <= 16 else 32 if dk <= 32 else 64
    R = DK // 4

    def pad(a):
        return torch.nn.functional.pad(a.float(), (0, DK - dk))

    rf, kf, vf, wf, uf = (pad(a) for a in (r, k, v, w, u))
    S = torch.zeros((B, H, DK, DK))
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, :, t] for a in (rf, kf, vf, wf))
        dot = (rt[..., :, None] * S).reshape(B, H, R, 4, DK).sum(3)
        bonus = (rt * uf * kt).reshape(B, H, R, 4).sum(-1)
        part = dot + bonus[..., None] * vt[:, :, None, :]
        while part.shape[2] > 1:
            half = part.shape[2] // 2
            part = part[:, :, :half] + part[:, :, half:]
        ys.append(part[:, :, 0, :dk])
        S = wt[..., :, None] * S + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=2).to(r.dtype), S[..., :dk, :dk]


@pytest.mark.parametrize("B,H,T,dk,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_summation_order_matches_reference_kernel(B, H, T, dk, chunk,
                                                         dtype):
    """The kernel's order of summation (the bonus term per lane, a tree
    over the lanes, zero-padded channels) against the reference's Pallas
    kernel at the reference's tolerance for this kernel (20x)."""
    jargs, args = _inputs(B, H, T, dk, dtype, seed=T + dk)
    y_ref, S_ref = jwkv(*jargs, chunk=chunk)
    y, S = _kernel_emulation(*args)
    tol = 20 * TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(S), _np(S_ref), atol=tol, rtol=tol)


def test_kernel_summation_order_ragged_dk():
    """dk = 50 (padded to 64) and dk = 24 (padded to 32) against the
    reference's oracle at the f32 tolerance."""
    for dk in (50, 24):
        jargs, args = _inputs(2, 2, 21, dk, "float32", seed=dk)
        y, S = _kernel_emulation(*args)
        y_ref, S_ref = jwkv_ref(*jargs)
        np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(S), _np(S_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,T,dk", [(1, 2, 32, 16), (2, 3, 50, 16),
                                      (1, 4, 64, 64), (2, 2, 40, 50)])
def test_bf16_error_bound_holds_for_the_kernel_order(B, H, T, dk):
    """``ops.bf16_error_bound``, the card's per-element gate on bf16's y,
    holds for the kernel's order of summation against the plain version,
    and S stays at the f32 tolerance."""
    _, args = _inputs(B, H, T, dk, "bfloat16", seed=T + dk)
    y_ref, S_ref = wkv_ref(*args)
    y, S = _kernel_emulation(*args)
    err = (y.float() - y_ref.float()).abs()
    assert (err <= ops.bf16_error_bound(y_ref)).all()
    torch.testing.assert_close(S, S_ref, atol=20 * TOL["float32"],
                               rtol=20 * TOL["float32"])


def test_bf16_error_bound_catches_a_lost_bonus_term():
    """y without the bonus term (u k v) breaks ``ops.bf16_error_bound``,
    while the reference's 20x bf16 tolerance (1.0) lets it pass."""
    _, (r, k, v, w, u) = _inputs(2, 2, 40, 64, "bfloat16", seed=1)
    y_ref, _ = wkv_ref(r, k, v, w, u)
    y, _ = _kernel_emulation(r, k, v, w, torch.zeros_like(u))
    err = (y.float() - y_ref.float()).abs()
    assert (err > ops.bf16_error_bound(y_ref)).any()
    tol = 20 * TOL["bfloat16"]
    assert torch.allclose(y.float(), y_ref.float(), atol=tol, rtol=tol)
