"""The port's RWKV6 wkv recurrence against the reference's, on the CPU.

The reference's kernel (``repro.kernels.ssm_scan.wkv``) runs in Pallas
interpret mode, as ``tests/test_kernels.py`` runs it; the port's wrapper
takes its plain version for CPU tensors. Inputs come from numpy with a
seed (bf16: the same draws rounded by both frameworks).

Tolerance: 20x the reference's kernel tolerance (5e-5 f32, 5e-2 bf16)
for y and the final state, the reference's own (``test_wkv_sweep``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import wkv as jwkv
from repro.kernels.ssm_scan import wkv_ref as jwkv_ref
from repro_torch.kernels.ssm_scan import wkv, wkv_ref

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
