"""The port's flash attention against the reference's, on the CPU.

The reference's kernel (``repro.kernels.flash_attention.flash_attention``)
runs in Pallas interpret mode, as ``tests/test_kernels.py`` runs it; the
port's wrapper takes its plain version for CPU tensors. Inputs come from
numpy with a seed; bf16 inputs are the same f32 draws rounded to bf16 by
both frameworks (round to nearest even, so bit-equal).

Tolerance: 10x the reference's kernel tolerance (5e-5 f32, 5e-2 bf16),
the reference's own for this kernel (``test_flash_attention_sweep``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)

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
