"""The port's graph filter against the reference's Pallas kernel.

On the CPU the port's ``ops.graph_filter`` takes its plain version (the
tensors lie on the CPU); the reference runs its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it. Inputs come from
numpy with a seed. Tolerances are the reference's own
(``tests/test_kernels.py``): 5e-5 in f32 (the two sum in different
orders), 5e-2 in bf16 (one bf16 rounding of the output). The kernel
itself runs only on the card: ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unroll as junroll
from repro.kernels.graph_filter import graph_filter as jgraph_filter
from repro_torch.core import unroll as tunroll
from repro_torch.kernels.graph_filter import (MAX_N, graph_filter,
                                              graph_filter_ref,
                                              make_cuda_mix)

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# tests/test_kernels.py::GF_SHAPES: non-aligned n (not x8) and d (not x128)
GF_SHAPES = [(8, 16, 1), (100, 650, 2), (64, 128, 4), (33, 100, 2),
             (9, 5, 1)]


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


@pytest.mark.parametrize("n,d,K", GF_SHAPES)
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
    """CPU tensors that require grad go through the plain version, which
    autograd differentiates (the kernel's backward comes with training)."""
    S, W, h = _inputs(8, 16, 1, torch.float32)
    W.requires_grad_(True)
    graph_filter(S, W, h).sum().backward()
    assert W.grad is not None and W.grad.shape == W.shape


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
    mix = make_cuda_mix()
    assert mix.takes_S and mix.tag == ("cuda",)
    S, W, h = _inputs(9, 5, 1, torch.float32)
    torch.testing.assert_close(tunroll._mix(mix, S, W, h),
                               tunroll._mix(None, S, W, h))
    assert MAX_N >= 128       # the top of the default serve bucket ladder
