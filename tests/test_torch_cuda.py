"""Tests of the port that need the CUDA card: the hand-written
graph-filter kernel (forward and backward) against its plain version,
the wrapper's checks on CUDA tensors, and the served and training paths
through the kernel.

They are marked ``cuda`` and skip without a card. They import no jax, so
they run on a card machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: 5e-5 in f32 and 5e-2 in bf16, the reference's kernel
tolerances, and 5e-4 for the gradients, its VJP tolerance
(``tests/test_kernels.py``); 5e-6 for a meta-step's state through the
kernel against the plain filter (``tests/test_torch_train.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf, unroll
from repro_torch.core.tasks import resolve_task
from repro_torch.data.synthetic import make_meta_dataset, sample_dataset
from repro_torch.engine.core import TrainState, init_state, make_meta_step
from repro_torch.kernels.graph_filter import (MAX_N, graph_filter,
                                              graph_filter_ref,
                                              make_plain_mix)
from repro_torch.serve import BucketSpec, FederationServer

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
SHAPES = [(None, 8, 16, 1), (None, 100, 650, 2), (None, 64, 128, 4),
          (None, 33, 100, 2), (None, 9, 5, 1), (3, 33, 100, 2),
          (2, 128, 300, 3), (4, 17, 1, 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(B, n, d, K, device, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    S = rng.random(lead + (n, n)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    W = rng.standard_normal(lead + (n, d)).astype(np.float32)
    h = (0.5 * rng.standard_normal(K + 1)).astype(np.float32)
    return [torch.tensor(x, device=device) for x in (S, W, h)]


@pytest.mark.parametrize("B,n,d,K", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, B, n, d, K, dtype):
    S, W, h = _inputs(B, n, d, K, cuda)
    W = W.to(dtype)
    before = graph_filter.launches
    y = graph_filter(S, W, h)
    torch.cuda.synchronize()
    assert graph_filter.launches == before + 1
    assert y.dtype == dtype and y.shape == W.shape
    torch.testing.assert_close(y.float(), graph_filter_ref(S, W, h).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_kernel_refuses_what_it_does_not_take(cuda):
    S, W, h = _inputs(None, 16, 32, 2, cuda)
    W.requires_grad_(True)
    # a graph-recording call goes through the kernel both ways
    before = (graph_filter.launches, graph_filter.bwd_launches)
    graph_filter(S, W, h).sum().backward()
    assert (graph_filter.launches, graph_filter.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        graph_filter(S, W, h)             # no graph recorded: launches
    W = W.detach()
    with pytest.raises(ValueError, match="contiguous"):
        graph_filter(S.t(), W, h)
    with pytest.raises(TypeError, match="f32 S and h"):
        graph_filter(S.double(), W, h)
    S2, W2, h2 = _inputs(None, MAX_N + 1, 8, 1, cuda)
    with pytest.raises(ValueError, match="n <= 128"):
        graph_filter(S2, W2, h2)


def test_served_path_runs_through_the_kernel(cuda):
    """Each tick launches the kernel once per layer, and every request
    matches the single-cohort solve through the plain filter."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    theta = unroll.init_udgd(gen, SMOKE)
    srv = FederationServer(SMOKE, theta, mix="cuda", max_batch=4,
                           buckets=BucketSpec((8, 16), (4, 8)))
    reqs = []
    before = graph_filter.launches
    for i, n in enumerate([6, 8, 12, 16, 10]):
        cfg_r = dataclasses.replace(SMOKE, n_agents=n)
        _, S = surf.make_problem(cfg_r, seed=i)
        ds = sample_dataset(cfg_r, seed=100 + i)
        reqs.append((cfg_r, S, ds, srv.submit(S, ds, seed=i)))
    srv.drain()
    assert graph_filter.launches - before == srv.metrics.ticks * SMOKE.n_layers
    for i, (cfg_r, S, ds, fut) in enumerate(reqs):
        ref = surf.solve_federation(cfg_r, TrainState(theta), S, ds, seed=i,
                                    mix_fn=make_plain_mix())
        np.testing.assert_allclose(fut.result()["loss_per_layer"],
                                   ref["loss_per_layer"], atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("B,n,d,K", SHAPES)
def test_backward_kernel_matches_plain_version(cuda, B, n, d, K):
    """dW (the transposed-S launch) and dh through the Function against
    autograd through the plain version, at 5e-4."""
    S, W, h = _inputs(B, n, d, K, cuda)
    G = torch.randn(W.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    Wk, hk = W.clone().requires_grad_(True), h.clone().requires_grad_(True)
    before = graph_filter.bwd_launches
    dW, dh = torch.autograd.grad(graph_filter(S, Wk, hk), (Wk, hk), G)
    torch.cuda.synchronize()
    assert graph_filter.bwd_launches == before + 1
    Wp, hp = W.clone().requires_grad_(True), h.clone().requires_grad_(True)
    dWp, dhp = torch.autograd.grad(graph_filter_ref(S, Wp, hp), (Wp, hp), G)
    torch.testing.assert_close(dW, dWp, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(dh, dhp, atol=5e-4, rtol=5e-4)


def test_default_mixer_launches_the_kernel(cuda):
    """``mix_fn=None`` (every entry point's default) runs the kernel on
    CUDA tensors: L launches per solve, and a default server ticks × L."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    theta = unroll.init_udgd(gen, SMOKE)
    _, S = surf.make_problem(SMOKE, seed=0)
    ds = sample_dataset(SMOKE, seed=3)
    before = graph_filter.launches
    surf.solve_federation(SMOKE, TrainState(theta), S, ds)
    assert graph_filter.launches - before == SMOKE.n_layers
    srv = FederationServer(SMOKE, theta, max_batch=2,
                           buckets=BucketSpec((8,), (4,)))
    before = graph_filter.launches
    srv.submit(S, ds)
    srv.drain()
    assert graph_filter.launches - before == (srv.metrics.ticks
                                              * SMOKE.n_layers)


def test_meta_step_through_kernel_matches_plain(cuda):
    """One meta-step through the kernel (default mixer) makes L forward
    and L−1 backward launches and lands within 5e-6 of the same step
    through the plain filter, on the same draws."""
    _, S = surf.make_problem(SMOKE, seed=0)
    batch = resolve_task(SMOKE).to_batch(make_meta_dataset(SMOKE, 1)[0],
                                         cuda)
    state = init_state(torch.Generator(cuda).manual_seed(0), SMOKE)
    draws = unroll.featurize_cohort(unroll.step_generator(0, 0, cuda),
                                    batch, SMOKE)
    kern, _ = make_meta_step(SMOKE, S)
    plain, _ = make_meta_step(SMOKE, S, mix_fn=make_plain_mix())
    before = (graph_filter.launches, graph_filter.bwd_launches)
    sk, mk = kern(state, batch, draws=draws)
    torch.cuda.synchronize()
    assert (graph_filter.launches - before[0],
            graph_filter.bwd_launches - before[1]) == (SMOKE.n_layers,
                                                       SMOKE.n_layers - 1)
    sp, mp = plain(state, batch, draws=draws)
    for k in sk.theta:
        torch.testing.assert_close(sk.theta[k], sp.theta[k], atol=5e-6,
                                   rtol=5e-6)
    torch.testing.assert_close(sk.lam, sp.lam, atol=5e-6, rtol=5e-6)
    for k in mk:
        torch.testing.assert_close(mk[k], mp[k], atol=5e-6, rtol=5e-6)
