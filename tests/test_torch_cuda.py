"""Tests of the port that need the CUDA card: the hand-written
graph-filter kernel (forward and backward), flash-attention kernel and
wkv kernel against their plain versions, the wrappers' checks on CUDA
tensors, the served (fixed and adaptive depth) and training paths
through the graph filter (static and under a topology schedule, whose
S_t may isolate agents; seed-batched, with snapshots; the sparse task
and RSDUN; a resume from a checkpoint), the async study through the
graph filter, the halo-pallas resident block and one halo-pallas
meta-step on simulated shards of the card, one
FL baseline on the card against the CPU, a
reduced-config LLM prefill and decode through the flash and wkv kernels
against the same model run through the plain versions, the flash and wkv
backward kernels against autograd through the plain versions (also at
their tiling's edges, in three layouts, with bit-equal reruns), and a
reduced-config LM train step through the kernels against the plain one.

They are marked ``cuda`` and skip without a card. They import no jax, so
they run on a card machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: 5e-5 in f32 and 5e-2 in bf16, the reference's kernel
tolerances (bf16 graph-filter outputs also within
``graph_filter.ops.bf16_error_bound`` per element), and 5e-4 for the
gradients, its VJP tolerance
(``tests/test_kernels.py``); 10x those for flash attention and 20x for
wkv (y and S), the reference's own for those kernels, and besides them
the kernels' own: flash f32 within 1e-5 (split TF32 keeps f32
accuracy), flash bf16 and wkv bf16's y within each wrapper's
``bf16_error_bound`` per element, and wkv bf16's f32 S at wkv's f32
tolerance; 5e-6 for a
meta-step's state through the kernel against the plain filter
(``tests/test_torch_train.py``); 1e-4 for reduced-config LLM logits
through the kernels against the plain versions
(``tests/test_torch_lm.py``); 1e-4 of each gradient's largest entry for
the backward kernels and the train step's gradients (f32 sums in
another order, ``chip_smoke.py`` phases 5b-6b)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf, unroll
from repro_torch.core.tasks import resolve_task
from repro_torch.data.synthetic import make_meta_dataset, sample_dataset
from repro_torch.engine.core import TrainState, init_state, make_meta_step
from repro_torch.kernels._layout import vector_loads
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.graph_filter import (bf16_error_bound,
                                              graph_filter,
                                              graph_filter_ref,
                                              make_plain_mix)
from repro_torch.kernels.ssm_scan import ops as wkv_ops
from repro_torch.kernels.ssm_scan import wkv, wkv_ref
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import model as M
from repro_torch.serve import BucketSpec, FederationServer

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
# The reference's shapes, batched ones, and agent counts past the resident
# limit (128: S streamed, the iterate in scratch; K = 0, 1 and 3 take no,
# no and two scratch planes).
SHAPES = [(None, 8, 16, 1), (None, 100, 650, 2), (None, 64, 128, 4),
          (None, 33, 100, 2), (None, 9, 5, 1), (3, 33, 100, 2),
          (2, 128, 300, 3), (4, 17, 1, 0), (None, 129, 300, 2),
          (2, 256, 130, 3), (None, 1000, 70, 2), (3, 129, 33, 0),
          (None, 200, 77, 1),
          # SPARSE_SMOKE (d = 16, far below one tile) and the quickstart
          (None, 8, 16, 2), (4, 8, 16, 2), (None, 20, 330, 2)]


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
    y_ref = graph_filter_ref(S, W, h)
    torch.testing.assert_close(y.float(), y_ref.float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == torch.bfloat16:
        err = (y.float() - y_ref.float()).abs()
        assert (err <= bf16_error_bound(y_ref)).all(), (
            f"bf16 outside bf16_error_bound: max |err| {err.max().item()}")


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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        graph_filter(S, W.double(), h)
    # no agent count is refused: past the resident limit the kernel
    # streams S, and still launches once per call
    for n in (129, 256):
        S2, W2, h2 = _inputs(None, n, 40, 2, cuda)
        before = graph_filter.launches
        y = graph_filter(S2, W2, h2)
        torch.cuda.synchronize()
        assert graph_filter.launches == before + 1
        torch.testing.assert_close(y, graph_filter_ref(S2, W2, h2),
                                   atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])


@pytest.mark.parametrize("case", ["f64 S", "f64 h", "strided S",
                                  "strided W", "strided batched W"])
def test_kernel_takes_what_the_plain_version_takes(cuda, case):
    """f64 S or h and non-contiguous S or W: the CPU path and the
    reference take them, so the card does too. One launch each, equal to
    the plain filter on the cast, contiguous inputs."""
    batched = case == "strided batched W"
    S, W, h = _inputs(3 if batched else None, 40, 70, 2, cuda)
    if case == "f64 S":
        S = S.double()
    elif case == "f64 h":
        h = h.double()
    elif case == "strided S":
        S = S.t().contiguous().t()       # S's values, column-major
    else:
        W = torch.cat([W, W], dim=-1)[..., ::2]
    assert S.is_contiguous() != (case == "strided S")
    before = graph_filter.launches
    y = graph_filter(S, W, h)
    torch.cuda.synchronize()
    assert graph_filter.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == W.shape
    y_ref = graph_filter_ref(S.float().contiguous(), W.contiguous(),
                             h.float())
    torch.testing.assert_close(y, y_ref, atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


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


def test_served_federation_past_the_resident_limit(cuda):
    """A 200-agent federation at SMOKE width, served through a bucket
    ladder that reaches 256, launches the kernel (ticks × L) and matches
    the single-cohort solve through the plain filter."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    theta = unroll.init_udgd(gen, SMOKE)
    srv = FederationServer(SMOKE, theta, max_batch=2,
                           buckets=BucketSpec((64, 256), (4, 8)))
    cfg_r = dataclasses.replace(SMOKE, n_agents=200)
    _, S = surf.make_problem(cfg_r, seed=5)
    ds = sample_dataset(cfg_r, seed=105)
    before = graph_filter.launches
    fut = srv.submit(S, ds, seed=5)
    srv.drain()
    assert graph_filter.launches - before == srv.metrics.ticks * SMOKE.n_layers
    ref = surf.solve_federation(cfg_r, TrainState(theta), S, ds, seed=5,
                                mix_fn=make_plain_mix())
    np.testing.assert_allclose(fut.result()["loss_per_layer"],
                               ref["loss_per_layer"], atol=5e-5, rtol=5e-5)


def test_adaptive_tick_launches_once_per_layer_run(cuda):
    """An adaptive tick launches the kernel once per layer it runs, for
    the whole batch: launches == layers_run (< L once every request has
    exited; threshold 10 fires at min_layers = 2 on any ratio), and each
    request matches the adaptive single-cohort solve through the plain
    filter (depth exactly, loss at 5e-5)."""
    cfg = dataclasses.replace(SMOKE, exit_threshold=10.0, min_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    theta = unroll.init_udgd(gen, cfg)
    srv = FederationServer(cfg, theta, max_batch=4, depth="adaptive",
                           buckets=BucketSpec((8, 16), (4, 8)))
    reqs = []
    for i, n in enumerate([6, 8, 12]):
        cfg_r = dataclasses.replace(cfg, n_agents=n)
        _, S = surf.make_problem(cfg_r, seed=i)
        ds = sample_dataset(cfg_r, seed=100 + i)
        reqs.append((cfg_r, S, ds, srv.submit(S, ds, seed=i)))
    before = graph_filter.launches
    assert srv.tick() == 2
    torch.cuda.synchronize()
    assert graph_filter.launches - before == srv.metrics.layers_run == 2
    srv.drain()
    assert graph_filter.launches - before == srv.metrics.layers_run == 4
    for i, (cfg_r, S, ds, fut) in enumerate(reqs):
        ref = surf.solve_federation(cfg_r, TrainState(theta), S, ds, seed=i,
                                    mix_fn=make_plain_mix(), depth="adaptive")
        assert int(fut.result()["depth"]) == int(ref["depth"]) == 2
        np.testing.assert_allclose(fut.result()["final_loss"],
                                   ref["final_loss"], atol=5e-5, rtol=5e-5)


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


@pytest.mark.parametrize("n", [25, 20])
def test_halo_pallas_resident_matches_plain(cuda, n):
    """The halo-pallas resident block ``S0_loc @ Y`` at PAPER's shard
    shapes (n = 100 over 4 and 5 shards, d = 5130): the kernel as its
    1-tap case h = [0, 1] against the plain version, forward at 5e-5 and
    dW at 5e-4, one forward and one dW launch."""
    from repro_torch.topology.halo import _resident_matmul
    S0, Y, _ = _inputs(None, n, 5130, 1, cuda, seed=n)
    G = torch.randn(Y.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    res = _resident_matmul("pallas")
    before = (graph_filter.launches, graph_filter.bwd_launches)
    Yk = Y.clone().requires_grad_(True)
    out = res(S0, Yk)
    (dY,) = torch.autograd.grad(out, Yk, G)
    torch.cuda.synchronize()
    assert (graph_filter.launches - before[0],
            graph_filter.bwd_launches - before[1]) == (1, 1)
    Yp = Y.clone().requires_grad_(True)
    outp = S0 @ Yp
    (dYp,) = torch.autograd.grad(outp, Yp, G)
    torch.testing.assert_close(out, outp, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(dY, dYp, atol=5e-4, rtol=5e-4)


def test_halo_pallas_meta_step_on_simulated_shards(cuda):
    """One ``train_surf`` step with mix="halo-pallas" on 2 simulated
    shards of the card: shards·K·L forward and as many dW launches, θ
    within 5e-6 of the dense kernel path on the same draws."""
    from repro_torch.launch.mesh import make_surf_mesh
    mds = make_meta_dataset(SMOKE, 2, seed=0)
    mesh = make_surf_mesh(1, 2, devices=["cuda:0"] * 2)
    before = (graph_filter.launches, graph_filter.bwd_launches)
    halo, _, _ = surf.train_surf(SMOKE, mds, steps=1, mix="halo-pallas",
                                 mesh=mesh, log_every=0)
    torch.cuda.synchronize()
    per = 2 * SMOKE.filter_taps * SMOKE.n_layers
    assert (graph_filter.launches - before[0],
            graph_filter.bwd_launches - before[1]) == (per, per)
    dense, _, _ = surf.train_surf(SMOKE, mds, steps=1, log_every=0)
    for k in dense.theta:
        torch.testing.assert_close(halo.theta[k], dense.theta[k], atol=5e-6,
                                   rtol=5e-6)


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


def test_kernel_on_isolated_agents(cuda):
    """Dropout S_t (rows e_i for the dropped agents), unbatched at PAPER's
    n and batched: forward within 5e-5 and dW within 5e-4 of the plain
    version, and the isolated agents' rows hold Σ h_k · w_i."""
    from repro_torch.configs.surf_paper import PAPER
    sched = surf.make_scenario(PAPER, "dropout", 4, seed=1, device=cuda)
    eye = torch.eye(PAPER.n_agents, device=cuda)
    assert (sched.S[1:] == eye).all(-1).any(-1).all()
    for S in (sched.S[1], sched.S[1:]):
        B = None if S.dim() == 2 else S.shape[0]
        _, W, h = _inputs(B, PAPER.n_agents, 650, 2, cuda, seed=3)
        G = torch.randn(W.shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2))
        Wk = W.clone().requires_grad_(True)
        y = graph_filter(S, Wk, h)
        (dW,) = torch.autograd.grad(y, Wk, G)
        Wp = W.clone().requires_grad_(True)
        yp = graph_filter_ref(S, Wp, h)
        (dWp,) = torch.autograd.grad(yp, Wp, G)
        torch.testing.assert_close(y, yp, atol=5e-5, rtol=5e-5)
        torch.testing.assert_close(dW, dWp, atol=5e-4, rtol=5e-4)
        rows = (S == eye).all(-1)
        torch.testing.assert_close(y[rows], h.sum() * W[rows], atol=5e-5,
                                   rtol=5e-5)


def test_scheduled_training_through_kernel_matches_plain(cuda):
    """Three meta-steps under a dropout schedule (T = 2, so it cycles):
    L forward and L−1 dW launches per step, and the state within 5e-6 of
    the same run through the plain filter (same generators, so the same
    draws)."""
    from repro_torch.engine.scan import train_scan
    sched = surf.make_scenario(SMOKE, "dropout", 2, seed=0, device=cuda)
    mds = make_meta_dataset(SMOKE, 2)
    before = (graph_filter.launches, graph_filter.bwd_launches)
    sk, hk = train_scan(SMOKE, sched, mds, 3, log_every=1, device=cuda)
    torch.cuda.synchronize()
    assert (graph_filter.launches - before[0],
            graph_filter.bwd_launches - before[1]) == (
                3 * SMOKE.n_layers, 3 * (SMOKE.n_layers - 1))
    sp, hp = train_scan(SMOKE, sched, mds, 3, log_every=1, device=cuda,
                        mix_fn=make_plain_mix())
    for k in sk.theta:
        torch.testing.assert_close(sk.theta[k], sp.theta[k], atol=5e-6,
                                   rtol=5e-6)
    torch.testing.assert_close(sk.lam, sp.lam, atol=5e-6, rtol=5e-6)
    for rk, rp in zip(hk, hp):
        for k in rp:
            np.testing.assert_allclose(rk[k], rp[k], atol=5e-6, rtol=5e-6)


def test_async_evaluation_through_kernel_matches_plain(cuda):
    """``evaluate_async`` through the kernel: L launches per dataset and
    seed; per-layer loss within 5e-5 and accuracy within 1.5/(n t) (one
    flipped test row) of the plain filter on the same draws and masks."""
    gen = torch.Generator(cuda).manual_seed(0)
    state = init_state(gen, SMOKE, init="random")
    _, S = surf.make_problem(SMOKE, seed=0)
    mds = make_meta_dataset(SMOKE, 3, seed=5)
    before = graph_filter.launches
    kern = surf.evaluate_async(SMOKE, state, S, mds, 3, seeds=(0, 1))
    torch.cuda.synchronize()
    assert graph_filter.launches - before == SMOKE.n_layers * 3 * 2
    plain = surf.evaluate_async(SMOKE, state, S, mds, 3, seeds=(0, 1),
                                mix_fn=make_plain_mix())
    np.testing.assert_allclose(kern["loss_per_layer"],
                               plain["loss_per_layer"], atol=5e-5, rtol=5e-5)
    n_t = SMOKE.n_agents * SMOKE.test_per_agent
    np.testing.assert_allclose(kern["acc_per_layer"], plain["acc_per_layer"],
                               atol=1.5 / n_t, rtol=0)


def test_seed_batched_training_launches_and_rows(cuda):
    """Seed-batched training through the kernel: per lockstep step
    n_seeds × L forward and n_seeds × (L − 1) dW launches, plus L per
    eval dataset per seed per snapshot; each row bit-equal to the
    sequential run on the card."""
    mds = make_meta_dataset(SMOKE, 3)
    ev = make_meta_dataset(SMOKE, 2, seed=9)
    seeds, steps, L = (0, 1, 2), 4, SMOKE.n_layers
    before = (graph_filter.launches, graph_filter.bwd_launches)
    states, hist, snaps, S_stack = surf.train_surf(
        SMOKE, mds, steps, seeds=seeds, log_every=1, eval_every=2,
        eval_datasets=ev)
    torch.cuda.synchronize()
    n = len(seeds)
    assert (graph_filter.launches - before[0],
            graph_filter.bwd_launches - before[1]) == (
                steps * n * L + 2 * n * len(ev) * L, steps * n * (L - 1))
    from repro_torch.engine import state_for_seed
    for i, s in enumerate(seeds):
        st, h, sn, S = surf.train_surf(SMOKE, mds, steps, seed=s,
                                       log_every=1, eval_every=2,
                                       eval_datasets=ev)
        assert torch.equal(S_stack[i], S)
        row = state_for_seed(states, i)
        for k in st.theta:
            assert torch.equal(row.theta[k], st.theta[k])
        for a, b in zip(snaps, sn):
            assert np.array_equal(a["acc_per_layer"][i], b["acc_per_layer"])


@pytest.mark.parametrize("kind", ["sparse", "robust"])
def test_sparse_and_robust_meta_steps_through_kernel(cuda, kind):
    """A SPARSE_SMOKE (d = 16) or RSDUN meta-step through the kernel: L
    and L − 1 launches, the state within 5e-6 of the plain filter on the
    same draws (and, robust, the same δ)."""
    from repro_torch.configs.surf_paper import SPARSE_SMOKE
    cfg = (SPARSE_SMOKE if kind == "sparse" else dataclasses.replace(
        SMOKE, robust_sigma=0.1, robust_samples=2))
    task = resolve_task(cfg)
    _, S = surf.make_problem(cfg, seed=0)
    batch = task.to_batch(task.synth_datasets(cfg, 1)[0], cuda)
    state = init_state(torch.Generator(cuda).manual_seed(0), cfg)
    draws = unroll.featurize_cohort(unroll.step_generator(0, 0, cuda),
                                    batch, cfg)
    deltas = (unroll.sample_deltas(unroll.robust_generator(0, 0, cuda), cfg)
              if kind == "robust" else None)
    before = (graph_filter.launches, graph_filter.bwd_launches)
    sk, mk = make_meta_step(cfg, S)[0](state, batch, draws=draws,
                                       deltas=deltas)
    torch.cuda.synchronize()
    assert (graph_filter.launches - before[0],
            graph_filter.bwd_launches - before[1]) == (cfg.n_layers,
                                                       cfg.n_layers - 1)
    sp, mp = make_meta_step(cfg, S, mix_fn=make_plain_mix())[0](
        state, batch, draws=draws, deltas=deltas)
    for k in sk.theta:
        torch.testing.assert_close(sk.theta[k], sp.theta[k], atol=5e-6,
                                   rtol=5e-6)
    for k in mk:
        torch.testing.assert_close(mk[k], mp[k], atol=5e-6, rtol=5e-6)


def test_resume_on_the_card_is_bit_exact(cuda, tmp_path):
    from repro_torch.engine import resume
    mds = make_meta_dataset(SMOKE, 3)
    full, _, S = surf.train_surf(SMOKE, mds, 8, log_every=0,
                                 checkpoint_every=2,
                                 checkpoint_dir=str(tmp_path))
    res, _ = resume.resume_train_scan(SMOKE, S, mds, 8, 0, str(tmp_path),
                                      step=4)
    for k in full.theta:
        assert torch.equal(full.theta[k], res.theta[k])
        assert res.theta[k].device.type == "cuda"


def test_baseline_on_card_matches_cpu(cuda):
    """DFedAvgM (the baseline with the most local steps) on the card and
    on the CPU from one set of numpy draws: per-round loss within 1e-4 of
    the largest, accuracy within 2/(n t); no graph-filter launch."""
    from repro_torch.core import baselines
    rng = np.random.default_rng(0)
    n, m, b = SMOKE.n_agents, SMOKE.train_per_agent, SMOKE.batch_per_agent
    _, S = surf.make_problem(SMOKE, seed=0, device="cpu")
    ds = sample_dataset(SMOKE, seed=7)
    W0 = (0.1 * rng.standard_normal((n, SMOKE.head_dim))).astype(np.float32)
    draws = {"idx": rng.integers(0, m, (40, 6, n, b))}
    before = (graph_filter.launches, graph_filter.bwd_launches)
    card = baselines.run_dfedavgm(S, W0, ds, None, SMOKE, rounds=40,
                                  lr=0.05, draws=draws)
    assert (graph_filter.launches, graph_filter.bwd_launches) == before
    cpu = baselines.run_dfedavgm(S, W0, ds, None, SMOKE, rounds=40, lr=0.05,
                                 draws=draws, device="cpu")
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=0,
                               atol=1e-4 * np.abs(cpu["loss"]).max())
    np.testing.assert_allclose(card["acc"], cpu["acc"], rtol=0,
                               atol=2.0 / (n * SMOKE.test_per_agent))


# The reference's sweep shapes (tests/test_kernels.py) and three more: the
# 128-wide head, a window across tiles and a non-causal ragged Skv.
FLASH_SHAPES = [(1, 4, 4, 64, 32, 0, True), (2, 4, 2, 80, 32, 0, True),
                (1, 8, 2, 128, 64, 16, True), (1, 2, 1, 48, 16, 8, True),
                (2, 4, 1, 200, 128, 0, True), (1, 4, 2, 300, 128, 70, True),
                (1, 2, 2, 100, 64, 0, False)]
WKV_SHAPES = [(1, 2, 32, 16), (2, 3, 50, 16), (1, 4, 64, 64), (2, 1, 17, 8),
              (2, 4, 70, 64), (1, 2, 33, 40)]


FLASH_F32_ERR_MAX = 1e-5   # as chip_smoke.py


def _flash_inputs(B, H, KV, S, dh, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((B, n, S, dh)).astype(np.float32),
                         device=device).to(dtype) for n in (H, KV, KV)]


def _assert_flash_matches(o, q, k, v, causal, window):
    """The reference's flash tolerance, then the kernel's own: f32 within
    FLASH_F32_ERR_MAX, bf16 within ``bf16_error_bound`` per element."""
    o_ref = attention_ref(q, k, v, causal=causal, window=window)
    tol = 10 * TOL[q.dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    err = (o.float() - o_ref.float()).abs()
    if q.dtype == torch.float32:
        assert err.max().item() <= FLASH_F32_ERR_MAX
    else:
        bound = flash_ops.bf16_error_bound(q, k, v, o_ref, causal=causal,
                                           window=window)
        assert (err <= bound).all(), (err / bound).max().item()


@pytest.mark.parametrize("B,H,KV,S,dh,win,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, B, H, KV, S, dh, win,
                                            causal, dtype):
    q, k, v = _flash_inputs(B, H, KV, S, dh, dtype, cuda)
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    _assert_flash_matches(o, q, k, v, causal, win)


def test_flash_kernel_reads_strided_views(cuda):
    """The model's (B, S, H, dh) projections go in as transposed views; the
    output keeps q's strides."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _flash_inputs(2, 8, 2, 90, 64, torch.float32, cuda))
    assert not q.is_contiguous()
    o = flash_attention(q, k, v, window=32)
    assert o.stride() == q.stride()
    torch.testing.assert_close(o, attention_ref(q, k, v, window=32),
                               atol=5e-4, rtol=5e-4)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 2, 1, 16, 160, torch.float32, cuda)
    with pytest.raises(ValueError, match="dh <= 128"):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(1, 2, 1, 16, 32, torch.float32, cuda)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="share a device"):
        flash_attention(q, k.cpu(), v)


def test_flash_kernel_takes_a_strided_head_dim(cuda):
    """A stride over dh other than 1 is copied in the wrapper, as the
    plain version takes it; one launch."""
    q, k, v = _flash_inputs(1, 4, 2, 70, 64, torch.float32, cuda)
    qs, ks, vs = (t[..., ::2] for t in (q, k, v))
    assert qs.stride(3) == 2
    before = flash_attention.launches
    o = flash_attention(qs, ks, vs, window=20)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_flash_matches(o, qs.contiguous(), ks.contiguous(),
                          vs.contiguous(), True, 20)


def _wkv_inputs(B, H, T, dk, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = 0.5 + 0.5 / (1 + np.exp(-mk()))
    u = 0.1 * rng.standard_normal((H, dk)).astype(np.float32)
    return ([torch.tensor(a, device=device).to(dtype) for a in (r, k, v, w)]
            + [torch.tensor(u, device=device)])


@pytest.mark.parametrize("B,H,T,dk", WKV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_kernel_matches_plain_version(cuda, B, H, T, dk, dtype):
    r, k, v, w, u = _wkv_inputs(B, H, T, dk, dtype, cuda)
    before = wkv.launches
    y, S = wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    assert y.dtype == dtype and S.dtype == torch.float32
    _assert_wkv_matches(y, S, r, k, v, w, u)


def _assert_wkv_matches(y, S, r, k, v, w, u):
    """The reference's wkv tolerance, then, for bf16, the kernel's own: y
    within ``bf16_error_bound`` per element, the f32 S at f32's."""
    yr, Sr = wkv_ref(r, k, v, w, u)
    tol = 20 * TOL[r.dtype]
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(S, Sr, atol=tol, rtol=tol)
    if r.dtype == torch.bfloat16:
        err = (y.float() - yr.float()).abs()
        bound = wkv_ops.bf16_error_bound(yr)
        assert (err <= bound).all(), (err / bound).max().item()
        f32_tol = 20 * TOL[torch.float32]
        torch.testing.assert_close(S, Sr, atol=f32_tol, rtol=f32_tol)


def test_wkv_kernel_reads_strided_views_and_refuses(cuda):
    r, k, v, w, u = (t.transpose(1, 2).contiguous().transpose(1, 2)
                     if t.dim() == 4 else t
                     for t in _wkv_inputs(2, 4, 40, 64, torch.float32, cuda))
    y, S = wkv(r, k, v, w, u)
    assert y.stride() == r.stride()
    yr, Sr = wkv_ref(r, k, v, w, u)
    torch.testing.assert_close(y, yr, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(S, Sr, atol=1e-3, rtol=1e-3)
    big = _wkv_inputs(1, 1, 4, 72, torch.float32, cuda)
    with pytest.raises(ValueError, match="dk <= 64"):
        wkv(*big)
    # a stride over dk other than 1 is copied in the wrapper: one launch,
    # equal to the plain version
    strided = [a[..., ::2] for a in (r, k, v, w)] + [u[:, ::2]]
    before = wkv.launches
    y, S = wkv(*strided)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    _assert_wkv_matches(y, S, *(a.contiguous() for a in strided))


# The tensor-core tiling's edges (64 query rows per block; 32 keys per f32
# and 64 per bf16 kv tile; k-steps of 8 and 16): Sq and Skv off the tile
# multiples, Sq != Skv, ragged k-steps (dh 24 and 80), a window narrower
# than one tile, MQA (KV = 1), non-causal. (B, H, KV, Sq, Skv, dh, window,
# causal)
FLASH_EDGES = [(1, 4, 2, 77, 77, 64, 0, True), (2, 2, 1, 65, 130, 24, 0, True),
               (1, 3, 3, 100, 51, 80, 0, False), (1, 4, 1, 150, 150, 128, 5, True),
               (2, 4, 4, 33, 97, 80, 0, False), (1, 2, 1, 129, 129, 24, 40, False)]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", FLASH_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_tile_edges(cuda, B, H, KV, Sq, Skv, dh, win, causal,
                                 dtype):
    rng = np.random.default_rng(Sq + Skv + dh)
    q, k, v = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=cuda).to(dtype)
        for n, s in ((H, Sq), (KV, Skv), (KV, Skv)))
    o = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    _assert_flash_matches(o, q, k, v, causal, win)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_per_element_path(cuda, dtype):
    """Rows that do not start on 16 bytes (an odd sequence stride) take the
    kernel's per-element loads and stores, not a copy or a refusal. q is
    not dense, so o has contiguous strides."""
    q, k, v = (t[..., :40] for t in _flash_inputs(2, 4, 2, 70, 41, dtype,
                                                  cuda))
    assert not vector_loads(q, k, v)
    o = flash_attention(q, k, v, window=20)
    assert o.is_contiguous()
    _assert_flash_matches(o, q, k, v, True, 20)


# T = 1, T off the 16-step chunk, ragged dk (50: four column blocks, the
# last with 2 live columns; 8: the 16-wide instance). (B, H, T, dk)
WKV_EDGES = [(2, 3, 1, 64), (1, 2, 33, 64), (2, 2, 40, 50), (1, 3, 33, 8)]


@pytest.mark.parametrize("B,H,T,dk", WKV_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "unaligned"])
def test_wkv_kernel_tile_edges(cuda, B, H, T, dk, dtype, layout):
    """The edges in three layouts: contiguous, the model's (B, T, H, dk)
    transposed view, and rows that do not start on 16 bytes (per-element
    loads). y has r's strides where r is dense, contiguous ones where it
    is not."""
    if layout == "unaligned":
        *rkvw, u = _wkv_inputs(B, H, T, dk + 1, dtype, cuda)
        r, k, v, w = (a[..., :dk] for a in rkvw)
        u = u[:, :dk]
        assert not vector_loads(r, k, v, w)
    else:
        r, k, v, w, u = _wkv_inputs(B, H, T, dk, dtype, cuda)
        if layout == "transposed":
            r, k, v, w = (a.transpose(1, 2).contiguous().transpose(1, 2)
                          for a in (r, k, v, w))
    y, S = wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    if layout == "unaligned":
        assert y.is_contiguous()
    else:
        assert y.stride() == r.stride()
    _assert_wkv_matches(y, S, r, k, v, w, u)


def test_wkv_launch_shape(cuda):
    """The rwkv6-1.6b prefill shape spreads each head over 2 blocks of 128
    threads (32 value columns each): 256 blocks."""
    assert wkv_ops.launch_shape(4, 32, 64) == (256, 128)
    assert wkv_ops.launch_shape(1, 2, 16) == (2, 128)
    assert wkv_ops.launch_shape(2, 2, 50) == (8, 128)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_prefill_and_decode_through_kernels(cuda, arch):
    """A reduced-config prefill launches the flash kernel once per
    attention layer or the wkv kernel once per RWKV layer, decode launches
    neither, and logits and caches match the same model run through the
    plain versions (``plain_kernels=True``) at 1e-4, over a prefill and 4
    teacher-forced decode steps."""
    cfg = get_config(arch).reduced()
    params = M.init_lm(cfg, 0, device=cuda)
    ids = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (2, 40)),
                       device=cuda)
    P, cache_len = 36, 40
    before = (flash_attention.launches, wkv.launches)
    logits, cache, _ = M.forward(cfg, params, ids[:, :P], want_cache=True,
                              cache_len=cache_len)
    torch.cuda.synchronize()
    n = cfg.n_layers
    want = (0, n) if cfg.attn is None else (n, 0)
    assert (flash_attention.launches - before[0],
            wkv.launches - before[1]) == want
    plain, pcache, _ = M.forward(cfg, params, ids[:, :P], want_cache=True,
                              cache_len=cache_len, plain_kernels=True)
    torch.testing.assert_close(logits, plain, atol=1e-4, rtol=1e-4)
    for pos in range(P, cache_len):
        tok = ids[:, pos:pos + 1]
        lk, cache = M.decode_step(cfg, params, tok, cache, pos, cache_len)
        lp, pcache = M.decode_step(cfg, params, tok, pcache, pos, cache_len)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    assert (flash_attention.launches - before[0],
            wkv.launches - before[1]) == want
    prefill = make_prefill_step(cfg, cache_len)
    decode = make_decode_step(cfg, cache_len)
    tok, cache = prefill(params, {"tokens": ids[:, :P]})
    tok, cache = decode(params, cache, tok, P)
    assert tok.shape == (2, 1) and 0 <= int(tok.min()) <= int(tok.max()) < cfg.vocab


# ------------------------------------------------------ backward kernels
# Gradients of the backward kernels against autograd through the plain
# versions, within BWD_REL_TOL of each gradient's largest entry (as
# chip_smoke.py phases 5b-6b: f32 sums in another order).
BWD_REL_TOL = 1e-4
FLASH_BWD_SHAPES = ([(B, H, KV, S, S, dh, win, causal)
                     for B, H, KV, S, dh, win, causal in FLASH_SHAPES]
                    + FLASH_EDGES)


def _rel_grads_close(got, ref):
    for g, r in zip(got, ref):
        err = (g - r).abs().max().item()
        assert err <= BWD_REL_TOL * r.abs().max().item(), err


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", FLASH_BWD_SHAPES)
def test_flash_backward_kernel_matches_plain_version(cuda, B, H, KV, Sq, Skv,
                                                     dh, win, causal):
    rng = np.random.default_rng(Sq + dh)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=cuda) for n, s in ((H, Sq), (KV, Skv),
                                               (KV, Skv), (H, Sq)))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention.bwd_launches)
    o = flash_attention(*xs, causal=causal, window=win)
    got = torch.autograd.grad(o, xs, do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_flash_matches(o.detach(), q, k, v, causal, win)
    xr = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(attention_ref(*xr, causal=causal, window=win),
                              xr, do)
    _rel_grads_close(got, ref)
    again = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                                window=win), xs, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,H,T,dk", WKV_SHAPES + WKV_EDGES)
def test_wkv_backward_kernel_matches_plain_version(cuda, B, H, T, dk):
    args = _wkv_inputs(B, H, T, dk, torch.float32, cuda, seed=T + dk)
    dy = torch.tensor(np.random.default_rng(T).standard_normal(
        (B, H, T, dk)).astype(np.float32), device=cuda)
    xs = [a.clone().requires_grad_() for a in args]
    before = (wkv.launches, wkv.bwd_launches)
    y, S = wkv(*xs)
    got = torch.autograd.grad(y, xs, dy)
    torch.cuda.synchronize()
    assert (wkv.launches, wkv.bwd_launches) == (before[0] + 1,
                                                before[1] + 1)
    xr = [a.clone().requires_grad_() for a in args]
    # at T = 1 the plain recurrence never reads w: its gradient is zero
    ref = [torch.zeros_like(x) if g is None else g for x, g in zip(
        xr, torch.autograd.grad(wkv_ref(*xr)[0], xr, dy, allow_unused=True))]
    _rel_grads_close(got, ref)
    again = torch.autograd.grad(wkv(*xs)[0], xs, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The backward kernels' tiling edges: dk/dv blocks of 128 keys over query
# tiles of 32 rows, dq blocks of 64 rows over kv tiles of 32 keys, k-steps
# of 8 over dh. dh 64 and 96, Sq and Skv off every tile multiple (and
# Skv > Sq), windows narrower than a query tile and than a key block, GQA
# and MQA. (B, H, KV, Sq, Skv, dh, window, causal)
FLASH_BWD_EDGES = [(1, 4, 2, 200, 200, 96, 0, True),
                   (1, 4, 1, 257, 257, 64, 0, True),
                   (2, 2, 2, 130, 300, 64, 0, False),
                   (1, 4, 2, 300, 300, 96, 20, True),
                   (1, 2, 1, 161, 161, 128, 100, True),
                   (1, 6, 2, 50, 45, 96, 7, False)]


def _bwd_layout(ts, layout):
    """The model's (B, S, heads, dh) transposed views, or rows that do not
    start on 16 bytes (per-element loads), of the same values."""
    if layout == "transposed":
        return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]
    if layout == "unaligned":
        wide = [torch.nn.functional.pad(t, (0, 1)) for t in ts]
        out = [t[..., :-1] for t in wide]
        assert not vector_loads(*out)
        return out
    return ts


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal", FLASH_BWD_EDGES)
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "unaligned"])
def test_flash_backward_kernel_tiling_edges(cuda, B, H, KV, Sq, Skv, dh, win,
                                            causal, layout):
    """dq, dk, dv at the tiling's edges within 1e-4 of each plain
    gradient's largest entry, in three layouts; a rerun bit-equal."""
    rng = np.random.default_rng(Sq + Skv + dh)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=cuda) for n, s in ((H, Sq), (KV, Skv),
                                               (KV, Skv), (H, Sq)))
    q, k, v, do = _bwd_layout([q, k, v, do], layout)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                              window=win), xs, do)
    xr = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(attention_ref(*xr, causal=causal, window=win),
                              xr, do)
    _rel_grads_close(got, ref)
    again = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                                window=win), xs, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# dk below 64 (one and two column groups, a group with 8 live columns,
# dk not a multiple of 4), T off the 16-step chunk and its 8-step halves
# (T < 8, a last chunk of 1 and of 9 steps). (B, H, T, dk)
WKV_BWD_EDGES = [(2, 2, 37, 40), (1, 3, 23, 24), (2, 2, 7, 64),
                 (1, 2, 49, 33), (1, 1, 25, 16)]


@pytest.mark.parametrize("B,H,T,dk", WKV_BWD_EDGES)
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "unaligned"])
def test_wkv_backward_kernel_tiling_edges(cuda, B, H, T, dk, layout):
    """dr, dk, dv, dw, du at the column groups' and chunks' edges, with
    the first three decays of every row at 1e-7 (no division by w), within
    1e-4 of each plain gradient's largest entry; a rerun bit-equal."""
    args = _wkv_inputs(B, H, T, dk, torch.float32, cuda, seed=T + dk)
    args[3][..., :3, :] = 1e-7
    dy = torch.tensor(np.random.default_rng(T).standard_normal(
        (B, H, T, dk)).astype(np.float32), device=cuda)
    *rkvw, dy = _bwd_layout(args[:4] + [dy], layout)
    xs = [a.detach().requires_grad_() for a in rkvw + [args[4]]]
    got = torch.autograd.grad(wkv(*xs)[0], xs, dy)
    xr = [a.detach().clone().requires_grad_() for a in xs]
    ref = torch.autograd.grad(wkv_ref(*xr)[0], xr, dy)
    _rel_grads_close(got, ref)
    again = torch.autograd.grad(wkv(*xs)[0], xs, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_backward_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = _flash_inputs(1, 2, 1, 40, 32, torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.requires_grad_(), k, v)
    args = _wkv_inputs(1, 2, 20, 16, torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="float32"):
        wkv(args[0].requires_grad_(), *args[1:])
    args = [a.float().requires_grad_() for a in args]
    y, S = wkv(*args)
    with pytest.raises(NotImplementedError, match="final state"):
        (y.sum() + S.sum()).backward()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_train_step_through_kernels_matches_plain(cuda, arch):
    """A reduced-config train step with remat through the kernels: 2L
    forward and L backward launches of the layer's kernel, the loss and
    every gradient within 1e-4 of the plain versions' (each tensor's
    largest entry), and the step's parameters finite."""
    from repro_torch import flags
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    cfg = get_config(arch).reduced()
    params = M.init_lm(cfg, 0, device=cuda)
    ids = np.random.default_rng(1).integers(0, cfg.vocab, (2, 65))
    batch = {"tokens": torch.tensor(ids[:, :-1], device=cuda),
             "labels": torch.tensor(ids[:, 1:], device=cuda)}
    flags.set_flags(chunked_ce=16)
    try:
        kernel = flash_attention if cfg.attn is not None else wkv
        before = (kernel.launches, kernel.bwd_launches)
        (lk, _), gk = loss_and_grads(cfg, params, batch, remat=True)
        L = cfg.n_layers
        assert (kernel.launches - before[0],
                kernel.bwd_launches - before[1]) == (2 * L, L)
        (lp, _), gp = loss_and_grads(cfg, params, batch, remat=True,
                                     plain_kernels=True)
        assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
        _rel_grads_close(_leaf_list(gk), _leaf_list(gp))
        step, opt = make_train_step(cfg, lr=1e-3, remat=True)
        new, _, m = step(params, opt.init(params), batch)
        assert all(torch.isfinite(t).all() for t in _leaf_list(new))
        assert abs(m["loss"].item() - lk.item()) <= 1e-6 * abs(lk.item())
    finally:
        flags.set_flags(chunked_ce=0)


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_list(v)]
    return [tree]
