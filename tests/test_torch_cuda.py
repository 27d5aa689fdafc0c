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
(whisper's encoder and cross-attention included) against the same model
run through the plain versions, the flash kernels at whisper's
non-causal calls (ragged Skv, Sq != Skv, dh = 64), the flash and wkv
backward kernels against autograd through the plain versions (also at
their tiling's edges, in three layouts, with bit-equal reruns), and a
reduced-config LM train step through the kernels against the plain one,
the bf16 flash forward's own checks (P rounded before P·V, rows that see
no key, its log-sum-exp, the TMA entry's refusals), and gemma3-27b's
bf16 and windowed pieces (the f32-accumulated bf16 head,
a windowed bf16 flash call made by ``full_attention`` at the gemma3
shape, the ring cache across its window against the plain path), and
the backward kernels' bf16 entries (within each wrapper's
``bf16_grad_error_bound`` per element, at the backward shapes and
tiling edges, in three layouts) and wkv's final-state gradient (f32 and
bf16).

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
from types import SimpleNamespace

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
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import stack as ST
from repro_torch.utils.device import resolve_device
from repro_torch.serve import BucketSpec, FederationServer

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

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
    """Rows that do not start on 16 bytes (an odd sequence stride): both
    dtypes, whose kernels read q (bf16: and k, v) by TMA, pass as
    contiguous copies (``ops.tma_inputs``), not a refusal; the f32
    kernel's split pass reads k and v by plain loads. q is not dense, so
    o has contiguous strides."""
    q, k, v = (t[..., :40] for t in _flash_inputs(2, 4, 2, 70, 41, dtype,
                                                  cuda))
    assert not vector_loads(q, k, v)
    o = flash_attention(q, k, v, window=20)
    assert o.is_contiguous()
    _assert_flash_matches(o, q, k, v, True, 20)


def test_flash_bf16_rounds_p_before_pv(cuda):
    """The bf16 kernel rounds P to bf16 before P·V and sums l in f32: one
    query over two keys where p1 = 0.99707, held as 1 − 2⁻⁸ in bf16, and
    v1 = 256 give o = 127.5 (an f32 P would give 128), as the CPU
    emulation's rounding probe (``tests/test_torch_flash_attention.py``)
    works out."""
    q = torch.zeros((1, 1, 1, 16), device=cuda)
    k = torch.zeros((1, 1, 2, 16), device=cuda)
    v = torch.zeros((1, 1, 2, 16), device=cuda)
    q[..., 0] = 1.0
    k[0, 0, 1, 0] = -0.01171875
    v[0, 0, 1, 0] = 256.0
    o = flash_attention(*(t.bfloat16() for t in (q, k, v)), causal=False)
    torch.cuda.synchronize()
    assert o[0, 0, 0, 0].item() == 127.5 and not o[..., 1:].any()


def test_flash_bf16_gives_fully_masked_rows_zero_and_lse(cuda):
    """The bf16 kernel at a non-causal window with Sq > Skv + window − 1:
    rows that see no key get o = 0 (as the f32 kernel and the reference's
    Pallas kernel give them); the others match the plain version within
    the bound, and their log-sum-exp (log2 units, for the backward) the
    plain softmax's within 1e-5 of its size."""
    Sq, Skv, win, dh = 300, 140, 40, 64
    q, k, v = (torch.tensor(np.random.default_rng(s).standard_normal(
        (2, n, L, dh)).astype(np.float32), device=cuda).bfloat16()
        for s, n, L in ((0, 4, Sq), (1, 2, Skv), (2, 2, Skv)))
    o, lse = flash_ops._launch(q, k, v, False, win, want_lse=True)
    torch.cuda.synchronize()
    dead = torch.arange(Sq, device=cuda) >= Skv + win - 1
    assert (o[:, :, dead] == 0).all()
    o_ref = attention_ref(q, k, v, causal=False, window=win)
    bound = flash_ops.bf16_error_bound(q, k, v, o_ref, causal=False,
                                       window=win)
    assert ((o.float() - o_ref.float()).abs() <= bound)[:, :, ~dead].all()
    kh = k.float().repeat_interleave(2, dim=1)
    scores = (q.float() @ kh.mT) * dh ** -0.5
    i = torch.arange(Sq, device=cuda)[:, None]
    j = torch.arange(Skv, device=cuda)[None, :]
    ref = torch.logsumexp(torch.where(j > i - win, scores, -torch.inf),
                          -1) / np.log(2)
    torch.testing.assert_close(lse[:, :, ~dead], ref[:, :, ~dead],
                               atol=1e-5 * ref.abs().max().item(), rtol=0)


def test_flash_bf16_entry_refuses_what_tma_cannot_read(cuda):
    """Called directly, the forward's bf16 entry refuses dh off a multiple
    of 8 (invalid value) and a row off 16 bytes (misaligned address): the
    wrapper pads or copies such inputs first, so a model never meets it."""
    import ctypes
    B, H, S, dh = 1, 2, 64, 64
    x = torch.zeros((B, H, S, dh + 8), dtype=torch.bfloat16, device=cuda)
    o = torch.empty((B, H, S, dh), dtype=torch.bfloat16, device=cuda)
    fn = flash_ops.LIB.load().flash_attention_bf16

    def call(t, d):
        strides = (ctypes.c_longlong * 12)(*(list(t.stride()[:3]) * 3
                                             + list(o.stride()[:3])))
        return fn(t.data_ptr(), t.data_ptr(), t.data_ptr(), o.data_ptr(), B,
                  H, H, S, S, d, strides, 1, 0, 0.18, None, None,
                  torch.cuda.current_stream().cuda_stream)
    assert call(x, dh) == 0
    torch.cuda.synchronize()
    assert call(x, 60) == 1                  # cudaErrorInvalidValue
    assert call(x[..., 1:], dh) == 716       # cudaErrorMisalignedAddress


def test_flash_f32_entry_refuses_what_tma_cannot_read(cuda):
    """Called directly, the forward's f32 entry refuses dh off a multiple
    of 4 (invalid value), and a row of q or o off 16 bytes and scratch off
    16 bytes (misaligned address): the wrapper pads or copies such inputs
    and allocates the scratch, so a model never meets it. k and v are read
    by plain loads: a k row off 16 bytes is taken, and matches the plain
    version."""
    import ctypes
    B, H, S, dh = 1, 2, 64, 64
    x = torch.randn((B, H, S, dh + 4), device=cuda)
    o = torch.empty((B, H, S, dh), device=cuda)
    scratch = torch.zeros(flash_ops.fwd_scratch_floats(B, H, S, dh) + 4,
                          device=cuda)
    fn = flash_ops.LIB.load().flash_attention_f32

    def call(qt, kt, d, out=o, sp=scratch.data_ptr()):
        strides = (ctypes.c_longlong * 12)(*(list(qt.stride()[:3])
                                             + list(kt.stride()[:3]) * 2
                                             + list(out.stride()[:3])))
        return fn(qt.data_ptr(), kt.data_ptr(), kt.data_ptr(),
                  out.data_ptr(), B, H, H, S, S, d, strides, 1, 0,
                  dh ** -0.5 * 1.4426950408889634, sp, None,
                  torch.cuda.current_stream().cuda_stream)
    assert call(x, x, dh) == 0
    torch.cuda.synchronize()
    assert call(x, x, 62) == 1               # cudaErrorInvalidValue
    assert call(x[..., 1:], x, dh) == 716    # cudaErrorMisalignedAddress
    wide = torch.empty((B, H, S, dh + 1), device=cuda)
    assert call(x, x, dh, out=wide[..., 1:]) == 716
    assert call(x, x, dh, sp=scratch.data_ptr() + 4) == 716
    assert call(x, x[..., 1:], dh) == 0      # k, v through their strides
    torch.cuda.synchronize()
    kv = x[..., 1:dh + 1]
    torch.testing.assert_close(o, attention_ref(x[..., :dh], kv, kv),
                               atol=FLASH_F32_ERR_MAX, rtol=0)


# The f32 forward reads q by TMA: dh off a multiple of 4 is padded by the
# wrapper (q, k and v), rows TMA cannot read are copied, a stride over dh
# other than 1 is copied. (B, H, KV, Sq, Skv, dh, window, causal, layout)
FLASH_F32_COPIED = [(1, 4, 2, 200, 200, 18, 0, True, "contiguous"),
                    (1, 4, 2, 150, 150, 98, 30, True, "transposed"),
                    (2, 2, 1, 130, 97, 37, 0, False, "unaligned"),
                    (1, 4, 2, 150, 150, 96, 30, True, "strided"),
                    (2, 4, 4, 77, 77, 61, 0, True, "strided")]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal,layout",
                         FLASH_F32_COPIED)
def test_flash_f32_takes_padded_and_copied_operands(cuda, B, H, KV, Sq, Skv,
                                                    dh, win, causal, layout):
    """The f32 forward through the wrapper on operands it pads (dh off a
    multiple of 4) or copies (rows off 16 bytes, a stride over dh), and
    the model's transposed views as they are: within FLASH_F32_ERR_MAX of
    the plain version, o the shape of q, one launch per call."""
    rng = np.random.default_rng(Sq + dh + 3)
    q, k, v = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=cuda) for n, s in ((H, Sq), (KV, Skv),
                                               (KV, Skv)))
    q, k, v = _bwd_layout([q, k, v], layout)
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and o.shape == q.shape
    _assert_flash_matches(o, q, k, v, causal, win)


# T = 1, T off the y kernel's 8-step sub-chunk and the 64-step chunk
# (one chunk, and several with a ragged last one), ragged dk (50, 8: zero
# channels up to 64). (B, H, T, dk)
WKV_EDGES = [(2, 3, 1, 64), (1, 2, 33, 64), (2, 2, 40, 50), (1, 3, 33, 8),
             (2, 2, 321, 64), (1, 2, 65, 40)]


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
    """The y launch runs every 64-step chunk of every head in parallel, a
    block of 128 threads each: 4096 blocks at the rwkv6-1.6b prefill
    shape (B=4, H=32, T=2048)."""
    assert wkv_ops.launch_shape(4, 32, 2048, 64) == (4096, 128)
    assert wkv_ops.launch_shape(1, 2, 1, 16) == (2, 128)
    assert wkv_ops.launch_shape(2, 2, 321, 50) == (24, 128)


def _frames(cfg, B, device, F=24, seed=0):
    """An enc-dec model's (B, F, d) frame embeddings (0.02 N(0, 1), the
    reference drivers' draw), else None."""
    if cfg.layout != "encdec":
        return None
    return torch.tensor((0.02 * np.random.default_rng(seed).standard_normal(
        (B, F, cfg.d_model))).astype(np.float32), device=device)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_prefill_and_decode_through_kernels(cuda, arch):
    """A reduced-config prefill launches the flash kernel once per
    attention layer (whisper: once per encoder layer, twice per decoder
    layer) and the wkv kernel once per RWKV layer (a Mamba layer
    neither), decode launches neither, and logits and caches match the
    same model run through the plain versions (``plain_kernels=True``) at
    1e-4, over a prefill and 4 teacher-forced decode steps."""
    cfg = get_config(arch).reduced()
    params = M.init_lm(cfg, 0, device=cuda)
    ids = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                         (2, 40)),
                       device=cuda)
    frames = _frames(cfg, 2, cuda)
    P, cache_len = 36, 40
    before = (flash_attention.launches, wkv.launches)
    logits, cache, _ = M.forward(cfg, params, ids[:, :P], frames,
                                 want_cache=True, cache_len=cache_len)
    torch.cuda.synchronize()
    want = (ST.attention_calls(cfg), _layer_kinds(cfg).count("rwkv"))
    assert (flash_attention.launches - before[0],
            wkv.launches - before[1]) == want
    plain, pcache, _ = M.forward(cfg, params, ids[:, :P], frames,
                                 want_cache=True, cache_len=cache_len,
                                 plain_kernels=True)
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
    batch = {"tokens": ids[:, :P]}
    if frames is not None:
        batch["frames"] = frames
    tok, cache = prefill(params, batch)
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


@pytest.mark.parametrize("causal,win", [(False, 0), (True, 0), (True, 40)])
def test_flash_backward_ignores_a_common_key_component(cuda, causal, win):
    """Every key plus one vector c (30 times the keys' rms row norm) moves
    no gradient analytically: the kernel's dq, dk and dv stay within 1e-4
    of an f64 autograd step on the same f32 inputs, and its dk summed
    over the keys (a key bias's gradient, zero analytically) within 1e-5
    of the f64 dk's largest entry."""
    B, H, KV, Sq, Skv, dh = 2, 4, 2, 96, 160, 64
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=cuda) for n, s in ((H, Sq), (KV, Skv),
                                               (KV, Skv), (H, Sq)))
    u = rng.standard_normal(dh)
    c = torch.tensor(30 * u / np.linalg.norm(u), dtype=torch.float32,
                     device=cuda) * k.square().sum(-1).mean().sqrt()
    if causal:
        q, do = q[:, :, :Skv // 2], do[:, :, :Skv // 2]
        k, v = k[:, :, :Skv // 2], v[:, :, :Skv // 2]
    xs = [t.clone().requires_grad_() for t in (q, k + c, v)]
    got = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                              window=win), xs, do)
    x64 = [t.detach().double().requires_grad_() for t in xs]
    ref = torch.autograd.grad(_attention_f64(*x64, causal, win), x64,
                              do.double())
    for g, r in zip(got, ref):
        assert ((g.double() - r).abs().max() / r.abs().max()).item() < 1e-4
    key_sum = (got[1].double().sum(2).abs().max() / ref[1].abs().max())
    assert key_sum.item() < 1e-5


def _attention_f64(q, k, v, causal, window):
    """softmax(q kᵀ / sqrt(dh) + mask) v in f64, GQA by repeating k, v."""
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = (q @ k.mT) * q.shape[-1] ** -0.5
    i = torch.arange(q.shape[2], device=q.device)[:, None]
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    live = torch.ones_like(s, dtype=torch.bool)
    if causal:
        live = live & (j <= i)
    if window:
        live = live & (j > i - window)
    return torch.softmax(s.masked_fill(~live, float("-inf")), -1) @ v


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
    """The model's (B, S, heads, dh) transposed views, rows that do not
    start on 16 bytes (per-element loads in wkv's backward; the flash
    backward's wrapper copies them for TMA), or a stride of 2 over dh
    (copied by every wrapper), of the same values."""
    if layout == "transposed":
        return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]
    if layout == "strided":
        return [torch.stack([t, t], -1)[..., 0] for t in ts]
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


# dk below 64 (dk not a multiple of 4), T off the 8-step sub-chunks, the
# 16-step checkpoints and the 64-step chunk (T < 8, one chunk, several
# with a ragged last one of 1 and of 9 steps). (B, H, T, dk)
WKV_BWD_EDGES = [(2, 2, 37, 40), (1, 3, 23, 24), (2, 2, 7, 64),
                 (1, 2, 49, 33), (1, 1, 25, 16), (1, 2, 129, 64),
                 (2, 1, 201, 24)]


@pytest.mark.parametrize("B,H,T,dk", WKV_BWD_EDGES)
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "unaligned"])
def test_wkv_backward_kernel_tiling_edges(cuda, B, H, T, dk, layout):
    """dr, dk, dv, dw, du at the chunks' and sub-chunks' edges, with the
    first three decays of every row and those of steps 62-66 (across the
    first chunk boundary) at 1e-7 (no division by w), within 1e-4 of each
    plain gradient's largest entry; a rerun bit-equal."""
    args = _wkv_inputs(B, H, T, dk, torch.float32, cuda, seed=T + dk)
    args[3][..., :3, :] = 1e-7
    args[3][..., 62:67, :] = 1e-7
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
    """bf16 inputs that need a gradient run the backward kernels' bf16
    entries (gradients in bf16, one backward launch); mixed dtypes are
    still refused; a nonzero gradient of wkv's final state reaches the
    kernel."""
    q, k, v = _flash_inputs(1, 2, 1, 40, 32, torch.bfloat16, cuda)
    xs = [t.requires_grad_() for t in (q, k, v)]
    before = flash_attention.bwd_launches
    got = torch.autograd.grad(flash_attention(*xs).float().sum(), xs)
    assert flash_attention.bwd_launches == before + 1
    assert all(g.dtype == torch.bfloat16 and g.isfinite().all() for g in got)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(xs[0], k.detach().float(), v)
    args = _wkv_inputs(1, 2, 20, 16, torch.bfloat16, cuda)
    xs = [a.requires_grad_() for a in args]
    before = wkv.bwd_launches
    y, S = wkv(*xs)
    got = torch.autograd.grad(y.float().sum() + S.sum(), xs)
    assert wkv.bwd_launches == before + 1 and got[0].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="one dtype"):
        wkv(args[0], args[1].detach().float(), *args[2:])


# The f32 entry reads q and do by TMA: dh off a multiple of 4 is padded
# by the wrapper (all five tensors), rows TMA cannot read are copied.
# (B, H, KV, Sq, Skv, dh, window, causal, layout)
FLASH_BWD_F32_COPIED = [(1, 4, 2, 200, 200, 18, 0, True, "contiguous"),
                        (1, 4, 2, 150, 150, 98, 30, True, "transposed"),
                        (2, 2, 1, 130, 97, 37, 0, False, "unaligned"),
                        (1, 4, 2, 150, 150, 96, 30, True, "strided"),
                        (2, 4, 4, 77, 77, 61, 0, True, "strided")]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal,layout",
                         FLASH_BWD_F32_COPIED)
def test_flash_backward_f32_takes_padded_and_copied_operands(
        cuda, B, H, KV, Sq, Skv, dh, win, causal, layout):
    """The f32 entry through ``FlashAttention`` on operands the wrapper
    pads (dh off a multiple of 4) or copies (rows off 16 bytes, a stride
    over dh): dq, dk, dv within 1e-4 of each plain gradient's largest
    entry, and a rerun bit-equal."""
    rng = np.random.default_rng(Sq + dh + 2)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=cuda) for n, s in ((H, Sq), (KV, Skv),
                                               (KV, Skv), (H, Sq)))
    *qkv, do = _bwd_layout([q, k, v, do], layout)
    xs = [t.detach().requires_grad_() for t in qkv]
    got = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                              window=win), xs, do)
    xr = [t.detach().clone().requires_grad_() for t in qkv]
    ref = torch.autograd.grad(attention_ref(*xr, causal=causal, window=win),
                              xr, do)
    _rel_grads_close(got, ref)
    again = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                                window=win), xs, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_backward_f32_entry_refuses_what_tma_cannot_read(cuda):
    """Called directly, the f32 entry refuses dh off a multiple of 4
    (invalid value) and a row of q or do off 16 bytes (misaligned
    address): the wrapper makes such inputs legal first, so a model never
    meets it."""
    import ctypes
    B, H, S, dh = 1, 2, 64, 64
    x = torch.zeros((B, H, S, dh + 4), dtype=torch.float32, device=cuda)
    lse = torch.zeros((B, H, S), dtype=torch.float32, device=cuda)
    scratch = torch.zeros(1 << 20, dtype=torch.float32, device=cuda)
    outs = [torch.empty((B, H, S, dh), dtype=torch.float32, device=cuda)
            for _ in range(3)]
    fn = flash_ops.BWD_LIB.load().flash_attention_bwd_f32

    def call(t, d):
        strides = (ctypes.c_longlong * 15)(*(list(t.stride()[:3]) * 5))
        return fn(*(t.data_ptr() for _ in range(5)), lse.data_ptr(),
                  *(o.data_ptr() for o in outs), scratch.data_ptr(), B, H,
                  H, S, S, d, strides, 1, 0, 0.18, 0.125,
                  torch.cuda.current_stream().cuda_stream)
    assert call(x, dh) == 0
    torch.cuda.synchronize()
    assert call(x, 62) == 1                  # cudaErrorInvalidValue
    assert call(x[..., 1:], dh) == 716       # cudaErrorMisalignedAddress


def _within_bounds(got, ref, bounds):
    for g, r, b in zip(got, ref, bounds):
        assert g.dtype == r.dtype
        assert ((g.float() - r.float()).abs() <= b).all(), (
            ((g.float() - r.float()).abs() / b).max().item())


# The bf16 entry reads q, k, v and do by TMA: dh off a multiple of 8 is
# padded by the wrapper (all five tensors), rows TMA cannot read are
# copied. (B, H, KV, Sq, Skv, dh, window, causal, layout)
FLASH_BWD_BF16_COPIED = [(1, 4, 2, 200, 200, 20, 0, True, "contiguous"),
                         (1, 4, 2, 150, 150, 100, 30, True, "transposed"),
                         (2, 2, 1, 130, 97, 36, 0, False, "unaligned"),
                         (1, 4, 2, 150, 150, 96, 30, True, "strided"),
                         (2, 4, 4, 77, 77, 61, 0, True, "strided")]


@pytest.mark.parametrize("B,H,KV,Sq,Skv,dh,win,causal,layout",
                         [s + ("contiguous",) for s in FLASH_BWD_SHAPES]
                         + [s + (lay,) for s in FLASH_BWD_EDGES
                            for lay in ("transposed", "unaligned")]
                         + FLASH_BWD_BF16_COPIED)
def test_flash_backward_bf16_within_its_bound(cuda, B, H, KV, Sq, Skv, dh,
                                              win, causal, layout):
    """The bf16 entry of the flash backward kernel (through
    ``FlashAttention``) against autograd through ``attention_ref`` on the
    same bf16 inputs, every element of dq, dk, dv within
    ``ops.bf16_grad_error_bound``; a rerun bit-equal."""
    rng = np.random.default_rng(Sq + dh + 1)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=cuda).to(torch.bfloat16)
        for n, s in ((H, Sq), (KV, Skv), (KV, Skv), (H, Sq)))
    *qkv, do = _bwd_layout([q, k, v, do], layout)
    xs = [t.detach().requires_grad_() for t in qkv]
    got = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                              window=win), xs, do)
    xr = [t.detach().clone().requires_grad_() for t in qkv]
    ref = torch.autograd.grad(attention_ref(*xr, causal=causal, window=win),
                              xr, do)
    _within_bounds(got, ref, flash_ops.bf16_grad_error_bound(
        *qkv, do, ref, causal=causal, window=win))
    again = torch.autograd.grad(flash_attention(*xs, causal=causal,
                                                window=win), xs, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_backward_bf16_entry_refuses_what_tma_cannot_read(cuda):
    """Called directly, the bf16 entry refuses dh off a multiple of 8
    (invalid value) and a row off 16 bytes (misaligned address): the
    wrapper makes such inputs legal first, so a model never meets it."""
    import ctypes
    B, H, S, dh = 1, 2, 64, 64
    x = torch.zeros((B, H, S, dh + 8), dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((B, H, S), dtype=torch.float32, device=cuda)
    scratch = torch.zeros(1 << 20, dtype=torch.float32, device=cuda)
    outs = [torch.empty((B, H, S, dh), dtype=torch.bfloat16, device=cuda)
            for _ in range(3)]
    fn = flash_ops.BWD_LIB.load().flash_attention_bwd_bf16

    def call(t, d):
        strides = (ctypes.c_longlong * 15)(*(list(t.stride()[:3]) * 5))
        return fn(*(t.data_ptr() for _ in range(5)), lse.data_ptr(),
                  *(o.data_ptr() for o in outs), scratch.data_ptr(), B, H,
                  H, S, S, d, strides, 1, 0, 0.18, 0.125,
                  torch.cuda.current_stream().cuda_stream)
    assert call(x, dh) == 0
    torch.cuda.synchronize()
    assert call(x, 60) == 1                  # cudaErrorInvalidValue
    assert call(x[..., 1:], dh) == 716       # cudaErrorMisalignedAddress


def _wkv_bwd_case(B, H, T, dk, dtype, device, layout="contiguous"):
    args = _wkv_inputs(B, H, T, dk, dtype, device, seed=T + dk + 1)
    rng = np.random.default_rng(T)
    dy = torch.tensor(rng.standard_normal((B, H, T, dk)).astype(np.float32),
                      device=device).to(dtype)
    dS = torch.tensor(rng.standard_normal((B, H, dk, dk)).astype(np.float32),
                      device=device)
    *rkvw, dy = _bwd_layout(args[:4] + [dy], layout)
    return rkvw + [args[4]], dy, dS


@pytest.mark.parametrize("B,H,T,dk", WKV_BWD_EDGES)
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "unaligned"])
def test_wkv_backward_bf16_within_its_bound(cuda, B, H, T, dk, layout):
    """The bf16 entry of the wkv backward kernel against autograd through
    ``wkv_ref`` on the same bf16 inputs: dr, dk, dv, dw within
    ``ops.bf16_grad_error_bound``, du (f32) within 1e-4 of its largest
    entry; a rerun bit-equal."""
    args, dy, _ = _wkv_bwd_case(B, H, T, dk, torch.bfloat16, cuda, layout)
    xs = [a.detach().requires_grad_() for a in args]
    got = torch.autograd.grad(wkv(*xs)[0], xs, dy)
    xr = [a.detach().clone().requires_grad_() for a in args]
    ref = torch.autograd.grad(wkv_ref(*xr)[0], xr, dy)
    _within_bounds(got[:4], ref[:4], wkv_ops.bf16_grad_error_bound(ref[:4]))
    _rel_grads_close(got[4:], ref[4:])
    again = torch.autograd.grad(wkv(*xs)[0], xs, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,H,T,dk", WKV_BWD_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_backward_takes_the_final_state_gradient(cuda, B, H, T, dk,
                                                     dtype):
    """Cotangents on y and on the final state S (the reference
    differentiates its scan through S): the kernel's gradients against
    autograd through ``wkv_ref`` with the same two cotangents, within
    1e-4 of each gradient's largest entry in f32, within
    ``ops.bf16_grad_error_bound`` in bf16 (du at 1e-4)."""
    args, dy, dS = _wkv_bwd_case(B, H, T, dk, dtype, cuda)
    xs = [a.detach().requires_grad_() for a in args]
    got = torch.autograd.grad(wkv(*xs), xs, (dy, dS))
    xr = [a.detach().clone().requires_grad_() for a in args]
    ref = torch.autograd.grad(wkv_ref(*xr), xr, (dy, dS))
    if dtype == torch.float32:
        _rel_grads_close(got, ref)
    else:
        _within_bounds(got[:4], ref[:4],
                       wkv_ops.bf16_grad_error_bound(ref[:4]))
        _rel_grads_close(got[4:], ref[4:])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_train_step_through_kernels_matches_plain(cuda, arch):
    """A reduced-config train step with remat through the kernels: 2L
    forward and L backward launches of the layer's kernel (L the layers
    of its kind; for flash, its call sites: whisper's encoder layers and
    its decoder layers twice), the loss and
    every gradient within 1e-4 of the plain versions' (each tensor's
    largest entry; a key bias's without RoPE, zero analytically, within
    1e-6 of the step's largest entry of zero in both), and the step's
    parameters finite."""
    from repro_torch import flags
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    cfg = get_config(arch).reduced()
    params = M.init_lm(cfg, 0, device=cuda)
    ids = np.random.default_rng(1).integers(0, cfg.vocab, (2, 65))
    batch = {"tokens": torch.tensor(ids[:, :-1], device=cuda),
             "labels": torch.tensor(ids[:, 1:], device=cuda)}
    if cfg.layout == "encdec":
        batch["frames"] = _frames(cfg, 2, cuda)
    flags.set_flags(chunked_ce=16)
    try:
        kernel = flash_attention if cfg.attn is not None else wkv
        before = (kernel.launches, kernel.bwd_launches)
        (lk, _), gk = loss_and_grads(cfg, params, batch, remat=True)
        L = (ST.attention_calls(cfg) if cfg.attn is not None
             else _layer_kinds(cfg).count("rwkv"))
        assert (kernel.launches - before[0],
                kernel.bwd_launches - before[1]) == (2 * L, L)
        (lp, _), gp = loss_and_grads(cfg, params, batch, remat=True,
                                     plain_kernels=True)
        assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
        # a key projection's bias without RoPE (whisper's layers) moves a
        # whole logit row, which softmax ignores: its gradient is zero but
        # for f32 rounding in both paths, so it is held to zero, within
        # 1e-6 of the step's largest gradient entry. With RoPE (qwen2-72b,
        # qwen1.5-32b) each position rotates the bias differently, and its
        # gradient is held against the plain one as every other tensor's.
        names = _leaf_names(gp)
        largest = max(g.abs().max().item() for g in _leaf_list(gp))
        pairs = list(zip(names, _leaf_list(gk), _leaf_list(gp)))
        zero = [cfg.layout == "encdec" and n.endswith(".wk.b")
                for n, _, _ in pairs]
        for (name, a, b), z in zip(pairs, zero):
            if z:
                assert max(a.abs().max().item(),
                           b.abs().max().item()) <= 1e-6 * largest, name
        _rel_grads_close([a for (_, a, _), z in zip(pairs, zero) if not z],
                         [b for (_, _, b), z in zip(pairs, zero) if not z])
        step, opt = make_train_step(cfg, lr=1e-3, remat=True)
        new, _, m = step(params, opt.init(params), batch)
        assert all(torch.isfinite(t).all() for t in _leaf_list(new))
        assert abs(m["loss"].item() - lk.item()) <= 1e-6 * abs(lk.item())
    finally:
        flags.set_flags(chunked_ce=0)


def _layer_kinds(cfg):
    """Every layer's kind ('attn', 'mamba', 'rwkv'), in order."""
    return [k[0] for _, reps, body in ST.build_segments(cfg)
            for k in body for _ in range(reps)]


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}.{k}".lstrip("."))]
    return [prefix]


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_list(v)]
    return [tree]


# Whisper's calls at test size: the encoder's non-causal self-attention
# and the cross-attention (Sq != Skv, both ways), dh = 64, MHA; Skv ragged
# (off the forward's kv tiles of 32 / 64 and the backward's key blocks of
# 128), in f32 and (forward) bf16. (B, H, KV, Sq, Skv)
WHISPER_CALLS = [(2, 4, 4, 150, 150), (2, 4, 4, 45, 150), (1, 6, 6, 300, 97),
                 (1, 4, 4, 448, 1500)]


@pytest.mark.parametrize("B,H,KV,Sq,Skv", WHISPER_CALLS)
def test_flash_non_causal_whisper_calls_match_plain(cuda, B, H, KV, Sq, Skv):
    """The forward (f32 within 1e-5, bf16 within ``bf16_error_bound``) and
    the backward (dq, dk, dv within 1e-4 of each plain gradient's largest
    entry, a rerun bit-equal), non-causal, at ragged Skv and Sq != Skv
    with dh = 64, against the plain version."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, 64)).astype(
        np.float32), device=cuda) for n, s in ((H, Sq), (KV, Skv),
                                               (KV, Skv), (H, Sq)))
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (q, k, v)]
        _assert_flash_matches(flash_attention(*args, causal=False), *args,
                              False, 0)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*xs, causal=False), xs, do)
    xr = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(attention_ref(*xr, causal=False), xr, do)
    _rel_grads_close(got, ref)
    again = torch.autograd.grad(flash_attention(*xs, causal=False), xs, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_kernel_gives_fully_masked_rows_zero(cuda):
    """A non-causal windowed call with Sq > Skv + window − 1: the rows that
    see no key get o = 0 from the kernel, as the reference's Pallas kernel
    gives them, and no gradient (dq zero there, dk and dv those of the
    call with those rows' output gradient zeroed); the other rows match
    the plain version."""
    Sq, Skv, win = 96, 40, 16
    q, k, v = (torch.tensor(np.random.default_rng(s).standard_normal(
        (1, n, L, 32)).astype(np.float32), device=cuda)
        for s, n, L in ((0, 4, Sq), (1, 2, Skv), (2, 2, Skv)))
    dead = torch.arange(Sq, device=cuda) >= Skv + win - 1
    o = flash_attention(q, k, v, causal=False, window=win)
    assert (o[:, :, dead] == 0).all()
    o_ref = attention_ref(q, k, v, causal=False, window=win)
    torch.testing.assert_close(o[:, :, ~dead], o_ref[:, :, ~dead],
                               atol=FLASH_F32_ERR_MAX, rtol=0)
    do = torch.randn_like(o)
    grads = []
    for g in (do, torch.where(dead[:, None], 0.0, do)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*xs, causal=False, window=win).backward(g)
        grads.append([x.grad for x in xs])
    assert (grads[0][0][:, :, dead] == 0).all()
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)


def _moe_setup(device, T=4096, d=256, E=16, k=2, seed=0):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    m = MoEConfig(n_experts=E, top_k=k, n_shared=1, d_expert=128,
                  capacity_factor=0.5)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = moe.init_moe(L.Init(gen, device=device), d, m, 512, "swiglu")
    x = torch.randn((4, T // 4, d), generator=gen, device=device)
    return moe, m, p, x


def test_moe_forward_and_backward_bit_equal_on_rerun(cuda):
    """The MoE FFN on the card (sort, gathers, batched GEMMs, the combine
    summed over k in order; no float atomics): two runs give the same
    output, losses and gradients bit for bit, with tokens dropped."""
    moe, m, p, x = _moe_setup(cuda)
    runs = []
    for _ in range(2):
        leaves = {n: t.clone().requires_grad_() for n, t in
                  (("router", p["router"]["w"]), ("wg", p["wg"]),
                   ("wu", p["wu"]), ("wd", p["wd"]))}
        xx = x.clone().requires_grad_()
        q = dict(p, router={"w": leaves["router"]}, wg=leaves["wg"],
                 wu=leaves["wu"], wd=leaves["wd"])
        y, lb, z = moe.moe_apply(q, xx, m, "swiglu")
        (y.square().sum() + lb + z).backward()
        runs.append([y, lb, z, xx.grad] + [t.grad for t in leaves.values()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    tok_idx, _ = moe.dispatch_indices(
        moe.route(p, x.reshape(-1, x.shape[-1]), m)[1], x.shape[0]
        * x.shape[1], m)
    T = x.shape[0] * x.shape[1]
    assert 0 < int((tok_idx < T).sum()) < 2 * T       # some tokens dropped


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-scout-17b-a16e",
                                  "jamba-1.5-large-398b"])
def test_reduced_moe_and_hybrid_forward_on_card_match_cpu(cuda, arch):
    """A reduced MoE / hybrid arch on the card (flash attention through
    the kernel; MoE and Mamba in plain PyTorch) against the port on the
    CPU, same parameters and ids: logits and the auxiliary losses within
    1e-4 of the largest entry; flash launched once per attention layer."""
    cfg = get_config(arch).reduced()
    params = M.init_lm(cfg, 0, device="cpu")
    ids = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    with torch.no_grad():
        ref, _, ref_aux = M.forward(cfg, params, torch.tensor(ids))
        on_card = _tree_to(params, cuda)
        before = flash_ops.flash_attention.launches
        got, _, aux = M.forward(cfg, on_card, torch.tensor(ids, device=cuda))
    assert (flash_ops.flash_attention.launches - before
            == _layer_kinds(cfg).count("attn"))
    scale = ref.abs().max()
    assert ((got.cpu() - ref).abs().max() / scale).item() <= 1e-4
    for key in ("lb", "z"):
        assert abs(aux[key].item() - ref_aux[key].item()) <= 1e-4 * max(
            1.0, abs(ref_aux[key].item()))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------- gemma3-27b's bf16 pieces
@pytest.mark.parametrize("tied", [False, True])
def test_bf16_logits_accumulate_in_f32_on_card(cuda, tied):
    """The untied head's and the tied unembedding's logits from bf16
    operands on the card (``layers.matmul_acc``: ``torch.mm(...,
    out_dtype=f32)``, no f32 copy of the head): f32, within f32
    summation order of the product of f32 copies (exact products), where
    the bf16-rounded product is off by a bf16 ulp."""
    resolve_device(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 3, 512, generator=g, device=cuda).bfloat16()
    w = (0.05 * torch.randn(512, 4096, generator=g,
                            device=cuda)).bfloat16()
    cfg = dataclasses.replace(get_config("gemma3-27b").reduced(),
                              tie_embeddings=tied)
    params = ({"embed": {"table": w.mT.contiguous()}} if tied
              else {"head": {"w": w}})
    got = M._logits(cfg, params, x)
    ref = x.float() @ w.float()
    assert got.dtype == torch.float32 and got.shape == (4, 3, 4096)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
    assert (x @ w).float().sub(ref).abs().max().item() > 10 * err


def test_windowed_bf16_flash_call_inside_full_attention(cuda, monkeypatch):
    """gemma3-27b's local-layer attention at full width (d_model 5376,
    H=32, KV=16, dh=128, window 1024) on 2048 positions in bf16
    (B=1): ``full_attention`` makes one windowed flash launch on the
    bf16 projections, within ``bf16_error_bound`` of ``attention_ref``
    on those inputs per element."""
    cfg = get_config("gemma3-27b")
    a = cfg.attn
    gen = torch.Generator(device=cuda).manual_seed(0)
    init = L.Init(gen, torch.bfloat16, torch.device(cuda))
    p = A.init_attn(init, cfg.d_model, a)
    x = torch.randn(1, 2048, cfg.d_model, generator=gen,
                    device=cuda).bfloat16()
    positions = torch.arange(2048, device=cuda)[None]
    seen = {}

    def call(q, k, v, causal=True, window=0):
        o = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
        seen.update(q=q, k=k, v=v, o=o, causal=causal, window=window)
        return o

    monkeypatch.setattr(A, "FA", SimpleNamespace(flash_attention=call))
    before = flash_attention.launches
    with torch.no_grad():
        y, _ = A.full_attention(p, a, x, positions, window=a.window)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 1
    assert (seen["window"], seen["causal"]) == (1024, True)
    q, k, v, o = (seen[n] for n in "qkvo")
    assert q.dtype == torch.bfloat16 and q.shape == (1, 32, 2048, 128)
    o_ref = attention_ref(q, k, v, causal=True, window=1024)
    bound = flash_ops.bf16_error_bound(q, k, v, o_ref, causal=True,
                                       window=1024)
    assert ((o.float() - o_ref.float()).abs() <= bound).all()
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())


def test_ring_cache_across_the_window_matches_plain(cuda):
    """gemma3-27b's reduced config in f32 (a local layer of window 8, then
    a global one): after a prefill of 12 ids (the local cache a ring of 8
    slots) and after each of 4 decode steps that wrap it, the kernel
    path's caches equal the plain path's (``plain_kernels=True``) at
    1e-4, and each ring slot of the first layer holds the key of the
    position ``models.attention._slot_positions`` gives (that layer's key
    of a position depends on its token only)."""
    cfg = get_config("gemma3-27b").reduced()
    params = M.init_lm(cfg, 0, device=cuda)
    ids = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                         (2, 16)),
                       device=cuda)
    P, cache_len = 12, 16
    (name, _, kinds), = ST.build_segments(cfg)[:1]
    assert kinds[0][0] == "attn" and kinds[0][2] == 8
    with torch.no_grad():
        _, ck, _ = M.forward(cfg, params, ids[:, :P], want_cache=True,
                             cache_len=cache_len)
        _, cp, _ = M.forward(cfg, params, ids[:, :P], want_cache=True,
                             cache_len=cache_len, plain_kernels=True)
        p0 = ST._index(params["segments"][name], 0)["s0"]
        h = L.rmsnorm(p0["ln1"], L.embed(params["embed"], ids))
        keys, _ = A._project_kv(p0["attn"], cfg.attn, h,
                                torch.arange(16, device=cuda)[None])
        for pos in range(P - 1, cache_len):
            if pos >= P:
                tok = ids[:, pos:pos + 1]
                M.decode_step(cfg, params, tok, ck, pos, cache_len)
                M.decode_step(cfg, params, tok, cp, pos, cache_len)
            for (n, a), (_, b) in zip(_leaves(ck), _leaves(cp)):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                           msg=f"{n} at {pos}")
            ring = ck[name]["s0"]["k"][0]
            assert ring.shape[1] == 8
            spos = A._slot_positions(pos, 8, True, cuda)
            assert int(spos.min()) == pos - 7 and int(spos.max()) == pos
            torch.testing.assert_close(ring, keys[:, spos], atol=1e-5,
                                       rtol=1e-5)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}".lstrip("."))
    else:
        yield prefix, tree
