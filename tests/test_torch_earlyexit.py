"""Convergence-adaptive depth in the port, against itself and against the
reference on the CPU: exit_threshold=0 parity with the fixed-L forward,
min_layers flooring, threshold monotonicity, evaluator build economy,
cache-key anatomy, batched-serve parity against the solo adaptive solve
(the port against itself, and the port's server against the
reference's with ``mix=None`` and ``"pallas"`` in interpret mode, on the
reference's draws), probe-pad inertness, and the depth telemetry.

A SMOKE model meta-trained by the reference (8 steps) is shared
module-wide; the port gets its θ through ``theta_from_numpy`` and the
reference's draws through numpy.

Tolerances (the reference's, ``tests/test_earlyexit.py``): W 1e-5
relative / 1e-6 absolute against the reference's unroll; served loss and
accuracy 1e-5 (dense) and 5e-5 (pallas) against the reference's server;
depth exactly. Within the port, on one device, threshold 0 is bit-equal
to the fixed path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs.surf_paper import SMOKE as JSMOKE
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic
from repro.serve import Bucket as JBucket
from repro.serve import BucketSpec as JBucketSpec
from repro.serve import FederationServer as JServer
from repro.serve import ServeMetrics as JServeMetrics
from repro.serve import pad_probe as jpad_probe
from repro_torch import cache_stats
from repro_torch import engine as E
from repro_torch.checkpoint.convert import theta_from_numpy
from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import TrainState
from repro_torch.serve import (Bucket, BucketSpec, FederationServer,
                               ServeMetrics, pad_probe, serve_cache_key)

BUCKETS = BucketSpec(agent_sizes=(8, 16), row_sizes=(4, 8))
# exact-fit and padded cohorts, over two buckets
SERVED = [(8, 0), (6, 1), (8, 2), (12, 3)]


@pytest.fixture(scope="module")
def trained():
    mds = synthetic.make_meta_dataset(JSMOKE, 3, seed=0)
    state, _, S = jsurf.train_surf(JSMOKE, mds, steps=8, seed=0,
                                   log_every=0)
    theta = theta_from_numpy(jax.tree.map(np.asarray, state.theta), "cpu")
    return state, theta, np.asarray(S)


def _cfgs(**kw):
    return (dataclasses.replace(JSMOKE, **kw),
            dataclasses.replace(SMOKE, **kw))


def _cohort(n, t, seed, **kw):
    jcfg, tcfg = _cfgs(n_agents=n, test_per_agent=t, **kw)
    _, S = jsurf.make_problem(jcfg, seed=seed)
    return jcfg, tcfg, np.asarray(S), synthetic.sample_dataset(
        jcfg, seed=1000 + seed)


def _draws(jcfg, ds, seed, q=0):
    """The reference's draws for the solve of (seed, q), as numpy."""
    key = jax.random.fold_in(jax.random.PRNGKey(1000 + seed), q)
    batch = {k: jnp.asarray(v) for k, v in ds.items()}
    return tuple(np.asarray(a) for a in JU.featurize_cohort(key, batch,
                                                            jcfg))


def _unrolled(trained, jcfg, tcfg, seed=3):
    """Both packages' inputs for one unroll on the same draws."""
    _, theta, S = trained
    ds = synthetic.sample_dataset(jcfg, seed=500)
    W0, Xl, Yl = _draws(jcfg, ds, seed)
    batch = resolve_task(tcfg).to_batch(ds, "cpu")
    Xp, Yp = U.probe_batch(batch, tcfg)
    return (theta, torch.tensor(S), torch.tensor(W0), torch.tensor(Xl),
            torch.tensor(Yl).long(), Xp, Yp), (W0, Xl, Yl, ds)


# ------------------------------------------------------- unroll parity
def test_threshold_zero_runs_all_layers_and_matches_fixed(trained):
    """exit_threshold=0 disables the exit: depth == L, W_L bit-equal to
    the port's ``udgd_forward`` and within the reference's tolerance of
    its ``udgd_forward_adaptive`` on the same draws."""
    state, _, S = trained
    jcfg, tcfg = _cfgs()
    (theta, St, W0, Xl, Yl, Xp, Yp), (jW0, jXl, jYl, ds) = _unrolled(
        trained, jcfg, tcfg)
    W_fix, _ = U.udgd_forward(theta, St, W0, Xl, Yl, tcfg)
    W_ad, depth = U.udgd_forward_adaptive(theta, St, W0, Xl, Yl, Xp, Yp,
                                          tcfg)
    assert depth == tcfg.n_layers
    assert torch.equal(W_ad, W_fix)
    jXp, jYp = JU.probe_batch({k: jnp.asarray(v) for k, v in ds.items()},
                              jcfg)
    jW, jdepth = JU.udgd_forward_adaptive(state.theta, jnp.asarray(S), jW0,
                                          jXl, jYl, jXp, jYp, jcfg)
    assert int(jdepth) == depth
    np.testing.assert_allclose(W_ad.numpy(), np.asarray(jW), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("thr,min_layers", [(10.0, 2), (10.0, 1), (0.1, 1),
                                            (0.01, 1)])
def test_adaptive_unroll_matches_reference(trained, thr, min_layers):
    """Depth exactly and W within the reference's tolerance, at exits
    early, late and at the floor."""
    state, _, S = trained
    jcfg, tcfg = _cfgs(exit_threshold=thr, min_layers=min_layers)
    (theta, St, W0, Xl, Yl, Xp, Yp), (jW0, jXl, jYl, ds) = _unrolled(
        trained, jcfg, tcfg)
    W, depth = U.udgd_forward_adaptive(theta, St, W0, Xl, Yl, Xp, Yp, tcfg)
    jXp, jYp = JU.probe_batch({k: jnp.asarray(v) for k, v in ds.items()},
                              jcfg)
    jW, jdepth = JU.udgd_forward_adaptive(state.theta, jnp.asarray(S), jW0,
                                          jXl, jYl, jXp, jYp, jcfg)
    assert depth == int(jdepth)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=1e-5,
                               atol=1e-6)


def test_huge_threshold_exits_at_min_layers(trained):
    """1 - thr < 0 makes the certificate fire on ANY ratio — the floor
    is min_layers exactly."""
    jcfg, tcfg = _cfgs(exit_threshold=10.0, min_layers=2)
    (theta, St, W0, Xl, Yl, Xp, Yp), _ = _unrolled(trained, jcfg, tcfg)
    _, depth = U.udgd_forward_adaptive(theta, St, W0, Xl, Yl, Xp, Yp, tcfg)
    assert depth == 2


def test_depth_weakly_decreases_in_threshold(trained):
    """The W trajectory is threshold-independent up to the exit point,
    so a larger threshold can only fire earlier or at the same layer."""
    depths = []
    for thr in [0.01, 0.1, 10.0]:
        jcfg, tcfg = _cfgs(exit_threshold=thr, min_layers=1)
        (theta, St, W0, Xl, Yl, Xp, Yp), _ = _unrolled(trained, jcfg, tcfg)
        depths.append(U.udgd_forward_adaptive(theta, St, W0, Xl, Yl, Xp, Yp,
                                              tcfg)[1])
    assert depths == sorted(depths, reverse=True)
    assert depths[-1] == 1


# --------------------------------------------------- evaluate_surf path
def test_evaluate_surf_adaptive_thr0_matches_fixed_final_row(trained):
    state, theta, S = trained
    jcfg, tcfg = _cfgs()
    pool = synthetic.make_meta_dataset(jcfg, 3, seed=9)
    draws = [_draws(jcfg, d, 5, q) for q, d in enumerate(pool)]
    kw = dict(seed=5, device="cpu", draws=draws)
    fixed = surf.evaluate_surf(tcfg, TrainState(theta), S, pool, **kw)
    r = surf.evaluate_surf(tcfg, TrainState(theta), S, pool,
                           depth="adaptive", **kw)
    assert r["depth"] == float(tcfg.n_layers)
    assert "loss_per_layer" not in r
    for k in ("final_loss", "final_acc"):
        assert np.array_equal(r[k], fixed[k])
    ref = jsurf.evaluate_surf(jcfg, state, S, pool, seed=5,
                              depth="adaptive")
    assert ref["depth"] == r["depth"]
    for k in ("final_loss", "final_acc"):
        np.testing.assert_allclose(r[k], ref[k], rtol=1e-5, atol=1e-5)


def test_evaluate_surf_adaptive_matches_reference_over_seeds(trained):
    """Depth averaged over the datasets and the seed batch, against the
    reference on its draws (one ``seed=`` call per seed row)."""
    state, theta, S = trained
    jcfg, tcfg = _cfgs(exit_threshold=0.1, min_layers=1)
    pool = synthetic.make_meta_dataset(jcfg, 3, seed=12)
    ref = jsurf.evaluate_surf(jcfg, state, S, pool, seeds=[0, 1],
                              depth="adaptive")
    for i, s in enumerate((0, 1)):
        r = surf.evaluate_surf(
            tcfg, TrainState(theta), S, pool, seed=s, device="cpu",
            depth="adaptive",
            draws=[_draws(jcfg, d, s, q) for q, d in enumerate(pool)])
        assert r["depth"] == ref["depth"][i]
        for k in ("final_loss", "final_acc"):
            np.testing.assert_allclose(r[k], ref[k][i], rtol=1e-5,
                                       atol=1e-5)


def test_solve_federation_adaptive_matches_reference(trained):
    """The single-cohort adaptive solve, the adaptive serve path's
    reference, on the reference's draws: depth exactly."""
    state, theta, _ = trained
    for thr, seed in ((0.2, 0), (0.05, 1), (10.0, 2)):
        jcfg_r, tcfg_r, S, ds = _cohort(12, 4, 80 + seed,
                                        exit_threshold=thr, min_layers=2)
        ref = jsurf.solve_federation(jcfg_r, state, S, ds, seed=seed,
                                     depth="adaptive")
        res = surf.solve_federation(tcfg_r, TrainState(theta), S, ds,
                                    seed=seed, device="cpu",
                                    depth="adaptive",
                                    draws=_draws(jcfg_r, ds, seed))
        assert res["depth"] == ref["depth"]
        for k in ("final_loss", "final_acc"):
            np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, atol=1e-5)


def _eval_builds():
    return cache_stats()["surf-eval"]["misses"]


def test_adaptive_build_economy_per_threshold(trained):
    """One evaluator build per threshold; re-evaluating (another seed)
    builds nothing, and a new threshold builds one more."""
    _, theta, S = trained
    pool = synthetic.make_meta_dataset(JSMOKE, 2, seed=10)
    cfg_a = dataclasses.replace(SMOKE, exit_threshold=0.17)
    cfg_b = dataclasses.replace(SMOKE, exit_threshold=0.19)
    base = _eval_builds()
    kw = dict(depth="adaptive", device="cpu")
    surf.evaluate_surf(cfg_a, TrainState(theta), S, pool, **kw)
    surf.evaluate_surf(cfg_a, TrainState(theta), S, pool, seed=3, **kw)
    assert _eval_builds() - base == 1
    surf.evaluate_surf(cfg_b, TrainState(theta), S, pool, **kw)
    assert _eval_builds() - base == 2
    # fixed evaluators are shared across thresholds
    surf.evaluate_surf(cfg_a, TrainState(theta), S, pool, device="cpu")
    surf.evaluate_surf(cfg_b, TrainState(theta), S, pool, device="cpu")
    assert _eval_builds() - base <= 3


def test_depth_argument_validation(trained):
    _, theta, S = trained
    pool = synthetic.make_meta_dataset(JSMOKE, 2, seed=11)
    with pytest.raises(ValueError, match="depth must be one of"):
        surf.evaluate_surf(SMOKE, TrainState(theta), S, pool, depth="deep",
                           device="cpu")
    bad = dataclasses.replace(SMOKE, min_layers=SMOKE.n_layers + 1)
    with pytest.raises(ValueError, match="min_layers"):
        surf.evaluate_surf(bad, TrainState(theta), S, pool,
                           depth="adaptive", device="cpu")


# ------------------------------------------------------- cache anatomy
def test_fixed_engine_keys_ignore_exit_fields():
    """Threshold sweeps share the fixed-depth bodies: the key normalizer
    scrubs the exit knobs from cfg (as the reference's does)."""
    k0 = E._engine_cache_key(SMOKE, "eval", "relu")
    k1 = E._engine_cache_key(
        dataclasses.replace(SMOKE, exit_threshold=0.3, min_layers=2,
                            probe_size=8), "eval", "relu")
    assert k0 == k1
    assert E._engine_cache_key(dataclasses.replace(SMOKE, topology="er"),
                               "eval", "relu") == k0


def test_adaptive_variant_matches_reference():
    for kw in ({}, {"exit_threshold": 0.3, "min_layers": 3,
                    "probe_size": 6}):
        jcfg, tcfg = _cfgs(**kw)
        for base in ("eval", "serve"):
            assert (E.adaptive_variant(tcfg, base)
                    == JE.adaptive_variant(jcfg, base))


def test_adaptive_variants_key_apart_per_threshold():
    cfg_a = dataclasses.replace(SMOKE, exit_threshold=0.1)
    cfg_b = dataclasses.replace(SMOKE, exit_threshold=0.2)
    va = E.adaptive_variant(cfg_a, "eval")
    vb = E.adaptive_variant(cfg_b, "eval")
    assert va != vb
    assert (E._engine_cache_key(cfg_a, va, "relu")
            != E._engine_cache_key(cfg_b, vb, "relu"))


def test_serve_cache_key_depth_separation():
    """Fixed serve keys ignore the exit knobs; adaptive keys carry them
    in the variant (one solver per threshold)."""
    cfg_t = dataclasses.replace(SMOKE, exit_threshold=0.1)
    b = Bucket(8, 4)
    assert (serve_cache_key(cfg_t, b, 4, "relu")
            == serve_cache_key(SMOKE, b, 4, "relu"))
    ka = serve_cache_key(cfg_t, b, 4, "relu", depth="adaptive")
    kb = serve_cache_key(dataclasses.replace(SMOKE, exit_threshold=0.2),
                         b, 4, "relu", depth="adaptive")
    assert len({ka, kb, serve_cache_key(SMOKE, b, 4, "relu")}) == 3


# ------------------------------------------------------- serving parity
def _serve_both(trained, thr, min_layers, jmix, tmix):
    """The SERVED cohorts through both adaptive servers, the port's on
    the reference's draws. Returns [(tcfg, S, ds, seed, jfut, tfut)]."""
    state, theta, _ = trained
    jcfg, tcfg = _cfgs(exit_threshold=thr, min_layers=min_layers)
    jsrv = JServer(jcfg, state.theta, mix=jmix, max_batch=4,
                   buckets=JBucketSpec((8, 16), (4, 8)), depth="adaptive")
    tsrv = FederationServer(tcfg, theta, mix=tmix, buckets=BUCKETS,
                            max_batch=4, depth="adaptive", device="cpu")
    out = []
    for n, seed in SERVED:
        jcfg_r, tcfg_r, S, ds = _cohort(n, 4, 30 + seed,
                                        exit_threshold=thr,
                                        min_layers=min_layers)
        out.append((tcfg_r, S, ds, seed, jsrv.submit(S, ds, seed=seed),
                    tsrv.submit(S, ds, seed=seed,
                                draws=_draws(jcfg_r, ds, seed))))
    assert jsrv.drain() == tsrv.drain() == len(SERVED)
    assert tsrv.metrics.ticks == jsrv.metrics.ticks == 2
    return out


@pytest.mark.parametrize("jmix,tol", [(None, 1e-5), ("pallas", 5e-5)])
def test_port_adaptive_server_matches_reference_server(trained, jmix, tol):
    """Mixed easy/hard requests: each served depth equals the
    reference's served depth exactly, loss and accuracy within its
    tolerance, and depths spread at this threshold."""
    depths = []
    for *_, jf, tf in _serve_both(trained, 0.2, 1, jmix, "cuda"):
        jr, tr = jf.result(), tf.result()
        assert int(tr["depth"]) == int(jr["depth"])
        depths.append(int(tr["depth"]))
        for k in ("final_loss", "final_acc"):
            np.testing.assert_allclose(tr[k], jr[k], atol=tol, rtol=tol)
        np.testing.assert_allclose(tr["W"], jr["W"], atol=tol, rtol=tol)
    assert len(set(depths)) > 1


@pytest.mark.parametrize("mix", [None, "cuda"])
def test_batched_serve_matches_solo_adaptive_solves(trained, mix):
    """Each request batched through one early-exit loop equals its SOLO
    adaptive solve: fired requests freeze, active ones keep stepping,
    padding never flips a certificate."""
    _, theta, _ = trained
    tcfg = dataclasses.replace(SMOKE, exit_threshold=0.2, min_layers=1)
    srv = FederationServer(tcfg, theta, mix=mix, buckets=BUCKETS,
                           max_batch=4, depth="adaptive", device="cpu")
    reqs = []
    for n, seed in SERVED:
        _, tcfg_r, S, ds = _cohort(n, 4, 30 + seed, exit_threshold=0.2,
                                   min_layers=1)
        reqs.append((tcfg_r, S, ds, seed, srv.submit(S, ds, seed=seed)))
    srv.drain()
    for tcfg_r, S, ds, seed, fut in reqs:
        ref = surf.solve_federation(tcfg_r, TrainState(theta), S, ds,
                                    seed=seed, depth="adaptive",
                                    device="cpu")
        res = fut.result()
        assert int(res["depth"]) == int(ref["depth"])
        for k in ("final_loss", "final_acc"):
            np.testing.assert_allclose(res[k], ref[k], atol=1e-5, rtol=1e-5)


def test_adaptive_server_at_threshold_zero_equals_fixed_server(trained):
    """exit_threshold=0: every request runs L layers, and W and the final
    metrics are bit-equal to the fixed server's on the same requests."""
    _, theta, _ = trained
    srvs = [FederationServer(SMOKE, theta, buckets=BUCKETS, max_batch=4,
                             depth=depth, device="cpu")
            for depth in ("fixed", "adaptive")]
    futs = []
    for n, seed in SERVED:
        _, tcfg_r, S, ds = _cohort(n, 4, 40 + seed)
        futs.append([srv.submit(S, ds, seed=seed) for srv in srvs])
    for srv in srvs:
        srv.drain()
    for fixed, adaptive in futs:
        f, a = fixed.result(), adaptive.result()
        assert int(a["depth"]) == SMOKE.n_layers
        for k in ("W", "final_loss", "final_acc"):
            assert np.array_equal(a[k], f[k]), k
    assert srvs[1].metrics.layers_run == srvs[1].metrics.ticks * 4


def test_junk_in_probe_pad_region_is_inert(trained):
    """Poisoning the padded agents' rows — INCLUDING the probe split —
    changes neither the result nor the realized depth."""
    _, theta, _ = trained
    tcfg = dataclasses.replace(SMOKE, exit_threshold=0.2, min_layers=1)
    _, tcfg_r, S, ds = _cohort(6, 4, 44, exit_threshold=0.2, min_layers=1)
    srv = FederationServer(tcfg, theta, buckets=BUCKETS, max_batch=4,
                           depth="adaptive", device="cpu")
    fut = srv.submit(S, ds, seed=1)
    req = srv._queue[0]
    arrs = [a.clone() for a in req.arrays]
    arrs[1][6:] = 1e6                       # W0 pad rows
    arrs[2][:, 6:] = -3e5                   # layer-batch pad rows
    arrs[6][6:] = 4e5                       # probe X pad rows
    req.arrays = tuple(arrs)
    srv.drain()
    ref = surf.solve_federation(tcfg_r, TrainState(theta), S, ds, seed=1,
                                depth="adaptive", device="cpu")
    res = fut.result()
    assert int(res["depth"]) == int(ref["depth"])
    np.testing.assert_allclose(res["final_acc"], ref["final_acc"],
                               atol=1e-5, rtol=1e-5)


def test_pad_probe_geometry():
    Xp = torch.arange(6 * 4 * 3, dtype=torch.float32).reshape(6, 4, 3)
    Yp = torch.ones((6, 4), dtype=torch.long)
    Xpp, Ypp = pad_probe(Xp, Yp, Bucket(8, 4))
    assert Xpp.shape == (8, 4, 3) and Ypp.shape == (8, 4)
    assert torch.equal(Xpp[:6], Xp) and not Xpp[6:].any()
    assert torch.equal(Ypp[:6], Yp) and not Ypp[6:].any()
    with pytest.raises(ValueError, match="does not fit"):
        pad_probe(Xp, Yp, Bucket(4, 4))


def test_pad_probe_matches_reference():
    rng = np.random.default_rng(0)
    Xp = rng.standard_normal((6, 4, 8)).astype(np.float32)
    Yp = rng.integers(0, 4, (6, 4))
    for n_pad in (6, 8, 16):
        jX, jY = jpad_probe(Xp, Yp, JBucket(n_pad, 4))
        tX, tY = pad_probe(torch.tensor(Xp), torch.tensor(Yp),
                           Bucket(n_pad, 4))
        assert np.array_equal(tX.numpy(), jX)
        assert np.array_equal(tY.numpy(), jY)


def test_adaptive_serve_requires_probe_rows(trained):
    _, theta, _ = trained
    cfg = dataclasses.replace(SMOKE, exit_threshold=0.2,
                              probe_size=SMOKE.train_per_agent + 1)
    srv = FederationServer(cfg, theta, buckets=BUCKETS, max_batch=2,
                           depth="adaptive", device="cpu")
    _, _, S, ds = _cohort(8, 4, 50)
    with pytest.raises(ValueError, match="probe"):
        srv.submit(S, ds)


def test_depth_rejected_at_server_construction(trained):
    _, theta, _ = trained
    with pytest.raises(ValueError, match="depth must be"):
        FederationServer(SMOKE, theta, depth="variable", device="cpu")
    with pytest.raises(ValueError, match="max_wait_ticks"):
        FederationServer(SMOKE, theta, max_wait_ticks=0, device="cpu")


# ------------------------------------------------------ depth telemetry
def test_serve_metrics_grow_depth_histogram(trained):
    _, theta, _ = trained
    cfg = dataclasses.replace(SMOKE, exit_threshold=10.0, min_layers=2)
    srv = FederationServer(cfg, theta, buckets=BUCKETS, max_batch=4,
                           depth="adaptive", device="cpu")
    for i in range(3):
        _, _, S, ds = _cohort(8, 4, 60 + i)
        srv.submit(S, ds, seed=i)
    srv.drain()
    s = srv.metrics.summary()
    # thr=10 fires at min_layers=2 for every request: one histogram bin
    assert s["depth_hist"] == {"2": 3}
    assert s["mean_depth"] == 2.0
    # per-request: 1 - (3*2)/(3*4); per-batch: the tick ran 2 of 4 layers
    assert s["request_flops_saved"] == pytest.approx(0.5)
    assert s["batch_flops_saved"] == pytest.approx(0.5)


def test_depth_metrics_match_reference():
    """The same ticks recorded by both packages' ``ServeMetrics``: the
    depth fields agree (the timing fields are inputs here)."""
    ticks = [((8, 4), 3, 4, [2, 4, 3]), ((16, 4), 4, 4, [1, 1, 4, 2]),
             ((8, 4), 1, 4, [4])]
    port, ref = ServeMetrics(), JServeMetrics()
    for bucket, n, slots, depths in ticks:
        for m in (port, ref):
            m.record_tick(bucket, n, slots, 10.0 * n, 64.0, [0.01] * n,
                          0.002, depths=depths, layers_run=max(depths),
                          n_layers=4)
    p, r = port.summary(), ref.summary()
    keys = ("depth_hist", "mean_depth", "request_flops_saved",
            "batch_flops_saved", "occupancy", "pad_waste",
            "requests_completed", "ticks", "per_bucket_ticks")
    assert {k: p[k] for k in keys} == {k: r[k] for k in keys}
    assert p["depth_hist"] == {"1": 2, "2": 2, "3": 1, "4": 3}


def test_fixed_serve_metrics_have_no_depth_fields(trained):
    _, theta, _ = trained
    srv = FederationServer(SMOKE, theta, buckets=BUCKETS, max_batch=4,
                           device="cpu")
    _, _, S, ds = _cohort(8, 4, 70)
    srv.submit(S, ds)
    srv.drain()
    s = srv.metrics.summary()
    assert "depth_hist" not in s and "mean_depth" not in s
    assert not any("flops_saved" in k for k in s)
