"""The port's serving path as a whole, against the reference on the CPU.

A SMOKE model is meta-trained by the reference (a few ``train_surf``
steps) and handed to both servers: the reference's ``FederationServer``
(``mix="pallas"``, its Pallas kernel in interpret mode) and the port's
(``mix="cuda"``, which takes the plain filter on CPU tensors). The port
is fed the reference's random draws through numpy (JAX's threefry
stream cannot be reproduced in torch).

Tolerances: ``loss_per_layer`` 5e-5 (the reference's pallas-vs-dense
serve tolerance, ``tests/test_serve.py``; sums run in different orders);
``acc_per_layer`` 1e-6 (the reference's exact-fit tolerance: accuracy is
a count over rows, and both sides see the same rows)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.surf_paper import SMOKE as JSMOKE
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic
from repro.serve import BucketSpec as JBucketSpec
from repro.serve import FederationServer as JServer
from repro_torch import cache_stats, clear_caches
from repro_torch.checkpoint.convert import theta_from_numpy
from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf
from repro_torch.engine.core import TrainState
from repro_torch.serve import (Bucket, BucketSpec, FederationServer,
                               pad_cohort, serve_cache_key)
from repro_torch.utils.cache import BoundedLRU

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

LOSS_TOL, ACC_TOL = 5e-5, 1e-6
BUCKETS = BucketSpec(agent_sizes=(8, 16), row_sizes=(4, 8))
COHORTS = [(6, 4), (8, 4), (12, 4), (16, 3), (8, 2)]   # buckets (8,4), (16,4)


@pytest.fixture(scope="module")
def trained():
    mds = synthetic.make_meta_dataset(JSMOKE, 3, seed=0)
    state, _, _ = jsurf.train_surf(JSMOKE, mds, steps=8, seed=0, log_every=0)
    return state, theta_from_numpy(jax.tree.map(np.asarray, state.theta),
                                   "cpu")


def _cohort(n, t, seed):
    """A fresh federation: topology + dataset at (n agents, t test rows)."""
    cfg_r = dataclasses.replace(JSMOKE, n_agents=n, test_per_agent=t)
    _, S = jsurf.make_problem(cfg_r, seed=seed)
    return cfg_r, np.asarray(S), synthetic.sample_dataset(cfg_r,
                                                          seed=1000 + seed)


def _draws(cfg_r, ds, seed, q=0):
    """The reference's draws for the solve of (seed, q), as numpy."""
    key = jax.random.fold_in(jax.random.PRNGKey(1000 + seed), q)
    batch = {k: jnp.asarray(v) for k, v in ds.items()}
    return tuple(np.asarray(a) for a in JU.featurize_cohort(key, batch,
                                                            cfg_r))


def _tcfg(cfg_r):
    return dataclasses.replace(SMOKE, n_agents=cfg_r.n_agents,
                               test_per_agent=cfg_r.test_per_agent)


def _server(theta, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 4)
    kw.setdefault("device", "cpu")
    return FederationServer(SMOKE, theta, **kw)


def _match(res, ref, W=True):
    np.testing.assert_allclose(res["loss_per_layer"], ref["loss_per_layer"],
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(res["acc_per_layer"], ref["acc_per_layer"],
                               atol=ACC_TOL, rtol=ACC_TOL)
    if W:
        np.testing.assert_allclose(res["W"], ref["W"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)


# ------------------------------------------------ the slice as a whole
def test_port_server_matches_reference_server(trained):
    """Ragged cohorts over two buckets, through both servers with the
    same θ and the same draws."""
    state, theta = trained
    jsrv = JServer(JSMOKE, state.theta, mix="pallas",
                   buckets=JBucketSpec((8, 16), (4, 8)), max_batch=4)
    tsrv = _server(theta, mix="cuda")
    pairs = []
    for i, (n, t) in enumerate(COHORTS):
        cfg_r, S, ds = _cohort(n, t, seed=i)
        pairs.append((jsrv.submit(S, ds, seed=i),
                      tsrv.submit(S, ds, seed=i,
                                  draws=_draws(cfg_r, ds, i))))
    assert jsrv.drain() == tsrv.drain() == len(COHORTS)
    assert jsrv.metrics.ticks == tsrv.metrics.ticks == 2
    for (jf, tf), (n, _) in zip(pairs, COHORTS):
        assert tf.result()["W"].shape == (n, SMOKE.head_dim)
        _match(tf.result(), jf.result())


@pytest.mark.parametrize("mix", [None, "plain"])
def test_port_solve_federation_matches_reference(trained, mix):
    from repro_torch.kernels.graph_filter import make_plain_mix
    state, theta = trained
    cfg_r, S, ds = _cohort(12, 4, seed=5)
    ref = jsurf.solve_federation(cfg_r, state, S, ds, seed=3)
    res = surf.solve_federation(_tcfg(cfg_r), TrainState(theta), S, ds,
                                seed=3, device="cpu",
                                mix_fn=make_plain_mix() if mix else None,
                                draws=_draws(cfg_r, ds, 3))
    _match(res, ref, W=False)
    assert res["final_loss"] == res["loss_per_layer"][-1]


def test_evaluate_surf_means_over_datasets(trained):
    state, theta = trained
    cfg_r, S, _ = _cohort(8, 4, seed=6)
    dss = [synthetic.sample_dataset(cfg_r, seed=s) for s in (1, 2)]
    ref = jsurf.evaluate_surf(cfg_r, state, S, dss, seed=4)
    res = surf.evaluate_surf(_tcfg(cfg_r), TrainState(theta), S, dss, seed=4,
                             device="cpu",
                             draws=[_draws(cfg_r, d, 4, q)
                                    for q, d in enumerate(dss)])
    _match(res, ref, W=False)


def test_served_request_matches_port_solve(trained):
    """Without injected draws the server and ``solve_federation`` draw
    from the same ``solve_generator(seed, 0)``; padding in both axes
    leaves the numbers of the true cohort."""
    _, theta = trained
    srv = _server(theta, mix="cuda")
    futs = []
    for i, (n, t) in enumerate(COHORTS):
        cfg_r, S, ds = _cohort(n, t, seed=20 + i)
        futs.append((cfg_r, S, ds, srv.submit(S, ds, seed=i)))
    srv.drain()
    for i, (cfg_r, S, ds, fut) in enumerate(futs):
        ref = surf.solve_federation(_tcfg(cfg_r), TrainState(theta), S, ds,
                                    seed=i, device="cpu")
        _match(fut.result(), ref, W=False)


def test_junk_in_pad_region_is_inert(trained):
    """Poisoning the padded agents' rows of a queued request changes
    nothing for the real agents."""
    _, theta = trained
    cfg_r, S, ds = _cohort(6, 4, seed=5)
    srv = _server(theta, mix="cuda")
    fut = srv.submit(S, ds, seed=1)
    req = srv._queue[0]
    Sp, W0p, Xlp, Ylp, Xtep, Ytep = (a.clone() for a in req.arrays)
    W0p[6:] = 1e6          # junk where the mask says "padded agent"
    Xlp[:, 6:] = -3e5
    Xtep[6:] = 7e4
    req.arrays = (Sp, W0p, Xlp, Ylp, Xtep, Ytep)
    srv.drain()
    ref = surf.solve_federation(_tcfg(cfg_r), TrainState(theta), S, ds,
                                seed=1, device="cpu")
    _match(fut.result(), ref, W=False)


# ---------------------------------------------------------- bucketing
def test_bucket_for_picks_smallest_fit_and_overflow_raises():
    assert BUCKETS.bucket_for(6, 4) == Bucket(8, 4)
    assert BUCKETS.bucket_for(8, 5) == Bucket(8, 8)
    assert BUCKETS.bucket_for(9, 8) == Bucket(16, 8)
    with pytest.raises(ValueError, match="exceeds the bucket grid"):
        BUCKETS.bucket_for(17, 4)


def test_pad_cohort_geometry():
    _, S, ds = _cohort(6, 4, seed=0)
    n, d, L, b, F = 6, SMOKE.head_dim, SMOKE.n_layers, 4, SMOKE.feature_dim
    Sp, W0p, Xlp, Ylp, Xtep, Ytep, mask, t_real = pad_cohort(
        torch.tensor(S), torch.ones(n, d), torch.ones(L, n, b, F),
        torch.ones(L, n, b, dtype=torch.long),
        torch.from_numpy(ds["Xte"]), torch.from_numpy(ds["Yte"]).long(),
        Bucket(8, 8))
    assert Sp.shape == (8, 8) and not Sp[6:].any() and not Sp[:, 6:].any()
    assert not W0p[6:].any() and not Xlp[:, 6:].any()
    np.testing.assert_array_equal(Xtep[:6, 4:].numpy(),
                                  np.repeat(ds["Xte"][:, :1], 4, axis=1))
    assert not Xtep[6:].any() and not Ytep[6:].any()
    assert mask.tolist() == [True] * 6 + [False] * 2 and t_real == 4.0


# ------------------------------------------------------ queue semantics
def test_aging_prevents_bucket_starvation(trained):
    _, theta = trained
    srv = _server(theta, max_batch=2, max_wait_ticks=2)
    _, S, ds = _cohort(12, 4, seed=90)          # the rare (16,4) request
    rare = srv.submit(S, ds, seed=0)
    futs = []
    for tick in range(3):
        for j in range(2):                      # two popular (8,4) per tick
            _, S, ds = _cohort(6, 4, seed=91 + 2 * tick + j)
            futs.append(srv.submit(S, ds, seed=tick))
        if tick < 2:
            assert srv.tick() == 2 and not rare.done()
    assert srv.tick() == 1                      # the aging override
    assert rare.done()
    assert sum(f.done() for f in futs) == 4
    srv.drain()
    assert all(f.done() for f in futs)


def test_fifo_head_defines_tick_bucket(trained):
    _, theta = trained
    srv = _server(theta)
    futs = []
    for n, seed in [(6, 0), (12, 1), (8, 2), (16, 3)]:
        _, S, ds = _cohort(n, 4, seed=20 + seed)
        futs.append(srv.submit(S, ds, seed=seed))
    assert srv.pending() == 4
    assert srv.tick() == 2            # head bucket (8,4): the n=6 and n=8
    assert futs[0].done() and futs[2].done()
    assert not futs[1].done() and not futs[3].done()
    assert srv.tick() == 2 and all(f.done() for f in futs)
    assert srv.tick() == 0 and srv.pending() == 0


def test_deadline_beats_fuller_bucket(trained):
    _, theta = trained
    srv = _server(theta, max_batch=4)
    _, S, ds = _cohort(12, 4, seed=60)
    urgent = srv.submit(S, ds, seed=0, deadline_ticks=1)
    bulk = []
    for j in range(3):
        _, S, ds = _cohort(6, 4, seed=61 + j)
        bulk.append(srv.submit(S, ds, seed=j))
    assert srv.tick() == 1
    assert urgent.done() and not any(f.done() for f in bulk)
    assert srv.tick() == 3 and all(f.done() for f in bulk)


def test_metrics_summary_fields(trained):
    _, theta = trained
    srv = _server(theta)
    for i in range(3):
        _, S, ds = _cohort(6, 4, seed=60 + i)
        srv.submit(S, ds, seed=i)
    srv.drain()
    s = srv.metrics.summary()
    assert s["requests_completed"] == 3
    assert s["federations_per_sec"] > 0
    assert s["latency_p99_ms"] >= s["latency_p50_ms"] > 0
    assert s["occupancy"] == pytest.approx(3 / 4)
    assert s["pad_waste"] == pytest.approx(1 - 72 / 128)
    assert s["per_bucket_ticks"] == {"n8xt4": 1}
    assert s["bucket_cache"] == srv.cache_stats()


# ----------------------------------------------------------- validation
def test_invalid_requests_and_servers_rejected(trained):
    _, theta = trained
    srv = _server(theta)
    _, S, ds = _cohort(6, 4, seed=70)
    with pytest.raises(ValueError, match="agents but S is"):
        srv.submit(S[:5, :5], ds)
    with pytest.raises(ValueError, match="must be square"):
        srv.submit(S[:5], ds)
    with pytest.raises(ValueError, match="missing keys"):
        srv.submit(S, {"Xtr": ds["Xtr"]})
    with pytest.raises(ValueError, match="deadline_ticks"):
        srv.submit(S, ds, deadline_ticks=0)
    with pytest.raises(ValueError, match="per-request topologies"):
        _server(theta, mix="ring")
    with pytest.raises(ValueError, match="star-topology serving"):
        FederationServer(dataclasses.replace(SMOKE, topology="star"), theta,
                         device="cpu")


# -------------------------------------------------------- cache hygiene
def test_serve_cache_key_shape_separation():
    k1 = serve_cache_key(SMOKE, Bucket(8, 4), 4, "relu")
    k2 = serve_cache_key(SMOKE, Bucket(16, 4), 4, "relu")
    k3 = serve_cache_key(SMOKE, Bucket(8, 4), 8, "relu")
    assert len({k1, k2, k3}) == 3
    assert serve_cache_key(dataclasses.replace(SMOKE, n_agents=6),
                           Bucket(8, 4), 4, "relu") == k1
    untagged = lambda S, W, h: W                             # noqa: E731
    untagged.takes_S = True
    assert serve_cache_key(SMOKE, Bucket(8, 4), 4, "relu", untagged) is None


def test_bucket_cache_eviction_and_clear(trained):
    _, theta = trained
    srv = _server(theta, max_buckets=1)
    assert srv.warm([(6, 4)]) == [Bucket(8, 4)]
    srv.warm([(12, 4)])                 # evicts the (8,4) solver
    st = srv.cache_stats()
    assert st["size"] == 1 and st["evictions"] == 1
    name = srv._cache.name
    assert name.startswith("serve-buckets")
    assert cache_stats()[name]["size"] == 1
    assert clear_caches(name) == [name]
    assert cache_stats()[name]["size"] == 0
    with pytest.raises(KeyError, match="unknown cache name"):
        clear_caches("no-such-cache")
    del srv
    assert name not in cache_stats()    # weak registry pruned


def test_bounded_lru_mapping_protocol():
    c = BoundedLRU(maxsize=2)
    c["a"], c["b"] = 1, 2
    assert "a" in c and c["a"] == 1
    c["c"] = 3                          # evicts LRU "b"
    assert "b" not in c and set(c) == {"a", "c"}
    assert c.get_or_build("a", lambda: 99) == 1
    assert c.get_or_build("d", lambda: 4) == 4
    s = c.stats()
    assert s["evictions"] >= 1 and s["hits"] >= 2 and s["misses"] == 1
