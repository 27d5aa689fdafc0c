"""The port's ``AsyncDriver`` (background tick loop) on the CPU: the same
submission order gives the same per-request results as a manual tick
loop (fixed and adaptive depth), ``stop(drain=False)`` leaves the queue
to the untouched server, concurrent submitters lose no request, and the
port's driver matches the reference's on the reference's draws.

Every test stops the tick thread in a ``with`` block or a ``finally``
and waits with a timeout of its own, so a hang fails the test instead of
stalling the suite.

Tolerances: results of the port's driver equal its manual tick loop
exactly; against the reference's driver (``mix="pallas"`` in interpret
mode) loss and accuracy 5e-5, the reference's pallas-vs-dense serve
tolerance."""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.surf_paper import SMOKE as JSMOKE
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic
from repro.serve import AsyncDriver as JDriver
from repro.serve import BucketSpec as JBucketSpec
from repro.serve import FederationServer as JServer
from repro_torch.checkpoint.convert import theta_from_numpy
from repro_torch.configs.surf_paper import SMOKE
from repro_torch.serve import AsyncDriver, BucketSpec, FederationServer

BUCKETS = BucketSpec(agent_sizes=(8, 16), row_sizes=(4, 8))
TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def trained():
    mds = synthetic.make_meta_dataset(JSMOKE, 3, seed=0)
    state, _, _ = jsurf.train_surf(JSMOKE, mds, steps=8, seed=0,
                                   log_every=0)
    return state, theta_from_numpy(jax.tree.map(np.asarray, state.theta),
                                   "cpu")


def _cohort(n, t, seed):
    cfg_r = dataclasses.replace(JSMOKE, n_agents=n, test_per_agent=t)
    _, S = jsurf.make_problem(cfg_r, seed=seed)
    return cfg_r, np.asarray(S), synthetic.sample_dataset(cfg_r,
                                                          seed=1000 + seed)


def _requests(k=10, seed=70):
    return [_cohort([6, 8, 12, 16][i % 4], 4, seed=seed + i)
            for i in range(k)]


def _server(theta, cfg=SMOKE, **kw):
    return FederationServer(cfg, theta, buckets=BUCKETS, max_batch=4,
                            device="cpu", **kw)


def _assert_equal(m, a):
    for k in m:
        np.testing.assert_array_equal(m[k], a[k], err_msg=k)


@pytest.mark.parametrize("depth", ["fixed", "adaptive"])
def test_async_driver_matches_manual_tick_loop(trained, depth):
    """The background tick loop adds no scheduling of its own: the same
    submission order yields the same per-request results as a manual
    tick loop (padding is inert, and a bucket's batch always has
    ``max_batch`` slots, so batch composition never matters)."""
    _, theta = trained
    cfg = dataclasses.replace(SMOKE, exit_threshold=0.2, min_layers=1)
    reqs = _requests()

    manual = _server(theta, cfg, depth=depth)
    m_futs = [manual.submit(S, ds, seed=i)
              for i, (_, S, ds) in enumerate(reqs)]
    manual.drain()

    srv = _server(theta, cfg, depth=depth)
    with AsyncDriver(srv) as driver:
        a_futs = [driver.submit(S, ds, seed=i)
                  for i, (_, S, ds) in enumerate(reqs)]
        driver.wait(a_futs, timeout_s=TIMEOUT_S)
    for mf, af in zip(m_futs, a_futs):
        _assert_equal(mf.result(), af.result())
    stats = driver.stats()
    assert stats["requests_completed"] == len(reqs)
    assert stats["busy_s"] > 0 and not stats["running"]
    assert 0 < stats["tick_utilization"] <= 1
    if depth == "adaptive":
        assert sum(srv.metrics.summary()["depth_hist"].values()) == len(reqs)


def test_async_driver_stop_without_drain_leaves_queue(trained):
    """``stop(drain=False)`` exits after the in-flight tick; queued
    requests stay pending on the untouched server and a later manual
    drain completes them."""
    _, theta = trained
    srv = _server(theta)
    driver = AsyncDriver(srv)                   # never started: queue
    _, S, ds = _cohort(6, 4, seed=85)           # only drains manually
    fut = driver.submit(S, ds, seed=0)
    driver.stop(drain=False, timeout_s=TIMEOUT_S)
    assert not fut.done() and srv.pending() == 1
    srv.drain()
    assert fut.done() and srv.pending() == 0


def test_started_driver_stop_without_drain_completes_only_what_it_ticked(
        trained):
    """A running driver stopped without drain leaves the server
    consistent: every request is either completed or still queued."""
    _, theta = trained
    srv = _server(theta)
    driver = AsyncDriver(srv, interval_s=0.01)
    futs = []
    try:
        driver.start()
        futs = [driver.submit(S, ds, seed=i)
                for i, (_, S, ds) in enumerate(_requests(8, seed=90))]
    finally:
        driver.stop(drain=False, timeout_s=TIMEOUT_S)
    done = sum(f.done() for f in futs)
    assert done == driver.completed
    assert done + srv.pending() == len(futs)
    srv.drain()
    assert all(f.done() for f in futs)


def test_concurrent_submitters_lose_no_request(trained):
    """More submitting threads than cores, a short switch interval and
    the tick thread running: every request completes exactly once, and
    the server's and the driver's counts agree."""
    _, theta = trained
    srv = _server(theta)
    reqs = _requests(12, seed=110)
    futs = [None] * len(reqs)
    errors = []
    interval = sys.getswitchinterval()

    def submit(idx):
        try:
            for i in idx:
                _, S, ds = reqs[i]
                futs[i] = driver.submit(S, ds, seed=i)
        except Exception as e:                   # reported below
            errors.append(e)

    driver = AsyncDriver(srv)
    threads = [threading.Thread(target=submit, args=(range(k, 12, 6),))
               for k in range(6)]
    sys.setswitchinterval(1e-5)
    try:
        driver.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        driver.wait(futs, timeout_s=TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
        driver.stop(timeout_s=TIMEOUT_S)
    assert srv.pending() == 0
    assert srv.metrics.completed == driver.completed == len(reqs)
    manual = _server(theta)
    for i, (_, S, ds) in enumerate(reqs):
        ref = manual.submit(S, ds, seed=i)
        manual.drain()
        _assert_equal(ref.result(), futs[i].result())


def test_port_driver_matches_reference_driver(trained):
    """Both packages' drivers over the same requests, the port's on the
    reference's draws."""
    state, theta = trained
    reqs = _requests(8, seed=130)
    jsrv = JServer(JSMOKE, state.theta, mix="pallas", max_batch=4,
                   buckets=JBucketSpec((8, 16), (4, 8)))
    tsrv = _server(theta, mix="cuda")
    with JDriver(jsrv) as jdrv, AsyncDriver(tsrv) as tdrv:
        jf, tf = [], []
        for i, (cfg_r, S, ds) in enumerate(reqs):
            key = jax.random.fold_in(jax.random.PRNGKey(1000 + i), 0)
            batch = {k: jnp.asarray(v) for k, v in ds.items()}
            draws = tuple(np.asarray(a)
                          for a in JU.featurize_cohort(key, batch, cfg_r))
            jf.append(jdrv.submit(S, ds, seed=i))
            tf.append(tdrv.submit(S, ds, seed=i, draws=draws))
        jdrv.wait(jf, timeout_s=TIMEOUT_S)
        tdrv.wait(tf, timeout_s=TIMEOUT_S)
    for j, t in zip(jf, tf):
        for k in ("loss_per_layer", "acc_per_layer", "W"):
            np.testing.assert_allclose(t.result()[k], j.result()[k],
                                       atol=5e-5, rtol=5e-5, err_msg=k)


def test_driver_validation_and_idle_stats(trained):
    _, theta = trained
    srv = _server(theta)
    with pytest.raises(ValueError, match="interval_s"):
        AsyncDriver(srv, interval_s=-1.0)
    driver = AsyncDriver(srv)
    try:
        assert driver.start() is driver.start()     # idempotent
        assert driver.stats()["running"]
    finally:
        driver.stop(timeout_s=TIMEOUT_S)
    stats = driver.stats()
    assert not stats["running"] and stats["ticks"] == 0
    assert stats["tick_utilization"] == 0.0 and stats["wall_s"] > 0
