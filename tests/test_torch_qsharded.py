"""Q- and request-axis sharding in the port, on the CPU with simulated
meshes (``devices=["cpu"] * k``): the Q-sharded training pool and
snapshot pool against the replicated ones, the 2-D seed×agent
composition, the Q-sharded evaluators, and the request-sharded server
against the solo solve; plus the reference's validation errors
(``tests/test_qsharded.py``).

The reference's multi-device tests skip at one jax device, so the
sharded runs are held against the port's own replicated runs, within
the reference's 1e-5 (a Q-sharded select copies one dataset, so they
are in fact bit-equal here), and the sharded server against
``solve_federation`` at the reference's 5e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf
from repro_torch.data import synthetic
from repro_torch.launch.mesh import make_agent_mesh, make_surf_mesh
from repro_torch.serve import (Bucket, BucketSpec, FederationServer,
                               request_shardings, serve_cache_key)

Q_TOL, SERVE_TOL = 1e-5, 5e-5
# 16 agents, default mixing; the pool of 8 divides the 8-, 4- and 2-way
# agent axes used below.
CFG = SURFConfig(n_agents=16, n_layers=3, filter_taps=2, feature_dim=8,
                 n_classes=4, batch_per_agent=4, train_per_agent=8,
                 test_per_agent=4, eps=0.05, topology="ring", degree=2)
STEPS, META_Q, EVAL_Q, EVAL_EVERY = 6, 8, 4, 3


def _mesh(agent, seed=1):
    return make_surf_mesh(seed, agent, devices=["cpu"] * (seed * agent))


@pytest.fixture(scope="module")
def pools():
    return (synthetic.make_meta_dataset(CFG, META_Q, seed=0),
            synthetic.make_meta_dataset(CFG, EVAL_Q, seed=777))


def _train(mds, eval_ds, **kw):
    return surf.train_surf(CFG, mds, steps=STEPS, seed=0, log_every=1,
                           eval_every=EVAL_EVERY, eval_datasets=eval_ds,
                           **({"device": "cpu"} if "mesh" not in kw else {}),
                           **kw)


def _theta_close(a, b):
    for k in b:
        torch.testing.assert_close(a[k], b[k], atol=Q_TOL, rtol=Q_TOL)


def _snaps_close(a, b):
    assert len(a) == len(b) > 0
    for s, r in zip(a, b):
        assert s["step"] == r["step"]
        for k in ("final_acc", "final_loss", "loss_per_layer"):
            np.testing.assert_allclose(s[k], r[k], atol=Q_TOL, rtol=Q_TOL)


@pytest.fixture(scope="module")
def replicated(pools):
    return _train(*pools)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_qsharded_train_matches_replicated(pools, replicated, shards):
    """Pool and snapshot pool Q-sharded over the agent axis: θ, history
    and every snapshot match the replicated run."""
    ref_state, ref_hist, ref_snaps, _ = replicated
    state, hist, snaps, _ = _train(*pools, mesh=_mesh(shards),
                                   q_sharded=True)
    _theta_close(state.theta, ref_state.theta)
    _snaps_close(snaps, ref_snaps)
    for h, r in zip(hist, ref_hist):
        for k in r:
            np.testing.assert_allclose(h[k], r[k], atol=Q_TOL, rtol=Q_TOL)


def test_qsharded_on_one_device_axis_replicates(pools, replicated):
    """An agent axis of one device: the pool stays replicated and the
    run is the replicated one."""
    state, _, snaps, _ = _train(*pools, mesh=_mesh(1), q_sharded=True)
    _theta_close(state.theta, replicated[0].theta)
    _snaps_close(snaps, replicated[2])


@pytest.mark.parametrize("seed_shards,agent_shards", [(2, 4), (2, 2)])
def test_qsharded_seed_engine_2d_mesh(pools, seed_shards, agent_shards):
    """The seed-batched engine on a ('seed', 'agent') mesh with the pool
    and snapshot pool Q-sharded over 'agent': rows match the replicated
    seed-batched run."""
    seeds = (0, 1)
    ref_states, _, ref_snaps, _ = _train(*pools, seeds=seeds)
    mesh = _mesh(agent_shards, seed_shards)
    states, _, snaps, _ = _train(*pools, seeds=seeds, mesh=mesh,
                                 q_sharded=True)
    _theta_close(states.theta, ref_states.theta)
    assert snaps[0]["final_acc"].shape == (len(seeds),)
    _snaps_close(snaps, ref_snaps)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("which", ["evaluate_surf", "evaluate_async"])
def test_evaluators_q_sharded(pools, replicated, which, shards):
    """The evaluators with ``mesh=`` (datasets Q-sharded over the agent
    axis) against the unsharded call: same draws and masks per dataset
    index, one seed and a seed batch."""
    state, _, _, S = replicated
    eval_ds = pools[1]
    kw = {"n_async": 4} if which == "evaluate_async" else {}
    fn = getattr(surf, which)
    for seeds in (None, (0, 3)):
        ref = fn(CFG, state, S, eval_ds, seed=3, seeds=seeds, device="cpu",
                 **kw)
        got = fn(CFG, state, S, eval_ds, seed=3, seeds=seeds,
                 mesh=_mesh(shards), **kw)
        for k in ("final_acc", "final_loss", "loss_per_layer"):
            np.testing.assert_allclose(got[k], ref[k], atol=Q_TOL,
                                       rtol=Q_TOL)


# ------------------------------------------------------ validation errors
def test_qsharded_requires_mesh(pools):
    with pytest.raises(ValueError, match="q_sharded"):
        surf.train_surf(CFG, pools[0], steps=2, log_every=0, q_sharded=True,
                        device="cpu")


def test_qsharded_rejects_python_engine(pools):
    with pytest.raises(ValueError, match="q_sharded"):
        surf.train_surf(CFG, pools[0], steps=2, log_every=0, q_sharded=True,
                        engine="python", device="cpu")


def test_qsharded_rejects_agent_sharded_mixers(pools):
    """Ring/halo mixers split the AGENT axis over the devices Q would
    shard over: a loud error, not silent wrongness."""
    with pytest.raises(ValueError, match="q_sharded"):
        surf.train_surf(CFG, pools[0], steps=2, log_every=0, q_sharded=True,
                        mesh=_mesh(1), mix="ring")


@pytest.mark.parametrize("mesh_kind", ["one-device", "legacy-1d"])
def test_seed_qsharded_requires_2d_mesh(pools, mesh_kind):
    mesh = (_mesh(1) if mesh_kind == "one-device"
            else make_agent_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="2-D"):
        surf.train_surf(CFG, pools[0], steps=2, log_every=0, seeds=(0, 1),
                        q_sharded=True, mesh=mesh)


def test_qsharded_pool_must_divide(pools):
    with pytest.raises(ValueError, match="Q=8 does not divide"):
        surf.train_surf(CFG, pools[0], steps=2, log_every=0, q_sharded=True,
                        mesh=make_surf_mesh(1, 3, devices=["cpu"] * 3))


def test_serve_cache_key_carries_mesh_fingerprint():
    """A request-sharded bucket solver never shares a key with the
    unsharded one, nor with another mesh's."""
    b = Bucket(8, 4)
    keys = {serve_cache_key(SMOKE, b, 4, "relu"),
            serve_cache_key(SMOKE, b, 4, "relu", mesh=_mesh(1)),
            serve_cache_key(SMOKE, b, 4, "relu", mesh=_mesh(2)),
            serve_cache_key(SMOKE, b, 4, "relu", mesh=_mesh(2, 2))}
    assert len(keys) == 4


# ------------------------------------------------- request-sharded serving
def _cohort(cfg, n, t, seed):
    cfg_r = dataclasses.replace(cfg, n_agents=n, test_per_agent=t)
    _, S = surf.make_problem(cfg_r, seed=seed, device="cpu")
    ds = synthetic.sample_dataset(cfg_r, seed=1000 + seed)
    return cfg_r, S, ds


@pytest.fixture(scope="module")
def served():
    mds = synthetic.make_meta_dataset(SMOKE, 3, seed=0)
    state, _, S = surf.train_surf(SMOKE, mds, steps=8, seed=0, log_every=0,
                                  device="cpu")
    return state


REQUESTS = [(6, 4), (8, 4), (12, 4), (16, 4), (14, 4), (10, 4), (6, 3),
            (16, 8), (10, 6), (4, 4)]


@pytest.mark.parametrize("depth", ["fixed", "adaptive"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_serve_matches_solo_solve(served, shards, depth):
    """The request axis split over ``shards`` devices: every ragged
    request (partial batches ride as masked empty slots) matches the
    single-cohort ``solve_federation``, and results come back in slot
    order."""
    cfg = (dataclasses.replace(SMOKE, exit_threshold=0.05, min_layers=2,
                               probe_size=4)
           if depth == "adaptive" else SMOKE)
    srv = FederationServer(cfg, served.theta, max_batch=8, depth=depth,
                           buckets=BucketSpec(agent_sizes=(8, 16),
                                              row_sizes=(4, 8)),
                           mesh=_mesh(shards))
    assert srv.device == torch.device("cpu")
    reqs = [_cohort(cfg, n, t, seed=50 + i)
            for i, (n, t) in enumerate(REQUESTS)]
    futs = [srv.submit(S, ds, seed=i) for i, (_, S, ds) in enumerate(reqs)]
    srv.drain()
    for i, ((cfg_r, S, ds), fut) in enumerate(zip(reqs, futs)):
        ref = surf.solve_federation(cfg_r, served, S, ds, seed=i,
                                    device="cpu", depth=depth)
        res = fut.result()
        assert abs(float(res["final_loss"] - ref["final_loss"])) < SERVE_TOL
        assert abs(float(res["final_acc"] - ref["final_acc"])) < SERVE_TOL
        assert res["W"].shape[0] == cfg_r.n_agents
        if depth == "adaptive":
            assert int(res["depth"]) == int(ref["depth"])


def test_sharded_serve_rejects_indivisible_batch(served):
    with pytest.raises(ValueError, match="divide"):
        FederationServer(SMOKE, served.theta, max_batch=6,
                         buckets=BucketSpec(agent_sizes=(8,),
                                            row_sizes=(4,)),
                         mesh=_mesh(8))
    with pytest.raises(ValueError, match="divide"):
        request_shardings(_mesh(4), 6)
    in_place, out = request_shardings(_mesh(4), 8)
    assert len(in_place) == 9 and in_place[1].spec == ()
    assert out.spec == ("agent",) and out.shards == 4
