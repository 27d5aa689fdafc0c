"""In-loop evaluation snapshots in the port (``engine.snapshots``,
ROADMAP item 7) on the CPU: every snapshot equal to
``snapshot_reference`` on the θ the driver held after that step, the
snapshot's aggregation against the reference's on its θ and draws, the
pool requirement and the return contract of ``tests/test_engine.py``,
the nominal S under a schedule, the host buffer and its decimation, and
the filter calls a snapshot makes.

Tolerances: the port against itself bit for bit (one body, one
generator per dataset); against the reference, 5e-5 for the per-layer
loss and 1e-6 for the accuracy (``tests/test_torch_serve.py``: sums in
another order; an accuracy counts argmax hits and no test row sits on a
near-tie at these inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import surf_paper as jcfgs
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic as jsyn
from repro_torch import engine as E
from repro_torch.checkpoint.convert import theta_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import surf as tsurf
from repro_torch.core import unroll as TU
from repro_torch.engine import snapshots as SN
from repro_torch.kernels.graph_filter import ops

CFG = tcfgs.SMOKE
LOSS_TOL, ACC_TOL = 5e-5, 1e-6


@pytest.fixture(scope="module")
def mds():
    return jsyn.make_meta_dataset(jcfgs.SMOKE, 4, seed=0)


@pytest.fixture(scope="module")
def eval_ds():
    return jsyn.make_meta_dataset(jcfgs.SMOKE, 3, seed=99)


def _equal(a, b):
    for k in ("loss_per_layer", "acc_per_layer", "final_loss", "final_acc"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("driver", ["train_scan", "train"])
def test_snapshots_match_offline_recomputation(mds, eval_ds, driver):
    _, S = tsurf.make_problem(CFG, 0, device="cpu")
    _, _, snaps = getattr(E, driver)(CFG, S, mds, 15, seed=7,
                                     eval_every=5, eval_datasets=eval_ds,
                                     device="cpu")
    assert [sn["step"] for sn in snaps] == [4, 9, 14]
    for sn in snaps:
        t = sn["step"]
        st_t, _ = E.train_scan(CFG, S, mds, t + 1, seed=7, device="cpu")
        ref = E.snapshot_reference(CFG, st_t.theta, S, eval_ds, 7, t,
                                   device="cpu")
        _equal(sn, ref)
        assert isinstance(sn["final_acc"], float)


def test_snapshot_aggregation_matches_reference(mds, eval_ds):
    """The reference's snapshot of its θ against the port's mean over the
    pool on the reference's per-dataset snapshot draws."""
    jcfg = jcfgs.SMOKE
    key, t = jax.random.PRNGKey(7), 4
    _, S = jsurf.make_problem(jcfg, seed=0)
    jstate, _ = JE.train(jcfg, S, mds, t + 1, key)
    ref = JE.snapshot_reference(jcfg, jstate.theta, S, eval_ds, key, t)
    kt = JE.snapshot_key(key, jnp.asarray(t, jnp.int32))
    draws = [tuple(np.asarray(a) for a in JU.featurize_cohort(
        jax.random.fold_in(kt, q), jax.tree.map(jnp.asarray, ds), jcfg))
        for q, ds in enumerate(eval_ds)]
    theta = theta_from_numpy(jax.tree.map(np.asarray, jstate.theta), "cpu")
    out = tsurf.evaluate_surf(CFG, E.TrainState(theta), np.asarray(S),
                              eval_ds, device="cpu", draws=draws)
    np.testing.assert_allclose(out["loss_per_layer"], ref["loss_per_layer"],
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(out["acc_per_layer"], ref["acc_per_layer"],
                               atol=ACC_TOL, rtol=ACC_TOL)


def test_snapshot_run_requires_eval_pool(mds):
    _, S = tsurf.make_problem(CFG, 0, device="cpu")
    with pytest.raises(ValueError, match="eval"):
        E.train_scan(CFG, S, mds, 4, eval_every=2, device="cpu")
    sch = tsurf.make_scenario(CFG, "link-failure", 4, device="cpu")
    with pytest.raises(ValueError, match="S_eval"):
        E.train_scan(CFG, sch, mds, 4, eval_every=2, eval_datasets=mds,
                     device="cpu")
    with pytest.raises(ValueError, match="eval_datasets"):
        tsurf.train_surf(CFG, mds, steps=4, eval_every=2, device="cpu")
    with pytest.raises(ValueError, match="engine='scan'"):
        tsurf.train_surf(CFG, mds, steps=4, eval_every=2,
                         eval_datasets=mds, engine="python", device="cpu")


def test_train_surf_snapshot_return_contract(mds, eval_ds):
    state, hist, snaps, S = tsurf.train_surf(CFG, mds, steps=10,
                                             log_every=5, eval_every=5,
                                             eval_datasets=eval_ds,
                                             device="cpu")
    assert [sn["step"] for sn in snaps] == [4, 9]
    assert isinstance(snaps[0]["final_acc"], float)
    assert snaps[0]["acc_per_layer"].shape == (CFG.n_layers,)
    assert snaps[1]["final_acc"] == snaps[1]["acc_per_layer"][-1]
    assert state.step == 10 and [h["step"] for h in hist] == [0, 5, 9]
    out = tsurf.train_surf(CFG, mds, steps=10, log_every=5, device="cpu")
    assert len(out) == 3


def test_scheduled_snapshots_use_the_nominal_graph(mds, eval_ds):
    state, _, snaps, S = tsurf.train_surf(
        CFG, mds, steps=6, log_every=0, eval_every=6, eval_datasets=eval_ds,
        scenario="link-failure", device="cpu")
    _, S_nom = tsurf.make_problem(CFG, 0, device="cpu")
    assert torch.equal(S, S_nom)
    _equal(snaps[0], E.snapshot_reference(CFG, state.theta, S_nom, eval_ds,
                                          0, 5, device="cpu"))


def test_snapshot_buffer_and_decimation():
    """``decimate_snapshots`` on the reference's NaN-filled buffer (one
    row per step, the time axis 0, or 1 for seed stacks)."""
    L = 3
    buf = {k: np.full((4,) + v.shape, np.nan, np.float32)
           for k, v in SN.nan_snapshot(L).items()}
    for i in (1, 3):
        for k in buf:
            buf[k][i] = float(i)
    assert buf["acc_per_layer"].shape == (4, L)
    assert np.isnan(buf["final_acc"][[0, 2]]).all()
    out = SN.decimate_snapshots(buf, 4, 2)
    assert [r["step"] for r in out] == [1, 3] and out[1]["final_loss"] == 3.0
    # a resumed run (start 5) keeps the absolute cadence
    assert [r["step"] for r in SN.decimate_snapshots(buf, 4, 2, start=5)] \
        == [5, 7]
    sb = {k: np.stack([np.full((2,) + v.shape, 1.0, np.float32),
                       np.full((2,) + v.shape, 2.0, np.float32)])
          for k, v in SN.nan_snapshot(L).items()}
    assert sb["acc_per_layer"].shape == (2, 2, L)
    row = SN.decimate_snapshots(sb, 2, 1, t_axis=1)[0]
    assert row["final_acc"].tolist() == [1.0, 2.0]
    assert SN.decimate_snapshots(buf, 4, 0) == []


def test_snapshot_filter_calls(mds, eval_ds, monkeypatch):
    """A snapshot runs L forward filter calls per eval dataset and no
    backward; the training steps keep their L and L − 1. (On the card
    these are the kernel's ``launches`` and ``bwd_launches``.)"""
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(ops, "_filter", counted(ops._filter, "fwd"))
    monkeypatch.setattr(ops, "graph_filter_bwd",
                        counted(ops.graph_filter_bwd, "bwd"))
    _, S = tsurf.make_problem(CFG, 0, device="cpu")
    E.train_scan(CFG, S, mds, 4, eval_every=2, eval_datasets=eval_ds,
                 device="cpu")
    L, Q = CFG.n_layers, len(eval_ds)
    assert calls == {"fwd": 4 * L + 2 * Q * L, "bwd": 4 * (L - 1)}


def test_snapshot_generator_is_its_own_stream():
    a = TU.snapshot_generator(0, 0, 0, "cpu").initial_seed()
    assert a == TU.SNAPSHOT_SEED_BASE
    assert TU.snapshot_generator(2, 3, 4, "cpu").initial_seed() \
        == a + (2 * 1_000_003 + 3) * 1_000_003 + 4
    assert a < TU.step_generator(0, 0, "cpu").initial_seed()
    assert TU.solve_generator(10 ** 12, 10 ** 6, "cpu").initial_seed() < a
