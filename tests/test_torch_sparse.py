"""The port's sparse-recovery task (federated LASSO, ROADMAP item 5)
against the reference, on the CPU: the sparse datasets and the Dirichlet
partitions (numpy, bit-equal), every ``SparseRecoveryTask`` method, a
SPARSE_SMOKE meta-step and a 20-step run on replayed draws, and the
task through serving, ``evaluate_async`` and the baselines.

The key-driven draws (W0 and the layer mini-batches) are the
reference's, recomputed from its keys and handed to the port through
numpy; states cross through ``checkpoint.convert.state_from_numpy``.

Tolerances, each with its reason:

  * bit-equal for the numpy-made data and partitions;
  * 5e-5 for the task's losses, metrics, gradients and grad norms (f32,
    sums in another order; the reference's f32 kernel tolerance,
    ``tests/test_kernels.py``), the served and async per-layer loss and
    NMSE, and the baselines' per-round loss and NMSE (of the run's
    largest value, as ``tests/test_torch_baselines.py``);
  * 5e-6 for θ, λ, the Adam moments and the metrics after each
    meta-step (the reference's training parity tolerance,
    ``tests/test_pallas_mix.py``). The 20-step run is held STEP BY STEP:
    each step starts both packages from one state (the reference's),
    because the reference's own "the loss decreases" test of this task
    fails (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import surf_paper as jcfgs
from repro.core import baselines as JB
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.core.tasks import sparse_recovery as JSR
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.serve import BucketSpec as JBucketSpec
from repro.serve import FederationServer as JServer
from repro_torch.checkpoint.convert import state_from_numpy, theta_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import baselines as TB
from repro_torch.core import surf as tsurf
from repro_torch.core import unroll as TU
from repro_torch.core.tasks import (SparseRecoveryTask, resolve_task,
                                    signal_nmse, soft_threshold,
                                    sparse_recovery_task, support_f1)
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.engine import core as TE
from repro_torch.engine import scan as TS
from repro_torch.engine.core import TrainState
from repro_torch.serve import BucketSpec, FederationServer

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

TOL = 5e-5
STATE_TOL = 5e-6
JCFG, TCFG = jcfgs.SPARSE_SMOKE, tcfgs.SPARSE_SMOKE
JTASK = JSR.sparse_recovery_task(JCFG)
TTASK = sparse_recovery_task(TCFG)


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate):
    s = _np(jstate)
    return state_from_numpy(s.theta, s.lam, s.opt_state, int(s.step), "cpu")


def _draws(ds, key):
    kw, kb = jax.random.split(key)
    W0 = JU.sample_w0(kw, JCFG)
    Xl, Yl = JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), JCFG)
    return tuple(np.asarray(a) for a in (W0, Xl, Yl))


def _state_close(tstate, jstate, tol=STATE_TOL):
    js = _np(jstate)
    for k in js.theta:
        _close(tstate.theta[k].numpy(), js.theta[k], tol, f"theta.{k}")
        for mom in ("m", "v"):
            _close(tstate.opt_state[mom][k].numpy(), js.opt_state[mom][k],
                   tol, f"{mom}.{k}")
    _close(tstate.lam.numpy(), js.lam, tol, "lam")
    assert tstate.step == int(js.step)


@pytest.fixture(scope="module")
def pool():
    _, S = jsurf.make_problem(JCFG, seed=0)
    return np.asarray(S), JTASK.synth_datasets(JCFG, 4, seed=0)


# ------------------------------------------------------- data, bit-equal
@pytest.mark.parametrize("seed", [0, 3])
def test_sparse_datasets_and_truths_bit_equal(seed):
    jd, jw = jsyn.make_sparse_meta_dataset(JCFG, 3, JTASK, seed=seed,
                                           return_truth=True)
    td, tw = tsyn.make_sparse_meta_dataset(TCFG, 3, TTASK, seed=seed,
                                           return_truth=True)
    np.testing.assert_array_equal(tw, jw)
    assert (np.abs(tw) > 0).sum(1).tolist() == [TTASK.sparsity] * 3
    for a, b in zip(td, jd):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype == np.float32
    assert TTASK.synth_datasets(TCFG, 1, seed=seed)[0]["Ytr"].dtype \
        == np.float32


@pytest.mark.parametrize("alpha", [0.1, 1.0, 10.0])
def test_dirichlet_partition_bit_equal(alpha):
    labels = np.random.default_rng(1).integers(0, 6, 300)
    tp = tpart.dirichlet_partition(labels, 7, alpha, seed=4)
    jp = jpart.dirichlet_partition(labels, 7, alpha, seed=4)
    assert len(tp) == len(jp) == 7
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(tp).tolist()) == list(range(300))
    agent_labels = [labels[p] for p in tp]
    assert (tpart.heterogeneity_stat(agent_labels, 6)
            == jpart.heterogeneity_stat(agent_labels, 6))


# ---------------------------------------------------------- the task
def test_sparse_task_resolves_like_reference():
    t = resolve_task(TCFG)
    assert isinstance(t, SparseRecoveryTask)
    assert (t.dim, t.feat_dim, t.batch_feat) == (16, 16, 17)
    assert t.cache_tag == resolve_task(JCFG).cache_tag
    assert TTASK == SparseRecoveryTask(signal_dim=16, rho=0.02, sparsity=3,
                                       noise=0.01)
    assert sparse_recovery_task(TCFG, rho=0.5).rho == 0.5
    assert t.label_dtype == torch.float32
    batch = t.to_batch(JTASK.synth_datasets(JCFG, 1)[0], "cpu")
    assert batch["Ytr"].dtype == batch["Yte"].dtype == torch.float32
    assert TCFG.head_dim == 16


def _task_inputs(rng, lead=(2,)):
    n, b, p = TCFG.n_agents, 5, TTASK.signal_dim
    W = (0.3 * rng.standard_normal(lead + (n, p))).astype(np.float32)
    X = rng.standard_normal(lead + (n, b, p)).astype(np.float32)
    Y = rng.standard_normal(lead + (n, b)).astype(np.float32)
    return W, X, Y


def test_sparse_task_methods_match_reference():
    rng = np.random.default_rng(0)
    W, X, Y = _task_inputs(rng)
    mask = np.arange(TCFG.n_agents) < TCFG.n_agents - 2
    Wt = torch.tensor(W).requires_grad_(True)
    Xt, Yt, mt = torch.tensor(X), torch.tensor(Y), torch.tensor(mask)
    outs = {"fl_loss": TTASK.fl_loss(Wt, Xt, Yt),
            "fl_metric": TTASK.fl_metric(Wt, Xt, Yt),
            "fl_grad": TTASK.fl_grad(Wt, Xt, Yt),
            "grad_norm": TTASK.grad_norm(Wt, Xt, Yt),
            "masked_grad_norm": TTASK.masked_grad_norm(Wt, Xt, Yt, mt),
            "batch_vector": TTASK.batch_vector(Xt, Yt)}
    (dgn,) = torch.autograd.grad(outs["grad_norm"].sum(), Wt)
    for i in range(2):
        args = (jnp.asarray(W[i]), jnp.asarray(X[i]), jnp.asarray(Y[i]))
        for name, out in outs.items():
            if name == "masked_grad_norm":
                ref = JTASK.masked_grad_norm(*args, jnp.asarray(mask))
            elif name == "batch_vector":
                ref = JTASK.batch_vector(*args[1:])
            else:
                ref = getattr(JTASK, name)(*args)
            _close(out[i].detach().numpy(), ref, TOL, name)
        _close(dgn[i].numpy(), jax.grad(JTASK.grad_norm)(*args), TOL,
               "d grad_norm / dW")
        for a in range(TCFG.n_agents):
            one = (args[0][a], args[1][a], args[2][a])
            _close(TTASK.local_loss(Wt[i, a], Xt[i, a], Yt[i, a]).item(),
                   JTASK.local_loss(*one), TOL, "local_loss")
            _close(TTASK.local_metric(Wt[i, a], Xt[i, a], Yt[i, a]).item(),
                   JTASK.local_metric(*one), TOL, "local_metric")


@pytest.mark.parametrize("k_pad", [0, 1, 3, 7])
def test_padded_nmse_and_loss_are_exact(k_pad):
    """Row-0 padding of k rows: the padded NMSE and loss equal the
    unpadded values, and the reference's correction, for any k."""
    rng = np.random.default_rng(10 + k_pad)
    n, t, p = TCFG.n_agents, 6, TTASK.signal_dim
    W = (0.3 * rng.standard_normal((n, p))).astype(np.float32)
    X = rng.standard_normal((n, t, p)).astype(np.float32)
    Y = rng.standard_normal((n, t)).astype(np.float32)
    Xp = np.concatenate([X, np.repeat(X[:, :1], k_pad, 1)], 1)
    Yp = np.concatenate([Y, np.repeat(Y[:, :1], k_pad, 1)], 1)
    Wt, Xt, Yt = map(torch.tensor, (W, Xp, Yp))
    met = TTASK.padded_local_metric(Wt, Xt, Yt, float(t))
    loss = TTASK.padded_local_loss(Wt, Xt, Yt, float(t))
    _close(met.numpy(), TTASK.local_metric(Wt, torch.tensor(X),
                                           torch.tensor(Y)).numpy(), TOL,
           "padded nmse vs unpadded")
    _close(loss.numpy(), TTASK.local_loss(Wt, torch.tensor(X),
                                          torch.tensor(Y)).numpy(), TOL,
           "padded loss vs unpadded")
    for a in range(n):
        args = (jnp.asarray(W[a]), jnp.asarray(Xp[a]), jnp.asarray(Yp[a]),
                float(t))
        _close(met[a].item(), JTASK.padded_local_metric(*args), TOL,
               "padded_local_metric")
        _close(loss[a].item(), JTASK.padded_local_loss(*args), TOL,
               "padded_local_loss")


def test_sparse_helpers_match_reference():
    rng = np.random.default_rng(2)
    w = rng.standard_normal(12).astype(np.float32)
    w_star = np.where(rng.random(12) < 0.3, w, 0).astype(np.float32)
    W = rng.standard_normal((5, 12)).astype(np.float32)
    for tau in (0.05, 0.5):
        np.testing.assert_array_equal(
            soft_threshold(torch.tensor(w), tau).numpy(),
            np.asarray(JSR.soft_threshold(jnp.asarray(w), tau)))
        _close(support_f1(torch.tensor(w), torch.tensor(w_star), tau).item(),
               JSR.support_f1(jnp.asarray(w), jnp.asarray(w_star), tau),
               1e-6, "support_f1")
    _close(signal_nmse(torch.tensor(W), torch.tensor(w_star)).item(),
           JSR.signal_nmse(jnp.asarray(W), jnp.asarray(w_star)), TOL,
           "signal_nmse")
    assert support_f1(torch.zeros(12), torch.tensor(w_star)).item() == 0.0


# ---------------------------------------------------- meta-step, training
@pytest.mark.parametrize("start", ["init", "trained"])
def test_sparse_meta_step_matches_reference(pool, start):
    S, mds = pool
    key = jax.random.PRNGKey(0)
    jstate = JE.init_state(key, JCFG)
    if start == "trained":
        jstate, _ = JE.train(JCFG, S, mds, 3, key)
    ds, step_key = mds[1], jax.random.PRNGKey(42)
    jstep, _ = JE.make_meta_step(JCFG, S)
    jnext, jm = jstep(jstate, jax.tree.map(jnp.asarray, ds), step_key)
    tstep, _ = TE.make_meta_step(TCFG, torch.tensor(S))
    tnext, tm = tstep(_port_state(jstate), TTASK.to_batch(ds, "cpu"),
                      draws=_draws(ds, step_key))
    _state_close(tnext, jnext)
    for k in jm:
        _close(tm[k].item(), jm[k], STATE_TOL, f"metric {k}")


@pytest.mark.parametrize("driver", ["train_scan", "train"])
def test_sparse_twenty_steps_track_reference_step_by_step(pool, driver):
    """20 reference meta-steps; each port step starts from the
    reference's state before it, on its draws."""
    S, mds = pool
    key = jax.random.PRNGKey(3)
    jstep, _ = JE.make_meta_step(JCFG, S)
    jstate = JE.init_state(key, JCFG)
    for t in range(20):
        ds = mds[t % len(mds)]
        jnext, jm = jstep(jstate, jax.tree.map(jnp.asarray, ds),
                          jax.random.fold_in(key, t))
        draws = {t: _draws(ds, jax.random.fold_in(key, t))}
        tnext, thist = getattr(TS, driver)(
            TCFG, S, mds, 1, log_every=1, device="cpu",
            state=_port_state(jstate), draws=draws)
        _state_close(tnext, jnext)
        assert thist[0]["step"] == t
        for k in jm:
            _close(thist[0][k], jm[k], STATE_TOL, f"step {t} {k}")
        assert np.isfinite(thist[0]["test_acc"])    # NMSE in the acc slot
        jstate = jnext


def test_sparse_train_surf_runs_and_evaluates(pool):
    S, mds = pool
    state, hist, S_t = tsurf.train_surf(TCFG, mds, steps=6, log_every=2,
                                        device="cpu")
    np.testing.assert_array_equal(S_t.numpy(), S)
    assert state.theta["M"].shape == (TCFG.n_layers,
                                      TE.U.perceptron_in_dim(TCFG), 16)
    assert all(np.isfinite(h["test_loss"]) for h in hist)
    ev = tsurf.evaluate_surf(TCFG, state, S, mds, seed=0, device="cpu",
                             task=sparse_recovery_task(TCFG))
    assert ev["acc_per_layer"].shape == (TCFG.n_layers,)
    assert np.isfinite(ev["final_acc"])
    st_p, _, _ = tsurf.train_surf(TCFG, mds, steps=6, log_every=0,
                                  engine="python", device="cpu")
    for k in state.theta:
        assert torch.equal(state.theta[k], st_p.theta[k])


# ----------------------------------------- serving, async, baselines
@pytest.fixture(scope="module")
def trained(pool):
    S, mds = pool
    state, _, _ = jsurf.train_surf(JCFG, mds, steps=6, seed=0, log_every=0)
    return state, theta_from_numpy(_np(state.theta), "cpu")


def _solve_draws(cfg_r, ds, seed):
    key = jax.random.fold_in(jax.random.PRNGKey(1000 + seed), 0)
    return tuple(np.asarray(a) for a in JU.featurize_cohort(
        key, jax.tree.map(jnp.asarray, ds), cfg_r))


def test_sparse_serving_matches_reference(trained):
    """Ragged sparse cohorts over two buckets through both servers, on
    the reference's draws: per-layer loss and NMSE."""
    import dataclasses
    state, theta = trained
    jsrv = JServer(JCFG, state.theta, buckets=JBucketSpec((8, 16), (4, 8)),
                   max_batch=4)
    tsrv = FederationServer(TCFG, theta, buckets=BucketSpec((8, 16), (4, 8)),
                            max_batch=4, device="cpu")
    pairs = []
    for i, (n, t) in enumerate([(6, 4), (8, 3), (12, 4), (16, 6)]):
        jc = dataclasses.replace(JCFG, n_agents=n, test_per_agent=t)
        _, S = jsurf.make_problem(jc, seed=i)
        ds = JTASK.synth_datasets(jc, 1, seed=50 + i)[0]
        pairs.append((jc, S, ds, i, jsrv.submit(np.asarray(S), ds, seed=i),
                      tsrv.submit(np.asarray(S), ds, seed=i,
                                  draws=_solve_draws(jc, ds, i))))
    assert jsrv.drain() == tsrv.drain() == 4
    for jc, S, ds, i, jf, tf in pairs:
        res, ref = tf.result(), jf.result()
        for k in ("loss_per_layer", "acc_per_layer", "W"):
            _close(res[k], ref[k], TOL, f"request {i} {k}")
        tc = dataclasses.replace(TCFG, n_agents=jc.n_agents,
                                 test_per_agent=jc.test_per_agent)
        solo = tsurf.solve_federation(tc, TrainState(theta), np.asarray(S),
                                      ds, seed=i, device="cpu",
                                      draws=_solve_draws(jc, ds, i))
        _close(res["acc_per_layer"], solo["acc_per_layer"], TOL,
               f"request {i} padded vs solo NMSE")


def test_sparse_evaluate_async_matches_reference(trained, pool):
    state, theta = trained
    S, mds = pool
    ref = jsurf.evaluate_async(JCFG, state, S, mds, n_async=2, seed=1,
                               task=JTASK)
    base = jax.random.PRNGKey(2001)
    draws = [tuple(np.asarray(a) for a in JU.featurize_cohort(
        jax.random.fold_in(base, q), jax.tree.map(jnp.asarray, ds), JCFG))
        for q, ds in enumerate(mds)]
    out = tsurf.evaluate_async(TCFG, TrainState(theta), S, mds, 2, seed=1,
                               task=TTASK, device="cpu", draws=draws)
    for k in ("loss_per_layer", "acc_per_layer"):
        _close(out[k], ref[k], TOL, k)
    assert out["acc_per_layer"].shape == (TCFG.n_layers,)


def test_sparse_baselines_match_reference(pool):
    """DGD (the reference's ``test_sparse_baselines_run`` values) and
    FedAvg with every agent participating, through ``task=``."""
    from test_torch_baselines import classical_draws
    S, mds = pool
    W0 = np.asarray(JU.sample_w0(jax.random.PRNGKey(0), JCFG, task=JTASK))
    key = jax.random.PRNGKey(1)
    ref = JB.run_dgd(jnp.asarray(S), jnp.asarray(W0),
                     jax.tree.map(jnp.asarray, mds[0]), key, JCFG,
                     rounds=30, lr=1e-1, task=JTASK)
    out = TB.run_dgd(S, W0, mds[0], None, TCFG, rounds=30, lr=1e-1,
                     task=TTASK, device="cpu")
    for k in ("loss", "acc"):
        scale = np.abs(np.asarray(ref[k])).max()
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=TOL * scale)
    assert out["loss"][-1] < out["loss"][0]
    P = JCFG.n_agents
    ref = JB.run_fedavg(jnp.asarray(W0), jax.tree.map(jnp.asarray, mds[0]),
                        key, JCFG, rounds=5, participate=P, task=JTASK)
    draws = classical_draws(key, 5, P, P, JCFG.batch_per_agent,
                            JCFG.train_per_agent)
    out = TB.run_fedavg(W0, mds[0], None, TCFG, rounds=5, participate=P,
                        task=TTASK, device="cpu", draws=draws)
    for k in ("loss", "acc"):
        scale = np.abs(np.asarray(ref[k])).max()
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=TOL * scale)
