"""The port's RSDUN robust descending constraints (ROADMAP item 5)
against the reference, on the CPU at SMOKE size (and SPARSE_SMOKE for
the sparse task): the perturbation-sampled grad norms and slacks on the
same δ, σ = 0 equal to the nominal constraints, the robust slack above
the nominal one, robust meta-steps and a 3-step robust run on replayed
W0, mini-batches and δ, the perturbation stream apart from the step
stream, and the cache key.

The reference splits its step key in three when robust (W0, batches,
δ); the tests recompute those draws and hand them to the port through
numpy (``draws=``, ``deltas=``).

Tolerances: 5e-5 for grad norms and slacks (f32, sums in another order;
``tests/test_kernels.py``), 5e-6 for θ, λ, the Adam moments and the
metrics after a meta-step (``tests/test_pallas_mix.py``), as in
``tests/test_torch_train.py``. Runs of the port against itself are held
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import surf_paper as jcfgs
from repro.core import constraints as JC
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.core.tasks import resolve_task as jresolve
from repro.data import synthetic as jsyn
from repro_torch.checkpoint.convert import state_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import constraints as TC
from repro_torch.core import surf as tsurf
from repro_torch.core import unroll as TU
from repro_torch.core.tasks import resolve_task as tresolve
from repro_torch.engine import core as TE
from repro_torch.engine import scan as TS

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

GRAD_TOL, STATE_TOL = 5e-5, 5e-6
ROBUST = dict(robust_sigma=0.1, robust_samples=2)   # tests/test_tasks.py


def _cfgs(name, **kw):
    return (dataclasses.replace(getattr(jcfgs, name), **kw),
            dataclasses.replace(getattr(tcfgs, name), **kw))


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate):
    s = _np(jstate)
    return state_from_numpy(s.theta, s.lam, s.opt_state, int(s.step), "cpu")


def _ref_deltas(key, shape, n_pert):
    """The reference's δ: normal(split(key, n_pert)[j], W_all.shape)."""
    return np.stack([np.asarray(jax.random.normal(k, shape))
                     for k in jax.random.split(key, n_pert)])


def _norm_inputs(jcfg, seed=0):
    """W_all (L+1, n, d), Xl, Yl from a reference forward."""
    theta = JU.init_udgd(jax.random.PRNGKey(seed), jcfg, init="random")
    _, S = jsurf.make_problem(jcfg, seed=seed)
    ds = jresolve(jcfg).synth_datasets(jcfg, 1, seed=100 + seed)[0]
    kw, kb = jax.random.split(jax.random.PRNGKey(7 + seed))
    W0 = JU.sample_w0(kw, jcfg)
    Xl, Yl = JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), jcfg)
    _, W_all = JU.udgd_forward(theta, S, W0, Xl, Yl, jcfg)
    return W_all, Xl, Yl


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


@pytest.mark.parametrize("sigma,samples", [(0.1, 2), (0.5, 3)])
@pytest.mark.parametrize("name", ["SMOKE", "SPARSE_SMOKE"])
def test_robust_norms_and_slacks_match_reference(name, sigma, samples):
    jcfg, tcfg = _cfgs(name, robust_sigma=sigma, robust_samples=samples)
    W_all, Xl, Yl = _norm_inputs(jcfg)
    key = jax.random.PRNGKey(11)
    g_nom = JC.layer_grad_norms(W_all, Xl, Yl, jcfg)
    g_rob = JC.robust_layer_grad_norms(W_all, Xl, Yl, jcfg, key)
    deltas = _ref_deltas(key, W_all.shape, samples)
    ydt = tresolve(tcfg).label_dtype
    Wt = _t(W_all).requires_grad_(True)
    Xt, Yt = _t(Xl), _t(Yl, ydt)
    t_nom = TC.layer_grad_norms(Wt, Xt, Yt, tcfg)
    t_rob = TC.robust_layer_grad_norms(Wt, Xt, Yt, tcfg, _t(deltas),
                                       nominal=t_nom)
    _close(t_rob.detach().numpy(), g_rob, GRAD_TOL, "robust norms")
    _close(TC.robust_slacks(t_rob, t_nom, tcfg.eps).detach().numpy(),
           JC.robust_slacks(g_rob, g_nom, jcfg.eps), GRAD_TOL,
           "robust slacks")
    # the perturbed norms are differentiable in W (grad-of-grad); layer
    # 0 is W0, whose θ-gradient is zero, so the port's nominal norm there
    # is a plain value (``layer_grad_norms``) and only layers 1..L count
    (dW,) = torch.autograd.grad(t_rob.sum(), Wt)
    jdW = jax.grad(lambda W: JC.robust_layer_grad_norms(
        W, Xl, Yl, jcfg, key).sum())(W_all)
    _close(dW[1:].numpy(), jdW[1:], GRAD_TOL, "d robust norms / dW")


@pytest.mark.parametrize("name", ["SMOKE", "SPARSE_SMOKE"])
def test_robust_equals_nominal_at_sigma_zero(name):
    jcfg, tcfg = _cfgs(name, robust_sigma=0.0, robust_samples=4)
    W_all, Xl, Yl = _norm_inputs(jcfg, seed=1)
    ydt = tresolve(tcfg).label_dtype
    args = (_t(W_all), _t(Xl), _t(Yl, ydt))
    nom = TC.layer_grad_norms(*args, tcfg)
    rob = TC.robust_layer_grad_norms(*args, tcfg, None)   # δ not read
    assert torch.equal(rob, nom)
    assert torch.equal(TC.robust_slacks(rob, nom, tcfg.eps),
                       TC.slacks(nom, tcfg.eps))
    assert not TC.robust_enabled(tcfg)
    assert not TC.robust_enabled(dataclasses.replace(
        tcfg, robust_sigma=0.3, robust_samples=0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_robust_slack_upper_bounds_nominal(seed):
    jcfg, tcfg = _cfgs("SMOKE", robust_sigma=0.5, robust_samples=3)
    W_all, Xl, Yl = _norm_inputs(jcfg, seed=seed)
    args = (_t(W_all), _t(Xl), _t(Yl, torch.long))
    gen = TU.robust_generator(seed, 0, "cpu")
    deltas = TU.sample_deltas(gen, tcfg, device="cpu")
    nom = TC.layer_grad_norms(*args, tcfg)
    rob = TC.robust_layer_grad_norms(*args, tcfg, deltas, nominal=nom)
    assert (rob >= nom).all()
    assert (TC.robust_slacks(rob, nom, tcfg.eps)
            >= TC.slacks(nom, tcfg.eps) - 1e-7).all()


def _robust_step_draws(jcfg, ds, key):
    """The reference's robust meta-step draws: kw, kb, kp = split(key, 3)."""
    kw, kb, kp = jax.random.split(key, 3)
    W0 = JU.sample_w0(kw, jcfg)
    Xl, Yl = JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), jcfg)
    shape = (jcfg.n_layers + 1,) + tuple(W0.shape)
    return (tuple(np.asarray(a) for a in (W0, Xl, Yl)),
            _ref_deltas(kp, shape, jcfg.robust_samples))


@pytest.mark.parametrize("start", ["init", "trained"])
@pytest.mark.parametrize("name", ["SMOKE", "SPARSE_SMOKE"])
def test_robust_meta_step_matches_reference(name, start):
    jcfg, tcfg = _cfgs(name, **ROBUST)
    _, S = jsurf.make_problem(jcfg, seed=0)
    mds = jresolve(jcfg).synth_datasets(jcfg, 3, seed=0)
    key = jax.random.PRNGKey(0)
    jstate = JE.init_state(key, jcfg)
    if start == "trained":
        jstate, _ = JE.train(jcfg, S, mds, 3, key)
    ds, step_key = mds[1], jax.random.PRNGKey(42)
    jnext, jm = JE.make_meta_step(jcfg, S)[0](
        jstate, jax.tree.map(jnp.asarray, ds), step_key)
    draws, deltas = _robust_step_draws(jcfg, ds, step_key)
    tnext, tm = TE.make_meta_step(tcfg, _t(S))[0](
        _port_state(jstate), tresolve(tcfg).to_batch(ds, "cpu"),
        draws=draws, deltas=deltas)
    js = _np(jnext)
    for k in js.theta:
        _close(tnext.theta[k].numpy(), js.theta[k], STATE_TOL, f"theta.{k}")
        _close(tnext.opt_state["m"][k].numpy(), js.opt_state["m"][k],
               STATE_TOL, f"m.{k}")
    _close(tnext.lam.numpy(), js.lam, STATE_TOL, "lam")
    for k in jm:
        _close(tm[k].item(), jm[k], STATE_TOL, f"metric {k}")


def test_robust_three_step_run_matches_reference():
    jcfg, tcfg = _cfgs("SMOKE", **ROBUST)
    _, S = jsurf.make_problem(jcfg, seed=0)
    mds = jsyn.make_meta_dataset(jcfg, 3, seed=0)
    key = jax.random.PRNGKey(5)
    jstate, jhist = JE.train(jcfg, S, mds, 3, key, log_every=1)
    rec = [_robust_step_draws(jcfg, mds[t % 3], jax.random.fold_in(key, t))
           for t in range(3)]
    tstate, thist = TS.train_scan(
        tcfg, S, mds, 3, log_every=1, device="cpu",
        state=_port_state(JE.init_state(key, jcfg)),
        draws=[r[0] for r in rec], deltas=[r[1] for r in rec])
    js = _np(jstate)
    for k in js.theta:
        _close(tstate.theta[k].numpy(), js.theta[k], STATE_TOL, k)
    for tr, jr in zip(thist, jhist):
        for k in jr:
            _close(tr[k], jr[k], STATE_TOL, f"step {jr['step']} {k}")


def test_robust_stream_leaves_the_default_stream_untouched():
    """σ = 0 with samples trains the default trajectory bit for bit; a
    robust run draws W0 and the mini-batches of the nominal run (its δ
    come from ``robust_generator``), and replaying those δ reproduces it."""
    _, tcfg = _cfgs("SMOKE")
    mds = tsyn_pool(tcfg)
    _, S = tsurf.make_problem(tcfg, 0, device="cpu")
    base, _ = TS.train_scan(tcfg, S, mds, 4, seed=2, device="cpu")
    zero, _ = TS.train_scan(dataclasses.replace(
        tcfg, robust_sigma=0.0, robust_samples=4), S, mds, 4, seed=2,
        device="cpu")
    for k in base.theta:
        assert torch.equal(base.theta[k], zero.theta[k])
    rcfg = dataclasses.replace(tcfg, **ROBUST)
    rob, _ = TS.train_scan(rcfg, S, mds, 4, seed=2, device="cpu")
    assert not torch.equal(rob.theta["h"], base.theta["h"])
    pool = tresolve(tcfg).to_batch(
        {k: np.stack([d[k] for d in mds]) for k in mds[0]}, "cpu")
    draws = [TU.featurize_cohort(TU.step_generator(2, t, "cpu"),
                                 {k: v[t % 3] for k, v in pool.items()},
                                 tcfg) for t in range(4)]
    deltas = [TU.sample_deltas(TU.robust_generator(2, t, "cpu"), rcfg)
              for t in range(4)]
    replay, _ = TS.train_scan(rcfg, S, mds, 4, seed=2, device="cpu",
                              draws=draws, deltas=deltas)
    for k in rob.theta:
        assert torch.equal(rob.theta[k], replay.theta[k])
    seeds = {TU.step_generator(2, 3, "cpu").initial_seed(),
             TU.robust_generator(2, 3, "cpu").initial_seed(),
             TU.snapshot_generator(2, 3, 0, "cpu").initial_seed(),
             TU.solve_generator(2, 3, "cpu").initial_seed()}
    assert len(seeds) == 4


def tsyn_pool(tcfg):
    from repro_torch.data.synthetic import make_meta_dataset
    return make_meta_dataset(tcfg, 3, seed=0)


def test_robust_flag_separates_cache_keys():
    _, tcfg = _cfgs("SMOKE")
    rob = dataclasses.replace(tcfg, robust_sigma=0.1)
    assert (TE._engine_cache_key(rob, "train", "relu", None)
            != TE._engine_cache_key(tcfg, "train", "relu", None))
    assert (TE._engine_cache_key(rob, "train", "relu")
            == TE._engine_cache_key(dataclasses.replace(rob), "train",
                                    "relu"))
    with pytest.raises(ValueError, match="deltas must have shape"):
        TU.sample_deltas(None, rob, deltas=np.zeros((1, 2, 3)))


def test_robust_meta_step_calls_the_filter_as_the_nominal_one(monkeypatch):
    """The perturbed norms' grad-of-grad goes through the task's loss
    only: a robust meta-step runs the filter's forward L times and its
    dW backward L−1 times, as a nominal one."""
    from repro_torch.kernels.graph_filter import ops
    _, tcfg = _cfgs("SMOKE", **ROBUST)
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(ops, "_filter", counted(ops._filter, "fwd"))
    monkeypatch.setattr(ops, "graph_filter_bwd",
                        counted(ops.graph_filter_bwd, "bwd"))
    _, S = tsurf.make_problem(tcfg, 0, device="cpu")
    state = TE.init_state(torch.Generator().manual_seed(0), tcfg)
    step, _ = TE.make_meta_step(tcfg, S)
    step(state, tresolve(tcfg).to_batch(tsyn_pool(tcfg)[0], "cpu"),
         TU.step_generator(0, 0, "cpu"),
         delta_generator=TU.robust_generator(0, 0, "cpu"))
    assert calls == {"fwd": tcfg.n_layers, "bwd": tcfg.n_layers - 1}
