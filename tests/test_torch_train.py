"""The port's training slice against the reference, on the CPU: the
task's gradient lifts, the descending constraints and the Lagrangian's
meta-gradient, the optimizer, the meta-step, the training drivers and
``train_surf``.

Both packages run on the CPU at SMOKE size (and a cut of PAPER_STAR for
the star layers). Inputs come from numpy with a seed; the key-driven
draws (W0 and the layer mini-batches) are the reference's, recomputed as
its meta-step does (split the step key, ``sample_w0``,
``sample_layer_batches``) and handed to the port through numpy. States
cross through ``checkpoint.convert.state_from_numpy``.

Tolerances, each with its reason:

  * 5e-5 for the task gradients and grad norms: f32, sums in another
    order (the reference's f32 kernel tolerance, ``tests/test_kernels.py``);
  * 5e-4 for ∂Lagrangian/∂θ: a gradient through L layers and a
    grad-of-grad (the reference's VJP tolerance, ``tests/test_kernels.py``);
  * 5e-6 for θ, λ and the Adam moments after one meta-step and after a
    5-step run, and for the logged metrics (the reference's own training
    parity tolerance, ``tests/test_pallas_mix.py``). No entry needed a
    wider one: every gradient entry either vanishes in both packages
    (a ReLU that is off for every agent) or is far above the f32 noise
    that Adam's first, sign-like step (≈ −lr·sign(g)) would amplify.
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
from repro.core.tasks import resolve_task as jresolve_task
from repro.data import synthetic as jsyn
from repro.optim import adam as jadam
from repro.optim import clip_by_global_norm as jclip
from repro_torch.checkpoint.convert import state_from_numpy, theta_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import constraints as TC
from repro_torch.core import surf as tsurf
from repro_torch.core import unroll as TU
from repro_torch.core.tasks import resolve_task as tresolve_task
from repro_torch.engine import core as TE
from repro_torch.engine import scan as TS
from repro_torch.kernels.graph_filter import ops
from repro_torch.launch.mesh import make_surf_mesh
from repro_torch.optim import adam as tadam
from repro_torch.optim import clip_by_global_norm as tclip

GRAD_TOL = 5e-5
LAG_TOL = 5e-4
STATE_TOL = 5e-6

# A cut of PAPER_STAR (n=100, F=512, L=10): the paper's star variant
# (K=1, eps 0.1, lr 1e-3) at test size.
STAR = dict(n_agents=12, n_layers=3, feature_dim=8, n_classes=4,
            batch_per_agent=4, train_per_agent=8, test_per_agent=4)


def _cfgs(name):
    if name == "STAR":
        return (dataclasses.replace(jcfgs.PAPER_STAR, **STAR),
                dataclasses.replace(tcfgs.PAPER_STAR, **STAR))
    return getattr(jcfgs, name), getattr(tcfgs, name)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _tbatch(ds, tcfg):
    return tresolve_task(tcfg).to_batch(ds, "cpu")


def _draws(jcfg, ds, key):
    """The reference meta-step's draws from its step key."""
    kw, kb = jax.random.split(key)
    W0 = JU.sample_w0(kw, jcfg)
    Xl, Yl = JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), jcfg)
    return tuple(np.asarray(a) for a in (W0, Xl, Yl))


def _port_state(jstate):
    s = _np(jstate)
    return state_from_numpy(s.theta, s.lam, s.opt_state, int(s.step), "cpu")


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _state_close(tstate, jstate, tol=STATE_TOL):
    js = _np(jstate)
    for k in js.theta:
        _close(tstate.theta[k].numpy(), js.theta[k], tol, f"theta.{k}")
        for mom in ("m", "v"):
            _close(tstate.opt_state[mom][k].numpy(), js.opt_state[mom][k],
                   tol, f"opt_state.{mom}.{k}")
    _close(tstate.lam.numpy(), js.lam, tol, "lam")
    assert int(tstate.opt_state["t"]) == int(js.opt_state["t"])
    assert tstate.step == int(js.step)


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = _cfgs("SMOKE")
    _, S = jsurf.make_problem(jcfg, seed=0)
    mds = jsyn.make_meta_dataset(jcfg, 3, seed=0)
    return jcfg, tcfg, np.asarray(S), mds


# ------------------------------------------------------ task gradient lifts
def test_task_gradients_match_reference():
    jcfg, tcfg = _cfgs("SMOKE")
    jt, tt = jresolve_task(jcfg), tresolve_task(tcfg)
    rng = np.random.default_rng(0)
    n, b = tcfg.n_agents, tcfg.batch_per_agent
    W = (0.3 * rng.standard_normal((2, n, tt.dim))).astype(np.float32)
    X = rng.standard_normal((2, n, b, tt.feat_dim)).astype(np.float32)
    Y = rng.integers(0, tcfg.n_classes, (2, n, b))
    mask = np.arange(n) < n - 3
    Wt = _t(W).requires_grad_(True)
    Xt, Yt, mt = _t(X), _t(Y, torch.long), torch.from_numpy(mask)
    gt = tt.fl_grad(Wt, Xt, Yt)
    nt = tt.grad_norm(Wt, Xt, Yt)
    mnt = tt.masked_grad_norm(Wt, Xt, Yt, mt)
    assert gt.shape == W.shape and nt.shape == mnt.shape == (2,)
    # the norm is differentiable in W (the constraints' grad-of-grad)
    (dnt,) = torch.autograd.grad(nt.sum(), Wt)
    for i in range(2):                       # a leading batch axis
        args = (jnp.asarray(W[i]), jnp.asarray(X[i]), jnp.asarray(Y[i]))
        _close(gt[i].detach().numpy(), jt.fl_grad(*args), GRAD_TOL,
               "fl_grad")
        _close(nt[i].item(), jt.grad_norm(*args), GRAD_TOL, "grad_norm")
        _close(mnt[i].item(), jt.masked_grad_norm(*args, jnp.asarray(mask)),
               GRAD_TOL, "masked_grad_norm")
        _close(dnt[i].numpy(), jax.grad(jt.grad_norm)(*args), GRAD_TOL,
               "d grad_norm / dW")
    # without a gradient to record, the lifts return plain values
    with torch.no_grad():
        plain = tt.grad_norm(Wt, Xt, Yt)
    assert not plain.requires_grad
    _close(plain.numpy(), nt.detach().numpy(), 0, "no_grad grad_norm")


# ------------------------------------------------ constraints, Lagrangian
def _forward_inputs(jcfg, seed=0, init="random"):
    theta = JU.init_udgd(jax.random.PRNGKey(seed), jcfg, init=init)
    _, S = jsurf.make_problem(jcfg, seed=seed)
    ds = jsyn.sample_dataset(jcfg, seed=100 + seed)
    draws = _draws(jcfg, ds, jax.random.PRNGKey(7 + seed))
    return theta, np.asarray(S), ds, draws


def test_constraints_match_reference():
    jcfg, tcfg = _cfgs("SMOKE")
    theta, S, ds, (W0, Xl, Yl) = _forward_inputs(jcfg)
    _, W_all = JU.udgd_forward(theta, jnp.asarray(S), jnp.asarray(W0),
                               jnp.asarray(Xl), jnp.asarray(Yl), jcfg)
    g_j = JC.layer_grad_norms(W_all, jnp.asarray(Xl), jnp.asarray(Yl), jcfg)
    g_t = TC.layer_grad_norms(_t(W_all), _t(Xl), _t(Yl, torch.long), tcfg)
    assert g_t.shape == (tcfg.n_layers + 1,)
    _close(g_t.numpy(), g_j, GRAD_TOL, "layer_grad_norms")
    # the rest on identical inputs
    g = np.asarray(g_j)
    lam = np.linspace(0.0, 0.7, tcfg.n_layers).astype(np.float32)
    sl_j = JC.slacks(jnp.asarray(g), jcfg.eps)
    sl_t = TC.slacks(_t(g), tcfg.eps)
    _close(sl_t.numpy(), sl_j, 1e-6, "slacks")
    _close(TC.lagrangian(_t(0.8), sl_t, _t(lam)).item(),
           JC.lagrangian(0.8, sl_j, jnp.asarray(lam)), 1e-6, "lagrangian")
    _close(TC.dual_ascent(_t(lam), sl_t, 0.5).numpy(),
           JC.dual_ascent(jnp.asarray(lam), sl_j, 0.5), 1e-6, "dual_ascent")
    assert (TC.dual_ascent(_t(lam), -10 * sl_t.abs(), 1.0) >= 0).all()


@pytest.mark.parametrize("name", ["SMOKE", "STAR"])
def test_lagrangian_meta_gradient_matches_jax_grad(name):
    """∂L̂/∂θ with λ > 0, so the slack terms (grad-of-grad through
    ‖∇_W f‖) carry weight; the reference's Lagrangian is built from its
    public functions."""
    jcfg, tcfg = _cfgs(name)
    theta, S, ds, (W0, Xl, Yl) = _forward_inputs(jcfg)
    lam = np.linspace(0.5, 2.0, tcfg.n_layers).astype(np.float32)
    jt = jresolve_task(jcfg)
    star = jcfg.topology == "star"
    jlayer = JU.udgd_layer_star if star else JU.udgd_layer

    def jlag(theta):
        W = jnp.asarray(W0)
        Ws = [W]
        for l in range(jcfg.n_layers):
            W = jlayer({k: v[l] for k, v in theta.items()}, jnp.asarray(S),
                       W, jnp.asarray(Xl[l]), jnp.asarray(Yl[l]), jcfg)
            Ws.append(W)
        tl = jt.fl_loss(W, jnp.asarray(ds["Xte"]), jnp.asarray(ds["Yte"]))
        g = JC.layer_grad_norms(jnp.stack(Ws), jnp.asarray(Xl),
                                jnp.asarray(Yl), jcfg)
        return JC.lagrangian(tl, JC.slacks(g, jcfg.eps), jnp.asarray(lam))

    jg = jax.grad(jlag)(theta)
    th = {k: v.requires_grad_(True)
          for k, v in theta_from_numpy(_np(theta), "cpu").items()}
    _, forward = TE.make_meta_step(tcfg, _t(S))
    W_L, W_all = forward(th, _t(W0), _t(Xl), _t(Yl, torch.long))
    tt = tresolve_task(tcfg)
    batch = _tbatch(ds, tcfg)
    tl = tt.fl_loss(W_L, batch["Xte"], batch["Yte"])
    g = TC.layer_grad_norms(W_all, _t(Xl), _t(Yl, torch.long), tcfg)
    lag = TC.lagrangian(tl, TC.slacks(g, tcfg.eps), _t(lam))
    _close(lag.item(), jlag(theta), GRAD_TOL, "lagrangian")
    tg = torch.autograd.grad(lag, list(th.values()))
    for k, gk in zip(th, tg):
        assert np.abs(np.asarray(jg[k])).max() > 1e-3    # not a zero check
        _close(gk.numpy(), jg[k], LAG_TOL, f"dL/d{k}")


# --------------------------------------------------------------- optimizer
def test_adam_and_clip_match_reference():
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    for max_norm in (0.5, 1e3):                   # clipping and not
        cj, nj = jclip(jax.tree.map(jnp.asarray, grads[0]), max_norm)
        ct, nt = tclip({k: _t(v) for k, v in grads[0].items()}, max_norm)
        _close(nt.item(), nj, 1e-6, "global norm")
        for k in params:
            _close(ct[k].numpy(), cj[k], 1e-6, f"clipped {k}")
    oj, ot = jadam(1e-2), tadam(1e-2)
    pj = jax.tree.map(jnp.asarray, params)
    pt = {k: _t(v) for k, v in params.items()}
    sj, st = oj.init(pj), ot.init(pt)
    for g in grads:
        uj, sj = oj.update(jax.tree.map(jnp.asarray, g), sj)
        ut, st = ot.update({k: _t(v) for k, v in g.items()}, st)
        for k in params:
            _close(ut[k].numpy(), uj[k], 1e-6, f"update {k}")
            _close(st["m"][k].numpy(), sj["m"][k], 1e-6, f"m {k}")
            _close(st["v"][k].numpy(), sj["v"][k], 1e-6, f"v {k}")
        assert int(st["t"]) == int(sj["t"])
        assert st["t"].dtype == torch.int32


# --------------------------------------------------------------- meta-step
@pytest.mark.parametrize("start", ["init", "trained"])
@pytest.mark.parametrize("name", ["SMOKE", "STAR"])
def test_one_meta_step_matches_reference(name, start):
    """One meta-step from one state (the reference's, converted), on the
    reference's draws: θ, λ, the Adam state and every metric agree. From
    "trained" (3 reference steps), λ > 0 and Adam's t = 3."""
    jcfg, tcfg = _cfgs(name)
    _, S = jsurf.make_problem(jcfg, seed=0)
    mds = jsyn.make_meta_dataset(jcfg, 3, seed=0)
    key = jax.random.PRNGKey(0)
    if start == "init":
        jstate = JE.init_state(key, jcfg)
    else:
        jstate, _ = JE.train(jcfg, S, mds, 3, key)
        assert float(jnp.sum(jstate.lam)) > 0
    ds, step_key = mds[1], jax.random.PRNGKey(42)
    jstep, _ = JE.make_meta_step(jcfg, S)
    jnext, jm = jstep(jstate, jax.tree.map(jnp.asarray, ds), step_key)
    tstep, _ = TE.make_meta_step(tcfg, _t(S))
    tnext, tm = tstep(_port_state(jstate), _tbatch(ds, tcfg),
                      draws=_draws(jcfg, ds, step_key))
    _state_close(tnext, jnext)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k].item(), jm[k], STATE_TOL, f"metric {k}")


def test_meta_step_filter_calls(smoke, monkeypatch):
    """One meta-step runs the filter's forward L times and its dW
    backward L−1 times: W_0 carries no gradient, and the constraints'
    grad-of-grad never goes through the filter. (On the card these are
    the kernel's ``launches`` and ``bwd_launches``.)"""
    jcfg, tcfg, S, mds = smoke
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(ops, "_filter", counted(ops._filter, "fwd"))
    monkeypatch.setattr(ops, "graph_filter_bwd",
                        counted(ops.graph_filter_bwd, "bwd"))
    state = TE.init_state(torch.Generator().manual_seed(0), tcfg)
    step, _ = TE.make_meta_step(tcfg, _t(S))
    step(state, _tbatch(mds[0], tcfg), TU.step_generator(0, 0, "cpu"))
    assert calls == {"fwd": tcfg.n_layers, "bwd": tcfg.n_layers - 1}


# ----------------------------------------------------------------- drivers
@pytest.mark.parametrize("driver", ["train", "train_scan"])
def test_five_step_training_matches_reference(smoke, driver):
    """Five meta-steps of the reference's step-wise ``train`` against the
    port's drivers, from the reference's initial state and replaying its
    per-step ``fold_in`` draws."""
    jcfg, tcfg, S, mds = smoke
    key = jax.random.PRNGKey(3)
    jstate, jhist = JE.train(jcfg, S, mds, 5, key, log_every=1)
    draws = [_draws(jcfg, mds[t % len(mds)], jax.random.fold_in(key, t))
             for t in range(5)]
    tstate, thist = getattr(TS, driver)(
        tcfg, S, mds, 5, log_every=1, device="cpu",
        state=_port_state(JE.init_state(key, jcfg)), draws=draws)
    _state_close(tstate, jstate)
    assert len(thist) == len(jhist) == 5
    for tr, jr in zip(thist, jhist):
        assert tr["step"] == jr["step"] and set(tr) == set(jr)
        for k in jr:
            _close(tr[k], jr[k], STATE_TOL, f"step {jr['step']} {k}")


@pytest.mark.parametrize("engine", ["scan", "python"])
def test_train_surf_returns_reference_history(smoke, engine):
    jcfg, tcfg, S, mds = smoke
    _, jhist, _ = jsurf.train_surf(jcfg, mds, steps=3, log_every=1,
                                   engine=engine)
    state, hist, S_t = tsurf.train_surf(tcfg, mds, steps=3, log_every=1,
                                        engine=engine, device="cpu")
    assert [set(r) for r in hist] == [set(r) for r in jhist]
    assert [r["step"] for r in hist] == [r["step"] for r in jhist]
    assert state.step == 3 and int(state.opt_state["t"]) == 3
    np.testing.assert_array_equal(S_t.numpy(), S)
    assert all(np.isfinite(r["test_loss"]) for r in hist)


def test_train_drivers_agree_and_follow_step_generator(smoke):
    """Both drivers draw meta-step t from ``step_generator(seed, t)`` and
    land on the same state; a run resumed from step 2 continues the
    stream exactly."""
    jcfg, tcfg, S, mds = smoke
    a, ha = TS.train_scan(tcfg, S, mds, 4, seed=5, log_every=2,
                          device="cpu")
    b, hb = TS.train(tcfg, S, mds, 4, seed=5, log_every=2, device="cpu")
    mid, _ = TS.train(tcfg, S, mds, 2, seed=5, device="cpu")
    c, _ = TS.train_scan(tcfg, S, mds, 2, seed=5, device="cpu", state=mid)
    for k in a.theta:
        torch.testing.assert_close(a.theta[k], b.theta[k], rtol=0, atol=0)
        torch.testing.assert_close(a.theta[k], c.theta[k], rtol=0, atol=0)
    assert [r["step"] for r in ha] == [r["step"] for r in hb] == [0, 2, 3]
    assert ha[-1]["test_loss"] == hb[-1]["test_loss"]


def test_step_generator_is_apart_from_solve_generator():
    a = TU.step_generator(0, 0, "cpu").initial_seed()
    assert a == TU.STEP_SEED_BASE
    b = TU.step_generator(3, 7, "cpu").initial_seed()
    assert b == a + 3 * 1_000_003 + 7
    assert TU.solve_generator(10 ** 12, 10 ** 6, "cpu").initial_seed() < a
    draw = lambda g: torch.randn(4, generator=g)      # noqa: E731
    assert not torch.equal(draw(TU.step_generator(0, 0, "cpu")),
                           draw(TU.solve_generator(0, 0, "cpu")))


# ------------------------------------------------------------------- star
def test_udgd_layer_star_matches_reference():
    jcfg, tcfg = _cfgs("STAR")
    theta, S, ds, (W0, Xl, Yl) = _forward_inputs(jcfg)
    p_j = {k: v[0] for k, v in theta.items()}
    p_t = {k: _t(v) for k, v in _np(p_j).items()}
    yj = JU.udgd_layer_star(p_j, jnp.asarray(S), jnp.asarray(W0),
                            jnp.asarray(Xl[0]), jnp.asarray(Yl[0]), jcfg)
    yt = TU.udgd_layer_star(p_t, _t(S), _t(W0), _t(Xl[0]),
                            _t(Yl[0], torch.long), tcfg)
    _close(yt.numpy(), yj, GRAD_TOL, "udgd_layer_star")
    np.testing.assert_array_equal(TU.star_filter_mask(tcfg).numpy(),
                                  np.asarray(JU.star_filter_mask(jcfg)))
    assert TU.star_filter_mask(tcfgs.SMOKE).min() == 1.0


def test_evaluate_surf_seeds_stack_single_seed_calls(smoke):
    jcfg, tcfg, S, mds = smoke
    state = TE.init_state(torch.Generator().manual_seed(0), tcfg)
    multi = tsurf.evaluate_surf(tcfg, state, S, mds, seeds=(0, 2),
                                device="cpu")
    for i, s in enumerate((0, 2)):
        one = tsurf.evaluate_surf(tcfg, state, S, mds, seed=s, device="cpu")
        for k in one:
            np.testing.assert_array_equal(multi[k][i], one[k])
    assert multi["acc_per_layer"].shape == (2, tcfg.n_layers)
    # make_eval binds S to the same body evaluate_surf runs per dataset
    ev = TE.make_eval(tcfg, _t(S))
    with torch.no_grad():
        out = ev(state.theta, _tbatch(mds[1], tcfg),
                 TU.solve_generator(2, 1, "cpu"))
    one = tsurf.evaluate_surf(tcfg, state, S, mds[1:2], seed=2, device="cpu",
                              draws=[TU.featurize_cohort(
                                  TU.solve_generator(2, 1, "cpu"),
                                  _tbatch(mds[1], tcfg), tcfg)])
    np.testing.assert_allclose(out["acc_per_layer"].numpy(),
                               one["acc_per_layer"], atol=0, rtol=0)


def test_state_from_numpy_validates(smoke):
    jcfg, tcfg, S, mds = smoke
    s = _np(JE.init_state(jax.random.PRNGKey(0), jcfg))
    st = state_from_numpy(s.theta, s.lam, s.opt_state, 4, "cpu")
    assert st.step == 4 and st.opt_state["m"]["M"].dtype == torch.float32
    with pytest.raises(ValueError, match="lam"):
        state_from_numpy(s.theta, s.lam[:1], s.opt_state, 0, "cpu")
    with pytest.raises(ValueError, match="m, v, t"):
        state_from_numpy(s.theta, s.lam, {"m": s.opt_state["m"]}, 0, "cpu")
    bad = dict(s.opt_state, v=dict(s.opt_state["v"], d=s.opt_state["v"]["h"]))
    with pytest.raises(ValueError, match="inconsistent|shape"):
        state_from_numpy(s.theta, s.lam, bad, 0, "cpu")


# ------------------------------------------------------ not ported: raises
@pytest.mark.parametrize("option,value,item", [
    ("mesh", object(), 8), ("q_sharded", True, 8),
    ("seeds", (0, 1), 7), ("eval_every", 5, 7),
    ("eval_datasets", [], 7), ("checkpoint_every", 5, 7),
    ("checkpoint_dir", "ckpt", 7)])
def test_unported_train_options_raise(smoke, option, value, item, tmp_path):
    """Every option is ported now. Alone, each runs or is refused as the
    reference refuses it: a cadence without its pool or directory,
    ``q_sharded`` without a mesh; ``mesh`` (item 8) trains on the mesh's
    home device."""
    jcfg, tcfg, S, mds = smoke
    if option == "q_sharded":
        with pytest.raises(ValueError, match="q_sharded=True needs mesh"):
            tsurf.train_surf(tcfg, mds, steps=1, device="cpu",
                             **{option: value})
        return
    if option == "mesh":
        value = make_surf_mesh(1, 2, devices=["cpu"] * 2)
    refusals = {"eval_every": "eval_datasets",
                "checkpoint_every": "checkpoint_dir"}
    if option in refusals:
        with pytest.raises(ValueError, match=refusals[option]):
            tsurf.train_surf(tcfg, mds, steps=1, device="cpu",
                             **{option: value})
        return
    if option == "checkpoint_dir":
        value = str(tmp_path / value)
    state, hist, S_out = tsurf.train_surf(tcfg, mds, steps=1, device="cpu",
                                          log_every=1, **{option: value})
    assert state.step == 1
    if option == "seeds":
        assert S_out.shape == (2, tcfg.n_agents, tcfg.n_agents)
        assert hist[0]["test_loss"].shape == (2,)
    if option == "checkpoint_dir":
        assert not (tmp_path / "ckpt").exists()     # no cadence, no save


def test_unported_training_paths_raise(smoke):
    """RSDUN (item 5) is ported: a robust meta-step needs its
    perturbations. The halo mixers (item 8) are ported with the
    reference's guards: a seed-batched mixer is refused by the
    single-seed builders, a scheduled one by the unbound forward, and a
    halo name needs a mesh."""
    jcfg, tcfg, S, mds = smoke
    robust = dataclasses.replace(tcfg, robust_sigma=0.1)
    step, _ = TE.make_meta_step(robust, _t(S))
    state = TE.init_state(torch.Generator().manual_seed(0), robust)
    with pytest.raises(ValueError, match="delta_generator"):
        step(state, _tbatch(mds[0], tcfg), TU.step_generator(0, 0, "cpu"))
    with pytest.raises(ValueError, match="deltas must"):
        TC.robust_layer_grad_norms(torch.zeros(5, 8, 36), None, None,
                                   robust, torch.zeros(1),
                                   nominal=torch.zeros(5))
    for attr, match in (("seed_batched", "single-seed"),
                        ("scheduled", "step counter")):
        mix = lambda S, W, h: W                        # noqa: E731
        mix.takes_S = True
        setattr(mix, attr, True)
        with pytest.raises(ValueError, match=match):
            _, forward = TE.make_meta_step(tcfg, _t(S), mix_fn=mix)
            forward(state.theta, None, None, None)
    with pytest.raises(ValueError, match="needs mesh="):
        tsurf.train_surf(tcfg, mds, steps=1, mix="halo", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tsurf.train_surf(tcfg, mds, steps=1, engine="jit", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tsurf.train_surf(tcfg, mds, steps=1, mix="cuda",
                         mix_fn=lambda S, W, h: W, device="cpu")
