"""The port's U-DGD network and classification task against the
reference, on the CPU.

θ comes from the reference's ``init_udgd`` through the port's
``theta_from_numpy``; the random draws (W0 and the layer mini-batches)
are the reference's, fed to both packages through numpy. Tolerance 5e-5
(the reference's f32 kernel tolerance, ``tests/test_kernels.py``): the
two packages sum the perceptron product and the filter in different
orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import surf_paper as jcfgs
from repro.core import unroll as JU
from repro.core.tasks import resolve_task as jresolve_task
from repro.data import synthetic as jsyn
from repro.kernels.graph_filter import make_pallas_mix
from repro_torch.checkpoint.convert import theta_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import unroll as TU
from repro_torch.core.tasks import resolve_task as tresolve_task
from repro_torch.kernels.graph_filter import make_plain_mix
from repro_torch.topology.families import build_topology

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

TOL = 5e-5


def _problem(name, init="dgd", seed=0):
    jcfg, tcfg = getattr(jcfgs, name), getattr(tcfgs, name)
    theta = JU.init_udgd(jax.random.PRNGKey(seed), jcfg, init=init)
    _, S = build_topology(jcfg.topology, jcfg.n_agents, degree=jcfg.degree,
                          seed=seed)
    ds = jsyn.sample_dataset(jcfg, seed=100 + seed)
    batch = {k: jnp.asarray(v) for k, v in ds.items()}
    W0, Xl, Yl = (np.asarray(a) for a in JU.featurize_cohort(
        jax.random.PRNGKey(7 + seed), batch, jcfg))
    return jcfg, tcfg, theta, np.asarray(S, np.float32), W0, Xl, Yl


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


@pytest.mark.parametrize("name", ["SMOKE", "BENCH"])
@pytest.mark.parametrize("mix", [None, "pallas"])
def test_udgd_forward_matches_reference(name, mix):
    jcfg, tcfg, theta, S, W0, Xl, Yl = _problem(name)
    # Like for like: the reference's default mixer is its plain filter
    # and "pallas" its kernel; the port's default is its kernel path and
    # ``make_plain_mix`` its plain filter.
    jmix = make_pallas_mix() if mix else None
    tmix = None if mix else make_plain_mix()
    WLj, Wallj = JU.udgd_forward(theta, jnp.asarray(S), jnp.asarray(W0),
                                 jnp.asarray(Xl), jnp.asarray(Yl), jcfg,
                                 mix_fn=jmix)
    th = theta_from_numpy(jax.tree.map(np.asarray, theta), "cpu")
    WLt, Wallt = TU.udgd_forward(th, _t(S), _t(W0), _t(Xl),
                                 _t(Yl, torch.long), tcfg, mix_fn=tmix)
    assert Wallt.shape == (tcfg.n_layers + 1,) + W0.shape
    np.testing.assert_allclose(WLt.numpy(), np.asarray(WLj),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(Wallt.numpy(), np.asarray(Wallj),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_udgd_layer_random_init_matches_reference(activation):
    """One layer from the 'random' init (large h and M), both mixers."""
    jcfg, tcfg, theta, S, W0, Xl, Yl = _problem("SMOKE", init="random",
                                                seed=1)
    th = theta_from_numpy(jax.tree.map(np.asarray, theta), "cpu")
    pj = jax.tree.map(lambda a: a[0], theta)
    yj = JU.udgd_layer(pj, jnp.asarray(S), jnp.asarray(W0),
                       jnp.asarray(Xl[0]), jnp.asarray(Yl[0]), jcfg,
                       activation)
    for mix in (None, make_plain_mix()):
        yt = TU.udgd_layer(TU.layer_params(th, 0), _t(S), _t(W0),
                           _t(Xl[0]), _t(Yl[0], torch.long), tcfg,
                           activation, mix_fn=mix)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   atol=TOL, rtol=TOL)


def test_task_functions_match_reference():
    """CE loss, accuracy, the row-0 padded corrections and the
    perceptron's batch vector, per agent, against the reference's
    vmapped functions."""
    cfg = jcfgs.SMOKE
    jt, tt = jresolve_task(cfg), tresolve_task(tcfgs.SMOKE)
    rng = np.random.default_rng(0)
    n, t, t_real = cfg.n_agents, 6, 4.0
    W = rng.standard_normal((n, jt.dim)).astype(np.float32)
    X = rng.standard_normal((n, t, cfg.feature_dim)).astype(np.float32)
    Y = rng.integers(0, cfg.n_classes, (n, t)).astype(np.int32)
    X[:, 4:], Y[:, 4:] = X[:, :1], Y[:, :1]          # row-0 padding
    Wt, Xt, Yt = _t(W), _t(X), _t(Y, torch.long)
    for jf, tf in ((jt.local_loss, tt.local_loss),
                   (jt.local_metric, tt.local_metric)):
        np.testing.assert_allclose(tf(Wt, Xt, Yt).numpy(),
                                   np.asarray(jax.vmap(jf)(W, X, Y)),
                                   atol=TOL, rtol=TOL)
    for jf, tf in ((jt.padded_local_loss, tt.padded_local_loss),
                   (jt.padded_local_metric, tt.padded_local_metric)):
        want = jax.vmap(jf, in_axes=(0, 0, 0, None))(W, X, Y, t_real)
        np.testing.assert_allclose(tf(Wt, Xt, Yt, t_real).numpy(),
                                   np.asarray(want), atol=TOL, rtol=TOL)
        # the correction recovers the unpadded value
        np.testing.assert_allclose(
            tf(Wt, Xt, Yt, t_real).numpy(),
            (tt.local_loss if "loss" in jf.__name__ else tt.local_metric)(
                Wt[:, None], Xt[:, None, :4], Yt[:, None, :4])[:, 0].numpy(),
            atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(
        tt.batch_vector(Xt, Yt).numpy(), np.asarray(jt.batch_vector(X, Y)))


def test_init_udgd_shapes_and_dgd_point():
    cfg = tcfgs.SMOKE
    gen = torch.Generator().manual_seed(0)
    th = TU.init_udgd(gen, cfg, init="dgd")
    din = TU.perceptron_in_dim(cfg)
    d = cfg.head_dim
    assert th["h"].shape == (cfg.n_layers, cfg.filter_taps + 1)
    assert th["M"].shape == (cfg.n_layers, din, d)
    assert th["d"].shape == (cfg.n_layers, d) and not th["d"].any()
    # DGD point: one-hop mixing, small perceptron
    assert torch.allclose(th["h"][:, 1], torch.ones(cfg.n_layers), atol=0.05)
    assert th["M"].abs().max() < 0.1 * din ** -0.5 * 10
    rnd = TU.init_udgd(torch.Generator().manual_seed(0), cfg, init="random")
    assert rnd["M"].std() > 5 * th["M"].std()
    with pytest.raises(ValueError, match="init must be"):
        TU.init_udgd(gen, cfg, init="zeros")


def test_featurize_cohort_draws_and_injection():
    cfg = tcfgs.SMOKE
    task = tresolve_task(cfg)
    ds = jsyn.sample_dataset(jcfgs.SMOKE, seed=3)
    batch = task.to_batch(ds, "cpu")
    W0, Xl, Yl = TU.featurize_cohort(TU.solve_generator(0, 0, "cpu"),
                                     batch, cfg)
    L_, n, b = cfg.n_layers, cfg.n_agents, cfg.batch_per_agent
    assert W0.shape == (n, task.dim)
    assert Xl.shape == (L_, n, b, cfg.feature_dim) and Yl.shape == (L_, n, b)
    # every drawn row is one of the agent's own training rows
    for i in range(n):
        rows = {tuple(r) for r in batch["Xtr"][i].tolist()}
        drawn = Xl[:, i].reshape(-1, cfg.feature_dim).tolist()
        assert all(tuple(r) in rows for r in drawn)
    # the same (seed, q) gives the same draws; another q does not
    again = TU.featurize_cohort(TU.solve_generator(0, 0, "cpu"), batch, cfg)
    other = TU.featurize_cohort(TU.solve_generator(0, 1, "cpu"), batch, cfg)
    assert all(torch.equal(a, b) for a, b in zip((W0, Xl, Yl), again))
    assert not torch.equal(W0, other[0])
    injected = TU.featurize_cohort(None, batch, cfg,
                                   draws=(W0.numpy(), Xl.numpy(), Yl.numpy()))
    assert all(torch.equal(a, b) for a, b in zip((W0, Xl, Yl), injected))


def test_theta_from_numpy_validates():
    th = JU.init_udgd(jax.random.PRNGKey(0), jcfgs.SMOKE)
    th = jax.tree.map(np.asarray, th)
    out = theta_from_numpy(th, "cpu")
    assert all(torch.equal(out[k], torch.from_numpy(np.array(th[k])))
               for k in th)
    with pytest.raises(ValueError, match="keys"):
        theta_from_numpy({"h": th["h"], "M": th["M"]}, "cpu")
    with pytest.raises(ValueError, match="inconsistent"):
        theta_from_numpy(dict(th, d=th["d"][:1]), "cpu")


def test_unported_paths_raise():
    # the sparse-recovery task is ported: the config's task resolves,
    # and an unknown kind is refused as in the reference
    from repro_torch.core.tasks import SparseRecoveryTask
    task = tresolve_task(tcfgs.SPARSE_SMOKE)
    assert isinstance(task, SparseRecoveryTask) and task.dim == 16
    cfg = dataclasses.replace(tcfgs.SMOKE, task=type(
        "Bogus", (), {"kind": "nope"})())
    with pytest.raises(ValueError, match="unknown task kind"):
        tresolve_task(cfg)
    # a baked-S mixer (ring / halo) is called as mix_fn(W, h)
    baked = lambda W, h: 2 * W                              # noqa: E731
    W = torch.ones(2, 2)
    assert torch.equal(TU._mix(baked, None, W, torch.ones(2)), 2 * W)
    # star-topology layers are ported now: the star evaluation body runs
    from repro_torch.data.synthetic import sample_dataset
    from repro_torch.engine.core import _eval_core
    star = dataclasses.replace(tcfgs.SMOKE, topology="star")
    _, S = build_topology("star", star.n_agents, seed=0)
    out = _eval_core(star)(
        torch.from_numpy(np.asarray(S, np.float32)),
        TU.init_udgd(torch.Generator().manual_seed(0), star),
        tresolve_task(star).to_batch(sample_dataset(star, seed=0), "cpu"),
        TU.solve_generator(0, 0, "cpu"))
    assert out["loss_per_layer"].shape == (star.n_layers,)
    assert torch.isfinite(out["loss_per_layer"]).all()
