"""The port's asynchronous-agent study (paper Fig. 8, App. D) against the
reference, on the CPU: ``async_masks``, ``make_async_run`` and
``evaluate_async``.

Both packages run at SMOKE size, a cut of PAPER_STAR (the star layers)
and BENCH width (n = 100, F = 64). The masks are numpy in both packages
and held bit for bit. The key-driven draws (W0 and the layer
mini-batches) are the reference's, recomputed from its keys
(``fold_in(PRNGKey(2000 + seed), q)``, then ``featurize_cohort``) and
handed to the port through numpy; θ crosses as numpy.

Tolerances (those of ``tests/test_torch_serve.py``): per-layer loss
5e-5, the reference's f32 kernel tolerance (``tests/test_kernels.py``),
since the sums run in another order; per-layer accuracy 1e-6, the
reference's exact-fit tolerance (``tests/test_serve.py``): an accuracy
is a count of argmax hits, and no test row sits on a near-tie at these
inputs. Runs of the port against itself are held bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import surf_paper as jcfgs
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic as jsyn
from repro_torch.checkpoint.convert import theta_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import surf as tsurf
from repro_torch.core import unroll as TU
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import TrainState
from repro_torch.kernels.graph_filter import make_plain_mix
from repro_torch.launch.mesh import make_surf_mesh

LOSS_TOL, ACC_TOL = 5e-5, 1e-6
STAR = dict(n_agents=12, n_layers=3, feature_dim=8, n_classes=4,
            batch_per_agent=4, train_per_agent=8, test_per_agent=4)


def _cfgs(name):
    if name == "STAR":
        return (dataclasses.replace(jcfgs.PAPER_STAR, **STAR),
                dataclasses.replace(tcfgs.PAPER_STAR, **STAR))
    return getattr(jcfgs, name), getattr(tcfgs, name)


def _setup(name, n_q=3, init="random"):
    """θ (reference init, as numpy), S, a pool of datasets."""
    jcfg, tcfg = _cfgs(name)
    theta = jax.tree.map(np.asarray,
                         JU.init_udgd(jax.random.PRNGKey(5), jcfg, init=init))
    _, S = jsurf.make_problem(jcfg, seed=0)
    mds = jsyn.make_meta_dataset(jcfg, n_q, seed=4)
    return jcfg, tcfg, theta, np.asarray(S), mds


def _ref_draws(jcfg, mds, seed):
    """The reference's per-dataset async-study draws for eval seed
    ``seed``."""
    base = jax.random.PRNGKey(2000 + seed)
    out = []
    for q, ds in enumerate(mds):
        batch = jax.tree.map(jnp.asarray, ds)
        W0, Xl, Yl = JU.featurize_cohort(jax.random.fold_in(base, q), batch,
                                         jcfg)
        out.append(tuple(np.asarray(a) for a in (W0, Xl, Yl)))
    return out


def _close(t, j, what):
    np.testing.assert_allclose(t["loss_per_layer"], j["loss_per_layer"],
                               atol=LOSS_TOL, rtol=LOSS_TOL,
                               err_msg=f"{what} loss")
    np.testing.assert_allclose(t["acc_per_layer"], j["acc_per_layer"],
                               atol=ACC_TOL, rtol=ACC_TOL,
                               err_msg=f"{what} acc")


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_async", [0, 1, 3, 7])
@pytest.mark.parametrize("name", ["SMOKE", "BENCH"])
def test_async_masks_bit_equal(name, n_async, seed):
    jcfg, tcfg = _cfgs(name)
    t = tsurf.async_masks(tcfg, 5, n_async, seed=seed)
    np.testing.assert_array_equal(t, jsurf.async_masks(jcfg, 5, n_async,
                                                       seed=seed))
    assert t.dtype == bool and (t.sum(1) == n_async).all()


@pytest.mark.parametrize("n_async", [0, 2, 5])
@pytest.mark.parametrize("name", ["SMOKE", "STAR"])
def test_make_async_run_matches_reference(name, n_async):
    """One dataset, one mask, per layer: losses and accuracies of the
    reference's body on its key against the port's on the same draws."""
    jcfg, tcfg, theta, S, mds = _setup(name)
    mask = jsurf.async_masks(jcfg, 1, n_async, seed=2)[0]
    key = jax.random.PRNGKey(9)
    batch = jax.tree.map(jnp.asarray, mds[0])
    jl, ja = jsurf.make_async_run(jcfg, jnp.asarray(S))(
        theta, batch, key, jnp.asarray(mask))
    draws = tuple(np.asarray(a) for a in JU.featurize_cohort(key, batch,
                                                             jcfg))
    run = tsurf.make_async_run(tcfg, torch.tensor(S))
    tl, ta = run(theta_from_numpy(theta, "cpu"),
                 resolve_task(tcfg).to_batch(mds[0], "cpu"), None,
                 torch.as_tensor(mask), draws=draws)
    assert tl.shape == ta.shape == (tcfg.n_layers,)
    _close({"loss_per_layer": tl.numpy(), "acc_per_layer": ta.numpy()},
           {"loss_per_layer": np.asarray(jl), "acc_per_layer": np.asarray(ja)},
           f"{name} n_async={n_async}")


@pytest.mark.parametrize("n_async", [2, 5])
@pytest.mark.parametrize("name", ["SMOKE", "BENCH"])
def test_evaluate_async_matches_reference_with_seeds(name, n_async):
    """``evaluate_async(seeds=(0, 3))`` of the reference, row by row,
    against the port's ``seed=s`` call on the reference's draws for that
    seed (same per-seed masks); the port's own ``seeds=`` rows equal its
    single-seed calls."""
    jcfg, tcfg, theta, S, mds = _setup(name)
    seeds = (0, 3)
    ref = jsurf.evaluate_async(jcfg, TrainState(theta), jnp.asarray(S), mds,
                               n_async, seeds=seeds)
    state = TrainState(theta_from_numpy(theta, "cpu"))
    for i, s in enumerate(seeds):
        one = tsurf.evaluate_async(tcfg, state, S, mds, n_async, seed=s,
                                   device="cpu",
                                   draws=_ref_draws(jcfg, mds, s))
        _close(one, {k: v[i] for k, v in ref.items()},
               f"{name} seed {s}")
        assert one["final_loss"] == one["loss_per_layer"][-1]
    multi = tsurf.evaluate_async(tcfg, state, S, mds, n_async, seeds=seeds,
                                 device="cpu")
    assert multi["acc_per_layer"].shape == (2, tcfg.n_layers)
    for i, s in enumerate(seeds):
        one = tsurf.evaluate_async(tcfg, state, S, mds, n_async, seed=s,
                                   device="cpu")
        for k in one:
            np.testing.assert_array_equal(multi[k][i], one[k])


def test_async_changes_the_result_and_zero_async_is_evaluate_surf():
    """With every mask False the async body makes ``evaluate_surf``'s
    calls: its per-layer loss and accuracy are bit-equal on the same
    draws. Stale agents change the result."""
    jcfg, tcfg, theta, S, mds = _setup("SMOKE")
    state = TrainState(theta_from_numpy(theta, "cpu"))
    batches = [resolve_task(tcfg).to_batch(ds, "cpu") for ds in mds]
    draws = [TU.featurize_cohort(TU.async_generator(1, q, "cpu"), b, tcfg)
             for q, b in enumerate(batches)]
    sync = tsurf.evaluate_async(tcfg, state, S, mds, 0, seed=1,
                                device="cpu")
    with_draws = tsurf.evaluate_async(tcfg, state, S, mds, 0, seed=1,
                                      device="cpu", draws=draws)
    plain = tsurf.evaluate_surf(tcfg, state, S, mds, device="cpu",
                                draws=draws)
    for k in ("loss_per_layer", "acc_per_layer"):
        np.testing.assert_array_equal(sync[k], plain[k])
        np.testing.assert_array_equal(with_draws[k], plain[k])
    # final_* is the last layer of the mean, as in the reference
    # (evaluate_surf means its per-dataset finals, in another order)
    assert sync["final_loss"] == plain["loss_per_layer"][-1]
    assert sync["final_acc"] == plain["acc_per_layer"][-1]
    stale = tsurf.evaluate_async(tcfg, state, S, mds, 4, seed=1,
                                 device="cpu")
    assert not np.array_equal(stale["loss_per_layer"],
                              sync["loss_per_layer"])
    # the plain mixer as an explicit mix_fn gives the same numbers here
    pm = tsurf.evaluate_async(tcfg, state, S, mds, 4, seed=1, device="cpu",
                              mix_fn=make_plain_mix())
    np.testing.assert_allclose(pm["loss_per_layer"], stale["loss_per_layer"],
                               atol=LOSS_TOL, rtol=LOSS_TOL)


def test_async_generator_is_the_shifted_solve_stream():
    """``async_generator(s, q)`` draws what ``solve_generator(s + 1000,
    q)`` draws (the reference's PRNGKey(2000 + s) = PRNGKey(1000 + (s +
    1000))), and nothing that another seed's solve stream draws."""
    a = TU.async_generator(3, 5, "cpu")
    assert a.initial_seed() == TU.solve_generator(1003, 5, "cpu")\
        .initial_seed() == 2003 * 1_000_003 + 5
    assert a.initial_seed() != TU.solve_generator(3, 5, "cpu").initial_seed()


def test_async_cache_counts_one_build_per_config():
    jcfg, tcfg, theta, S, mds = _setup("SMOKE", n_q=2)
    state = TrainState(theta_from_numpy(theta, "cpu"))
    repro_torch.clear_caches("surf-async")
    before = repro_torch.cache_stats()["surf-async"]["misses"]

    def builds():
        stats = repro_torch.cache_stats()["surf-async"]
        return stats["misses"] - before, stats["size"]

    for n_async, seed in ((1, 0), (3, 2)):
        tsurf.evaluate_async(tcfg, state, S, mds, n_async, seed=seed,
                             device="cpu")
    tsurf.evaluate_async(tcfg, state, S, mds, 1, seeds=(0, 1), device="cpu")
    assert builds() == (1, 1)
    # another topology of the same shape shares the body; another
    # activation or mixer is another computation
    er = dataclasses.replace(tcfg, topology="er", er_p=0.5)
    tsurf.evaluate_async(er, state, S, mds, 1, device="cpu")
    tsurf.evaluate_async(tcfg, state, S, mds, 1, device="cpu",
                         activation="tanh")
    tsurf.evaluate_async(tcfg, state, S, mds, 1, device="cpu",
                         mix_fn=make_plain_mix())
    assert builds() == (3, 3)


def test_evaluate_async_refusals():
    jcfg, tcfg, theta, S, mds = _setup("SMOKE", n_q=2)
    state = TrainState(theta_from_numpy(theta, "cpu"))
    # a run on a mesh lives on the mesh's home device
    mesh = make_surf_mesh(1, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="home device"):
        tsurf.evaluate_async(tcfg, state, S, mds, 1, mesh=mesh,
                             device="cuda")
    draws = _ref_draws(jcfg, mds, 0)
    with pytest.raises(ValueError, match="draws for"):
        tsurf.evaluate_async(tcfg, state, S, mds, 1, device="cpu",
                             draws=draws[:1])
    with pytest.raises(ValueError, match="not seeds"):
        tsurf.evaluate_async(tcfg, state, S, mds, 1, device="cpu",
                             draws=draws, seeds=(0, 1))
    with pytest.raises(ValueError, match="non-empty"):
        tsurf.evaluate_async(tcfg, state, S, mds, 1, device="cpu", seeds=())
    with pytest.raises(ValueError):
        tsurf.evaluate_async(tcfg, state, S, mds, tcfg.n_agents + 1,
                             device="cpu")
