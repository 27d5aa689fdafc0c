"""The port's FL baselines (paper Fig. 5) against the reference, on the
CPU: DGD, DSGD, DFedAvgM on the config's graph and FedAvg, FedProx,
SCAFFOLD in the star setting, at SMOKE and BENCH width (n = 100,
F = 64), with the learning rates of ``benchmarks/fig5_convergence.py``.

The reference draws its mini-batches (and, in the classical runs, the
participants) from ``jax.random`` keys inside its scans. The tests
recompute those draws from the same key splits, in the same order, and
hand them to the port as ``draws=``, so both packages run the same
rounds on the same rows.

Tolerances, derived: every round is a few f32 products and sums whose
order differs between the packages, about one ulp (1.2e-7 relative) per
operation; DGD-type iterations contract, so the difference does not
grow with the rounds (measured: at most 2.2e-7 of the loss scale over
200 rounds at SMOKE and BENCH; the tests run 100 and 40). The per-round loss is held within LOSS_TOL = 5e-5 of the
largest loss of the run, the reference's f32 kernel tolerance
(``tests/test_kernels.py``), far above that and far below any
algorithmic difference (one skipped local step moves the loss by more
than 1e-3). The per-round accuracy is a count of argmax hits on n·t test
rows; at these inputs no row sits on a near-tie (measured: no flip), so
it is held at ACC_TOL = 1e-6, the reference's exact-fit tolerance
(``tests/test_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import surf_paper as jcfgs
from repro.core import baselines as JB
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic as jsyn
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import baselines as TB
from repro_torch.kernels.graph_filter import graph_filter, ops

LOSS_TOL, ACC_TOL = 5e-5, 1e-6
# benchmarks/fig5_convergence.py's learning rates
LRS = {"dgd": 0.5, "dsgd": 0.2, "dfedavgm": 0.05,
       "fedavg": 0.5, "fedprox": 0.5, "scaffold": 0.5}
ROUNDS = {"SMOKE": 100, "BENCH": 40}     # decentralized
ROUNDS_STAR = 25                         # classical, as fig. 5
LOCAL_STEPS = 6


# ------------------------------------- the reference's draws, recomputed
def _split_chain(key, count, shape, m):
    """``count`` draws of randint(sub, shape, 0, m), each from
    ``key, sub = split(key)`` on the carried key (one scan, as the
    reference's)."""
    def step(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, shape, 0, m)
    return np.asarray(jax.lax.scan(step, key, None, length=count)[1])


def dsgd_draws(key, rounds, n, m):
    """``run_dsgd``: k, sub = split(k) per round; randint(sub, (n, 1))."""
    return {"idx": _split_chain(key, rounds, (n, 1), m)}


def dfedavgm_draws(key, rounds, n, b, m):
    """``run_dfedavgm``: one split of the carried key per local step."""
    idx = _split_chain(key, rounds * LOCAL_STEPS, (n, b), m)
    return {"idx": idx.reshape(rounds, LOCAL_STEPS, n, b)}


def classical_draws(key, rounds, n, participate, b, m):
    """FedAvg / FedProx / SCAFFOLD: k, ks, kb = split(k, 3) per round;
    sel = permutation(ks, n)[:P]; local step i draws from
    fold_in(kb, i)."""
    def step(k, _):
        k, ks, kb = jax.random.split(k, 3)
        sel = jax.random.permutation(ks, n)[:participate]
        idx = jnp.stack([jax.random.randint(jax.random.fold_in(kb, i),
                                            (participate, b), 0, m)
                         for i in range(LOCAL_STEPS)])
        return k, (sel, idx)
    sel, idx = jax.lax.scan(step, key, None, length=rounds)[1]
    return {"sel": np.asarray(sel), "idx": np.asarray(idx)}


def _setup(size):
    jcfg, tcfg = getattr(jcfgs, size), getattr(tcfgs, size)
    _, S = jsurf.make_problem(jcfg, seed=0)
    ds = jsyn.sample_dataset(jcfg, seed=7)
    W0 = JU.sample_w0(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, np.asarray(S), ds, np.asarray(W0)


def _participate(cfg):
    return 4 if cfg.n_agents < 10 else 10


def _close(t, j, what):
    j = {k: np.asarray(v) for k, v in j.items()}
    assert t["loss"].shape == j["loss"].shape
    scale = np.abs(j["loss"]).max()
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=0,
                               atol=LOSS_TOL * scale, err_msg=f"{what} loss")
    np.testing.assert_allclose(t["acc"], j["acc"], rtol=0, atol=ACC_TOL,
                               err_msg=f"{what} acc")


@pytest.mark.parametrize("name", sorted(JB.DECENTRALIZED))
@pytest.mark.parametrize("size", ["SMOKE", "BENCH"])
def test_decentralized_baseline_matches_reference(size, name):
    jcfg, tcfg, S, ds, W0 = _setup(size)
    key, rounds = jax.random.PRNGKey(1), ROUNDS[size]
    ref = JB.DECENTRALIZED[name](jnp.asarray(S), jnp.asarray(W0),
                                 jax.tree.map(jnp.asarray, ds), key, jcfg,
                                 rounds=rounds, lr=LRS[name])
    n, m, b = jcfg.n_agents, jcfg.train_per_agent, jcfg.batch_per_agent
    kw = {"dgd": {}, "dsgd": {"draws": dsgd_draws(key, rounds, n, m)},
          "dfedavgm": {"draws": dfedavgm_draws(key, rounds, n, b, m)}}[name]
    out = TB.DECENTRALIZED[name](S, W0, ds, None, tcfg, rounds=rounds,
                                 lr=LRS[name], device="cpu", **kw)
    _close(out, ref, f"{size} {name}")


@pytest.mark.parametrize("name", sorted(JB.CLASSICAL))
@pytest.mark.parametrize("size", ["SMOKE", "BENCH"])
def test_classical_baseline_matches_reference(size, name):
    jcfg, tcfg, S, ds, W0 = _setup(size)
    key, P = jax.random.PRNGKey(2), _participate(jcfg)
    ref = JB.CLASSICAL[name](jnp.asarray(W0), jax.tree.map(jnp.asarray, ds),
                             key, jcfg, rounds=ROUNDS_STAR, lr=LRS[name],
                             participate=P)
    draws = classical_draws(key, ROUNDS_STAR, jcfg.n_agents, P,
                            jcfg.batch_per_agent, jcfg.train_per_agent)
    out = TB.CLASSICAL[name](W0, ds, None, tcfg, rounds=ROUNDS_STAR,
                             lr=LRS[name], participate=P, device="cpu",
                             draws=draws)
    _close(out, ref, f"{size} {name}")


def test_baselines_on_the_star_config_match_reference():
    """The classical runs on a cut of PAPER_STAR (K = 1, the star graph),
    as fig. 5 runs them, and DGD on its star mixing matrix."""
    cut = dict(n_agents=12, feature_dim=8, n_classes=4, batch_per_agent=4,
               train_per_agent=8, test_per_agent=4)
    jcfg = dataclasses.replace(jcfgs.PAPER_STAR, **cut)
    tcfg = dataclasses.replace(tcfgs.PAPER_STAR, **cut)
    _, S = jsurf.make_problem(jcfg, seed=0)
    ds = jsyn.sample_dataset(jcfg, seed=3)
    W0 = np.asarray(JU.sample_w0(jax.random.PRNGKey(4), jcfg))
    key = jax.random.PRNGKey(5)
    ref = JB.run_scaffold(jnp.asarray(W0), jax.tree.map(jnp.asarray, ds),
                          key, jcfg, rounds=ROUNDS_STAR, lr=0.5,
                          participate=5)
    out = TB.run_scaffold(W0, ds, None, tcfg, rounds=ROUNDS_STAR, lr=0.5,
                          participate=5, device="cpu",
                          draws=classical_draws(key, ROUNDS_STAR, 12, 5, 4,
                                                8))
    _close(out, ref, "star scaffold")
    ref = JB.run_dgd(S, jnp.asarray(W0), jax.tree.map(jnp.asarray, ds), key,
                     jcfg, rounds=50, lr=0.5)
    out = TB.run_dgd(np.asarray(S), W0, ds, None, tcfg, rounds=50, lr=0.5,
                     device="cpu")
    _close(out, ref, "star dgd")


def test_baselines_never_run_the_graph_filter(monkeypatch):
    """The baselines mix with a plain ``S @ W``, as the reference mixes
    outside its kernel: no call reaches the graph filter."""
    jcfg, tcfg, S, ds, W0 = _setup("SMOKE")
    calls = []
    monkeypatch.setattr(ops, "_filter",
                        lambda *a: calls.append(1) or ops.graph_filter_ref(*a))
    before = (graph_filter.launches, graph_filter.bwd_launches)
    gen = torch.Generator().manual_seed(0)
    for name, fn in TB.DECENTRALIZED.items():
        fn(S, W0, ds, gen, tcfg, rounds=3, lr=LRS[name], device="cpu")
    for name, fn in TB.CLASSICAL.items():
        fn(W0, ds, gen, tcfg, rounds=3, lr=LRS[name], participate=4,
           device="cpu")
    assert not calls
    assert (graph_filter.launches, graph_filter.bwd_launches) == before


@pytest.mark.parametrize("name", ["dsgd", "dfedavgm", "fedavg", "scaffold"])
def test_generator_draws_are_reproducible(name):
    """Without ``draws=`` a run draws from its generator: the same seed
    gives the same run, another seed another."""
    jcfg, tcfg, S, ds, W0 = _setup("SMOKE")
    fn = {**TB.DECENTRALIZED, **TB.CLASSICAL}[name]
    args = (S, W0, ds) if name in TB.DECENTRALIZED else (W0, ds)
    kw = {} if name in TB.DECENTRALIZED else {"participate": 4}

    def run(seed):
        return fn(*args, torch.Generator().manual_seed(seed), tcfg,
                  rounds=10, lr=LRS[name], device="cpu", **kw)

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a["loss"], b["loss"])
    assert not np.array_equal(a["loss"], c["loss"])
    assert a["loss"].shape == a["acc"].shape == (10,)


def test_draws_are_validated():
    jcfg, tcfg, S, ds, W0 = _setup("SMOKE")
    n, m = tcfg.n_agents, tcfg.train_per_agent
    good = dsgd_draws(jax.random.PRNGKey(0), 4, n, m)
    with pytest.raises(ValueError, match="shape"):
        TB.run_dsgd(S, W0, ds, None, tcfg, rounds=5, device="cpu",
                    draws=good)
    with pytest.raises(ValueError, match="outside"):
        TB.run_dsgd(S, W0, ds, None, tcfg, rounds=4, device="cpu",
                    draws={"idx": good["idx"] + m})
    with pytest.raises(ValueError, match="Generator"):
        TB.run_dsgd(S, W0, ds, None, tcfg, rounds=4, device="cpu")
    cl = classical_draws(jax.random.PRNGKey(0), 3, n, 4, 4, m)
    cl["sel"] = cl["sel"].copy()
    cl["sel"][1, :2] = 0
    with pytest.raises(ValueError, match="distinct"):
        TB.run_fedavg(W0, ds, None, tcfg, rounds=3, participate=4,
                      device="cpu", draws=cl)
