"""Seed-batched training in the port (``engine.seeds``, ROADMAP item 7)
on the CPU: lockstep rows bit-equal to the sequential runs (static
topologies, per-seed schedules, snapshots, RSDUN and the sparse task),
each row against the reference's seed-batched run on replayed draws,
the per-seed copies and the stacking, and the refusals of ``tests/test_engine.py``.

Tolerances: rows against the port's own sequential runs are held bit for
bit (lockstep runs each seed's own sequential loop, interleaved). Against the reference's seed-batched run on its own
draws, from its own initial states: 5e-6 for θ, λ, the Adam moments and
the logged metrics, the reference's training parity tolerance
(``tests/test_pallas_mix.py``; the reference promises 1e-4 between its
vmapped rows and its sequential runs, ``tests/test_engine.py``).
"""
import dataclasses

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
from repro_torch.checkpoint.convert import state_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import surf as tsurf
from repro_torch.core import unroll as TU
from repro_torch.core.tasks import resolve_task
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.graph_filter import make_plain_mix
from repro_torch.launch.mesh import make_surf_mesh

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)

STATE_TOL = 5e-6
CFG = tcfgs.SMOKE
STEPS = 8


@pytest.fixture(scope="module")
def mds():
    return tsyn.make_meta_dataset(CFG, 4, seed=0)


@pytest.fixture(scope="module")
def eval_ds():
    return tsyn.make_meta_dataset(CFG, 2, seed=99)


def _state_equal(a, b):
    for k in b.theta:
        assert torch.equal(a.theta[k], b.theta[k]), f"theta.{k}"
        for mom in ("m", "v"):
            assert torch.equal(a.opt_state[mom][k], b.opt_state[mom][k])
    assert torch.equal(a.lam, b.lam)
    assert int(a.opt_state["t"]) == int(b.opt_state["t"])
    assert a.step == b.step


def _rows_equal(batched, single, i):
    assert [h["step"] for h in batched] == [h["step"] for h in single]
    for hb, hs in zip(batched, single):
        for k in hs:
            if k != "step":
                assert np.array_equal(np.asarray(hb[k])[i], hs[k]), k


@pytest.mark.parametrize("scenario", [None, "link-failure"])
def test_seed_rows_bit_equal_to_sequential_runs(mds, eval_ds, scenario):
    seeds = (0, 1, 2)
    states, hist, snaps, S_stack = tsurf.train_surf(
        CFG, mds, STEPS, seeds=seeds, log_every=3, eval_every=4,
        eval_datasets=eval_ds, scenario=scenario, device="cpu")
    assert S_stack.shape == (3, CFG.n_agents, CFG.n_agents)
    assert states.step == STEPS and hist[-1]["test_acc"].shape == (3,)
    assert [s["step"] for s in snaps] == [3, 7]
    assert snaps[0]["acc_per_layer"].shape == (3, CFG.n_layers)
    for i, s in enumerate(seeds):
        st, h, sn, S = tsurf.train_surf(CFG, mds, STEPS, seed=s,
                                        log_every=3, eval_every=4,
                                        eval_datasets=eval_ds,
                                        scenario=scenario, device="cpu")
        assert torch.equal(S_stack[i], S)
        _state_equal(E.state_for_seed(states, i), st)
        _rows_equal(hist, h, i)
        _rows_equal(snaps, sn, i)


def test_explicit_schedule_and_plain_mixer_rows(mds):
    """An explicit schedule is shared by every seed (the reference
    broadcasts it); an S-as-argument mixer receives each seed's S."""
    sched = tsurf.make_scenario(CFG, "dropout", STEPS, seed=5, device="cpu")
    states, _, _ = tsurf.train_surf(CFG, mds, 4, seeds=(3, 4),
                                    schedule=sched, log_every=0,
                                    mix_fn=make_plain_mix(), device="cpu")
    for i, s in enumerate((3, 4)):
        st, _, _ = tsurf.train_surf(CFG, mds, 4, seed=s, schedule=sched,
                                    log_every=0, mix_fn=make_plain_mix(),
                                    device="cpu")
        _state_equal(E.state_for_seed(states, i), st)


@pytest.mark.parametrize("kind", ["robust", "sparse"])
def test_robust_and_sparse_seed_rows_bit_equal(kind):
    if kind == "robust":
        cfg = dataclasses.replace(CFG, robust_sigma=0.1, robust_samples=2)
        pool = tsyn.make_meta_dataset(cfg, 3, seed=1)
    else:
        cfg = tcfgs.SPARSE_SMOKE
        pool = resolve_task(cfg).synth_datasets(cfg, 3, seed=1)
    states, hist, _ = tsurf.train_surf(cfg, pool, 5, seeds=(0, 1),
                                       log_every=2, device="cpu")
    for i in range(2):
        st, h, _ = tsurf.train_surf(cfg, pool, 5, seed=i, log_every=2,
                                    device="cpu")
        _state_equal(E.state_for_seed(states, i), st)
        _rows_equal(hist, h, i)


def test_seed_rows_match_reference_seed_batched_run():
    """The reference's seed-batched run against the port's lockstep run
    from the reference's initial states, on each seed's replayed
    ``fold_in(PRNGKey(seed), t)`` draws."""
    jcfg = jcfgs.SMOKE
    seeds, steps = [0, 1], 5
    jmds = jsyn.make_meta_dataset(jcfg, 4, seed=0)
    jstates, jhist, jS = jsurf.train_surf(jcfg, jmds, steps=steps,
                                          seeds=seeds, log_every=1)
    init = [jax.tree.map(np.asarray, JE.init_state(jax.random.PRNGKey(s),
                                                   jcfg)) for s in seeds]
    states = E.seeds.stack_states([state_from_numpy(
        s.theta, s.lam, s.opt_state, 0, "cpu") for s in init])

    def draws(seed, t):
        kw, kb = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(seed), t))
        ds = jmds[t % len(jmds)]
        return tuple(np.asarray(a) for a in (
            JU.sample_w0(kw, jcfg),
            *JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), jcfg)))

    out, hist = E.train_scan_seeds(
        CFG, np.asarray(jS), jmds, steps, seeds, log_every=1, device="cpu",
        states=states, draws=[[draws(s, t) for t in range(steps)]
                              for s in seeds])
    for i in range(len(seeds)):
        js = jax.tree.map(np.asarray, JE.state_for_seed(jstates, i))
        row = E.state_for_seed(out, i)
        for k in js.theta:
            np.testing.assert_allclose(row.theta[k].numpy(), js.theta[k],
                                       atol=STATE_TOL, rtol=STATE_TOL)
            np.testing.assert_allclose(row.opt_state["v"][k].numpy(),
                                       js.opt_state["v"][k],
                                       atol=STATE_TOL, rtol=STATE_TOL)
        np.testing.assert_allclose(row.lam.numpy(), js.lam, atol=STATE_TOL,
                                   rtol=STATE_TOL)
        for hb, hj in zip(hist, jhist):
            for k in hj:
                if k != "step":
                    np.testing.assert_allclose(hb[k][i], hj[k][i],
                                               atol=STATE_TOL,
                                               rtol=STATE_TOL)


def test_lanes_start_where_a_fresh_allocation_does():
    """Each seed trains on its own fresh tensors: a stacked ``states=``
    is copied row by row (no view into the stack reaches a meta-step),
    and the returned stack is built leaf by leaf from the seeds' states,
    emptying the list it was given."""
    states = E.init_states(CFG, (0, 5, 9), device="cpu")
    for i, s in enumerate((0, 5, 9)):
        one = E.init_state(TU.seeded_generator(s, "cpu"), CFG)
        _state_equal(E.state_for_seed(states, i), one)
    assert E.state_for_seed(states, 1).theta["M"].data_ptr() \
        == states.theta["M"][1].data_ptr()         # views, not copies
    per = E.seeds._unstack(states, 3, "cpu")
    for i, st in enumerate(per):
        _state_equal(st, E.state_for_seed(states, i))
        for (_, a), (_, b) in zip(E.seeds.io.flatten(st),
                                  E.seeds.io.flatten(states)):
            if isinstance(a, torch.Tensor):
                assert a.is_contiguous()
                assert a.untyped_storage().data_ptr() \
                    != b.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="2 seeds were given"):
        E.seeds._unstack(states, 2, "cpu")
    restacked = E.seeds.stack_states(per)
    assert per == [] and restacked.step == 0
    for i in range(3):
        _state_equal(E.state_for_seed(restacked, i),
                     E.state_for_seed(states, i))
    sch = [tsurf.make_scenario(CFG, "markov", 6, seed=s, device="cpu")
           for s in (0, 1)]
    S2 = E.stack_schedules(sch)
    assert S2.shape == (2, 6, CFG.n_agents, CFG.n_agents)
    assert torch.equal(S2[1], sch[1].S)
    with pytest.raises(ValueError, match="share one"):
        E.stack_schedules([sch[0], tsurf.make_scenario(
            CFG, "markov", 5, device="cpu")])


def test_seed_batched_rejects_bad_inputs(mds):
    with pytest.raises(ValueError, match="non-empty"):
        E.init_states(CFG, [], device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tsurf.train_surf(CFG, mds, steps=2, seeds=[0, 1], engine="python",
                         device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tsurf.train_surf(CFG, mds, steps=2, seed=7, seeds=[0, 1],
                         device="cpu")
    with pytest.raises(ValueError, match="SEED-BATCHED"):
        tsurf.train_surf(CFG, mds, steps=2, seeds=[0, 1],
                         mix_fn=lambda W, h: W, device="cpu")
    halo = make_plain_mix()
    halo.seed_batched = True
    with pytest.raises(ValueError, match="'seed', 'agent'"):
        tsurf.train_surf(CFG, mds, steps=2, seeds=[0, 1], mix_fn=halo,
                         device="cpu")
    with pytest.raises(ValueError, match="seed rows"):
        E.train_scan_seeds(CFG, torch.zeros((3, 8, 8)), mds, 2, [0, 1],
                           device="cpu")
    n = CFG.n_agents
    with pytest.raises(ValueError, match="PER SEED"):
        E.train_scan_seeds(CFG, torch.zeros((2, 5, n, n)), mds, 2, [0, 1],
                           eval_every=2, eval_datasets=mds,
                           S_eval_stack=torch.eye(n), device="cpu")
    with pytest.raises(ValueError, match="S_eval_stack"):
        E.train_scan_seeds(CFG, torch.zeros((2, 5, n, n)), mds, 2, [0, 1],
                           eval_every=2, eval_datasets=mds, device="cpu")
    # a named 'seed' axis never silently replicates a seed batch
    with pytest.raises(ValueError, match="n_seeds=3 does not divide"):
        tsurf.train_surf(CFG, mds, steps=2, seeds=[0, 1, 2], mix="halo",
                         mesh=make_surf_mesh(2, 1, devices=["cpu"] * 2))
