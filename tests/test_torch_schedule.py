"""The port's time-varying topology against the reference, on the CPU:
the schedule builders, the weight rules and spectral diagnostics,
``make_scenario``, and scheduled training through ``train_scan`` /
``train`` / ``train_surf``.

The builders are numpy (``default_rng``) in both packages, so their
stacks, tags and diagnostics are held bit for bit, at SMOKE (n = 8) and
BENCH (n = 100) agent counts. Scheduled training starts both packages
from the reference's initial state (``state_from_numpy``) and replays
the reference's per-step ``fold_in`` draws, as
``tests/test_torch_train.py`` does, and is held at its 5e-6 (the
reference's own training-parity tolerance, ``tests/test_pallas_mix.py``).
Runs of the port against itself (a static schedule against the plain S,
a resumed run against an uninterrupted one) are held bit for bit: they
make the same calls in the same order.
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
from repro.topology import families as JF
from repro.topology import schedule as JSCH
from repro_torch.checkpoint.convert import state_from_numpy
from repro_torch.configs import surf_paper as tcfgs
from repro_torch.core import surf as tsurf
from repro_torch.core import unroll as TU
from repro_torch.engine import core as TE
from repro_torch.engine import scan as TS
from repro_torch.kernels.graph_filter import make_plain_mix, ops
from repro_torch.launch.mesh import make_surf_mesh
from repro_torch.topology import families as TF
from repro_torch.topology import schedule as TSCH
from repro_torch.topology.halo import make_scheduled_halo_mix

STATE_TOL = 5e-6
SIZES = ("SMOKE", "BENCH")
WEIGHTS = ("metropolis", "lazy_metropolis", "laplacian")


def _base_graph(size):
    cfg = getattr(tcfgs, size)
    A, _ = TF.build_topology(cfg.topology, cfg.n_agents, degree=cfg.degree,
                             seed=0)
    return A


def _same_schedule(tsched, jsched):
    """Bit-equal stacks (f32), equal tags and shape properties."""
    j = np.asarray(jsched.S)
    t = tsched.S.numpy()
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    assert tsched.tag == jsched.tag
    assert (tsched.steps, tsched.n_agents, tsched.cache_tag) == (
        jsched.steps, jsched.n_agents, jsched.cache_tag)


# builder name -> (its perturbation parameter, (off, on))
BUILDERS = {"link_failure_schedule": ("p_fail", (0.0, 0.3)),
            "markov_link_schedule": ("p_drop", (0.0, 0.2)),
            "dropout_schedule": ("n_drop", (0, 2)),
            "ring_to_random_anneal": ("beta_max", (0.0, 1.0))}


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("size", SIZES)
def test_builders_bit_equal_to_reference(size, builder, seed, perturbed,
                                         weights):
    name, values = BUILDERS[builder]
    kw = {name: values[perturbed], "seed": seed, "weights": weights}
    n, steps = getattr(tcfgs, size).n_agents, 7
    if builder == "ring_to_random_anneal":
        args = (n, steps)
        kw["stages"] = 3
    else:
        args = (_base_graph(size), steps)
    jsched = getattr(JSCH, builder)(*args, **kw)
    tsched = getattr(TSCH, builder)(*args, device="cpu", **kw)
    _same_schedule(tsched, jsched)
    S = tsched.S.double()
    # every S_t symmetric and doubly stochastic (isolated agents: e_i)
    torch.testing.assert_close(S, S.mT, rtol=0, atol=0)
    torch.testing.assert_close(S.sum(-1), torch.ones_like(S[..., 0]),
                               rtol=0, atol=1e-6)
    if builder == "dropout_schedule" and perturbed:
        eye = torch.eye(n, dtype=S.dtype)
        isolated = (S == eye).all(-1).sum(-1)
        assert (isolated >= kw["n_drop"]).all()


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("size", SIZES)
def test_weight_rules_and_static_schedule_bit_equal(size, weights):
    A = _base_graph(size)
    stack = np.stack([A, np.roll(np.roll(A, 1, 0), 1, 1)])
    np.testing.assert_array_equal(TSCH.weights_batch(stack, weights),
                                  JSCH.weights_batch(stack, weights))
    for a in stack:
        np.testing.assert_array_equal(TF.WEIGHT_RULES[weights](a),
                                      JF.WEIGHT_RULES[weights](a))
    np.testing.assert_array_equal(TF.metropolis_weights_loop(A),
                                  JF.metropolis_weights_loop(A))
    np.testing.assert_array_equal(TF.metropolis_weights_loop(A),
                                  TF.metropolis_weights(A))
    S = TF.WEIGHT_RULES[weights](A)
    _same_schedule(TSCH.static_schedule(S, device="cpu"),
                   JSCH.static_schedule(S))
    # a tensor keeps its device; a tag passes through
    st = TSCH.static_schedule(torch.as_tensor(S, dtype=torch.float32),
                              tag=("mine",))
    assert st.S.device.type == "cpu" and st.tag == ("mine",)
    with pytest.raises(ValueError, match="square"):
        TSCH.static_schedule(S[:, :-1], device="cpu")


@pytest.mark.parametrize("kind", ["regular", "er", "ring", "smallworld",
                                  "torus", "star"])
@pytest.mark.parametrize("size", SIZES)
def test_spectral_diagnostics_equal(size, kind):
    n = getattr(tcfgs, size).n_agents
    kw = {"p": 0.4} if kind == "er" else {}
    At, St = TF.build_topology(kind, n, seed=1, **kw)
    Aj, Sj = JF.build_topology(kind, n, seed=1, **kw)
    np.testing.assert_array_equal(At, Aj)
    assert TF.algebraic_connectivity(At) == JF.algebraic_connectivity(Aj)
    assert TF.second_eigenvalue(St) == JF.second_eigenvalue(Sj)
    assert TF.algebraic_connectivity(At) > 0          # connected
    assert TF.second_eigenvalue(St) <= 1.0


@pytest.mark.parametrize("scenario", jsurf.SCENARIOS + (None,))
@pytest.mark.parametrize("size", SIZES)
def test_make_scenario_equal(size, scenario):
    assert tsurf.SCENARIOS == jsurf.SCENARIOS
    jcfg, tcfg = getattr(jcfgs, size), getattr(tcfgs, size)
    j = jsurf.make_scenario(jcfg, scenario, 6, seed=2)
    t = tsurf.make_scenario(tcfg, scenario, 6, seed=2, device="cpu")
    if scenario in (None, "static"):
        assert j is None and t is None
    else:
        _same_schedule(t, j)


def test_make_scenario_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown scenario"):
        tsurf.make_scenario(tcfgs.SMOKE, "earthquake", 4, device="cpu")


# ------------------------------------------------------------- training
def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate):
    s = _np(jstate)
    return state_from_numpy(s.theta, s.lam, s.opt_state, int(s.step), "cpu")


def _draws(jcfg, ds, key):
    """The reference meta-step's draws from its step key."""
    kw, kb = jax.random.split(key)
    W0 = JU.sample_w0(kw, jcfg)
    Xl, Yl = JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), jcfg)
    return tuple(np.asarray(a) for a in (W0, Xl, Yl))


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=STATE_TOL,
                               rtol=STATE_TOL, err_msg=what)


def _state_close(tstate, jstate):
    js = _np(jstate)
    for k in js.theta:
        _close(tstate.theta[k].numpy(), js.theta[k], f"theta.{k}")
        for mom in ("m", "v"):
            _close(tstate.opt_state[mom][k].numpy(), js.opt_state[mom][k],
                   f"opt_state.{mom}.{k}")
    _close(tstate.lam.numpy(), js.lam, "lam")
    assert tstate.step == int(js.step)


def _states_equal(a, b):
    for k in a.theta:
        torch.testing.assert_close(a.theta[k], b.theta[k], rtol=0, atol=0)
        for mom in ("m", "v"):
            torch.testing.assert_close(a.opt_state[mom][k],
                                       b.opt_state[mom][k], rtol=0, atol=0)
    torch.testing.assert_close(a.lam, b.lam, rtol=0, atol=0)
    assert a.step == b.step


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jcfgs.SMOKE, tcfgs.SMOKE
    mds = jsyn.make_meta_dataset(jcfg, 3, seed=0)
    return jcfg, tcfg, mds


STEPS, T = 5, 3          # T < steps: the schedule cycles


@pytest.mark.parametrize("scenario", ["link-failure", "dropout"])
@pytest.mark.parametrize("driver", ["train", "train_scan"])
def test_scheduled_training_matches_reference(smoke, driver, scenario):
    """The reference's ``train_scan`` under a schedule of T = 3 steps for
    5 meta-steps (steps 3 and 4 mix with S_0 and S_1 again), against the
    port's drivers from its initial state on its draws."""
    jcfg, tcfg, mds = smoke
    p = {"p_fail": 0.4} if scenario == "link-failure" else {}
    jsched = jsurf.make_scenario(jcfg, scenario, T, seed=1, **p)
    tsched = tsurf.make_scenario(tcfg, scenario, T, seed=1, device="cpu",
                                 **p)
    key = jax.random.PRNGKey(4)
    jstate, jhist = JE.train_scan(jcfg, jsched, mds, STEPS, key,
                                  log_every=1)
    draws = [_draws(jcfg, mds[t % len(mds)], jax.random.fold_in(key, t))
             for t in range(STEPS)]
    tstate, thist = getattr(TS, driver)(
        tcfg, tsched, mds, STEPS, log_every=1, device="cpu",
        state=_port_state(JE.init_state(key, jcfg)), draws=draws)
    _state_close(tstate, jstate)
    assert len(thist) == len(jhist) == STEPS
    for tr, jr in zip(thist, jhist):
        assert tr["step"] == jr["step"] and set(tr) == set(jr)
        for k in jr:
            _close(tr[k], jr[k], f"step {jr['step']} {k}")
    # and the schedule mattered: the static-S run lands elsewhere
    _, S = jsurf.make_problem(jcfg, seed=1)
    jstatic, _ = JE.train_scan(jcfg, S, mds, STEPS, key)
    assert not np.allclose(np.asarray(jstatic.theta["M"]),
                           tstate.theta["M"].numpy(), atol=1e-4)


def test_scheduled_run_mixes_with_the_carried_step(smoke, monkeypatch):
    """Every layer of meta-step t filters with S[t % T], t the CARRIED
    ``state.step``: a run resumed at step 4 starts at S_1."""
    jcfg, tcfg, mds = smoke
    sched = tsurf.make_scenario(tcfg, "dropout", T, seed=0, device="cpu")
    seen = []

    def recording(S, W, h):
        seen.append(S.clone())
        return ops.graph_filter_ref(S, W, h)

    monkeypatch.setattr(ops, "_filter", recording)
    state = TE.init_state(TU.seeded_generator(0, "cpu"), tcfg)
    state = state._replace(step=4)
    TS.train(tcfg, sched, mds, 3, device="cpu", state=state)
    L = tcfg.n_layers
    assert len(seen) == 3 * L
    for i, S in enumerate(seen):
        torch.testing.assert_close(S, sched.S[(4 + i // L) % T], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("driver", ["train", "train_scan"])
def test_static_schedule_equals_plain_s_run(smoke, driver):
    jcfg, tcfg, mds = smoke
    _, S = tsurf.make_problem(tcfg, seed=0, device="cpu")
    run = getattr(TS, driver)
    a, ha = run(tcfg, S, mds, 4, seed=2, log_every=1, device="cpu")
    b, hb = run(tcfg, TSCH.static_schedule(S), mds, 4, seed=2, log_every=1,
                device="cpu")
    _states_equal(a, b)
    assert ha == hb


@pytest.mark.parametrize("k", [1, 2])
def test_scheduled_resume_equals_uninterrupted_run(smoke, k):
    """k steps, then the rest from the returned state, equal one run of
    5 steps bit for bit (T = 3: the second leg starts mid-schedule)."""
    jcfg, tcfg, mds = smoke
    sched = tsurf.make_scenario(tcfg, "markov", T, seed=5, device="cpu",
                                p_drop=0.5)
    whole, hw = TS.train_scan(tcfg, sched, mds, STEPS, seed=7, log_every=1,
                              device="cpu")
    mid, h1 = TS.train(tcfg, sched, mds, k, seed=7, log_every=1,
                       device="cpu")
    end, h2 = TS.train_scan(tcfg, sched, mds, STEPS - k, seed=7, log_every=1,
                            device="cpu", state=mid)
    _states_equal(whole, end)
    assert [r["step"] for r in h1 + h2] == list(range(STEPS))
    assert h1 + h2 == hw


@pytest.mark.parametrize("engine", ["scan", "python"])
@pytest.mark.parametrize("scenario", ["link-failure", "anneal"])
def test_train_surf_under_scenario(smoke, scenario, engine):
    """``train_surf(scenario=...)`` trains on the schedule and returns the
    nominal static S: the state equals ``train_scan`` on
    ``make_scenario``'s schedule, and S equals ``make_problem``'s. An
    explicit ``schedule=`` does the same."""
    jcfg, tcfg, mds = smoke
    state, hist, S = tsurf.train_surf(tcfg, mds, steps=3, seed=1,
                                      scenario=scenario, engine=engine,
                                      log_every=1, device="cpu")
    _, S_nominal = tsurf.make_problem(tcfg, seed=1, device="cpu")
    torch.testing.assert_close(S, S_nominal, rtol=0, atol=0)
    _, jS = jsurf.make_problem(jcfg, seed=1)
    np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
    sched = tsurf.make_scenario(tcfg, scenario, 3, seed=1, device="cpu")
    ref, ref_hist = TS.train_scan(tcfg, sched, mds, 3, seed=1, log_every=1,
                                  device="cpu")
    _states_equal(state, ref)
    assert hist == ref_hist
    again, _, _ = tsurf.train_surf(tcfg, mds, steps=3, seed=1,
                                   schedule=sched, device="cpu")
    _states_equal(again, ref)
    # the reference's train_surf logs the same keys and steps
    _, jhist, _ = jsurf.train_surf(jcfg, mds, steps=3, seed=1,
                                   scenario=scenario, log_every=1)
    assert [set(r) for r in hist] == [set(r) for r in jhist]
    assert [r["step"] for r in hist] == [r["step"] for r in jhist]


# ------------------------------------------------------------- refusals
def test_schedule_and_scenario_together_raise(smoke):
    jcfg, tcfg, mds = smoke
    sched = tsurf.make_scenario(tcfg, "dropout", 2, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tsurf.train_surf(tcfg, mds, steps=1, scenario="dropout",
                         schedule=sched, device="cpu")
    with pytest.raises(ValueError, match="unknown scenario"):
        tsurf.train_surf(tcfg, mds, steps=1, scenario="flood", device="cpu")


def test_evaluators_refuse_a_schedule(smoke):
    jcfg, tcfg, mds = smoke
    sched = tsurf.make_scenario(tcfg, "link-failure", 2, device="cpu")
    state = TE.init_state(TU.seeded_generator(0, "cpu"), tcfg)
    calls = {
        "make_meta_step": lambda: TE.make_meta_step(tcfg, sched),
        "make_eval": lambda: TE.make_eval(tcfg, sched),
        "evaluate_surf": lambda: tsurf.evaluate_surf(
            tcfg, state, sched, mds, device="cpu"),
        "solve_federation": lambda: tsurf.solve_federation(
            tcfg, state, sched, mds[0], device="cpu"),
        "evaluate_async": lambda: tsurf.evaluate_async(
            tcfg, state, sched, mds, 2, device="cpu"),
    }
    for where, call in calls.items():
        with pytest.raises(TypeError, match=f"{where} needs a static"):
            call()


def test_schedule_mixer_checks(smoke):
    """The default and any ``takes_S`` mixer compose with a schedule; a
    baked-S mixer is refused before the first step, and the seed-batched
    mixer is refused, as is a scheduled halo mixer built from another
    schedule, and a seed-batched mixer in the single-seed drivers."""
    jcfg, tcfg, mds = smoke
    sched = tsurf.make_scenario(tcfg, "dropout", 2, device="cpu")
    a, _ = TS.train(tcfg, sched, mds, 2, device="cpu")
    b, _ = TS.train(tcfg, sched, mds, 2, device="cpu",
                    mix_fn=make_plain_mix())
    # the default mixer's custom backward against autograd through the
    # plain filter: the same gradient summed in another order
    for k in a.theta:
        torch.testing.assert_close(a.theta[k], b.theta[k], rtol=STATE_TOL,
                                   atol=STATE_TOL)

    def baked(S, W, h):
        return W

    with pytest.raises(ValueError, match="baked-S"):
        TS.train_scan(tcfg, sched, mds, 1, device="cpu", mix_fn=baked)
    seeded = make_plain_mix()
    seeded.seed_batched = True
    with pytest.raises(ValueError, match="single-seed"):
        TS.train(tcfg, sched, mds, 1, device="cpu", mix_fn=seeded)
    mesh = make_surf_mesh(1, 2, devices=["cpu"] * 2)
    for other, match in (
            (tsurf.make_scenario(tcfg, "dropout", 2, seed=5, device="cpu"),
             "DIFFERENT schedule"),
            (tsurf.make_scenario(tcfg, "dropout", 3, device="cpu"),
             "steps")):
        with pytest.raises(ValueError, match=match):
            TS.train(tcfg, sched, mds, 1, device="cpu",
                     mix_fn=make_scheduled_halo_mix(mesh, "agent", other))
    with pytest.raises(ValueError, match="needs a TopologySchedule"):
        TS.train_scan(tcfg, sched.S[0], mds, 1, device="cpu",
                      mix_fn=make_scheduled_halo_mix(mesh, "agent", sched))


def test_schedule_stack_moves_once(smoke):
    """``train_scan`` copies the stack to the run's device once; its rows
    are views of that copy (no per-step copy)."""
    jcfg, tcfg, mds = smoke
    sched = tsurf.make_scenario(tcfg, "dropout", 3, device="cpu")
    meta_step_s, S, is_sched, *_ = TS._setup(
        tcfg, sched, mds, 0, True, "relu", "dgd", None, None, "cpu", None)
    assert is_sched and S.shape == (3, tcfg.n_agents, tcfg.n_agents)
    assert S.data_ptr() == sched.S.data_ptr()      # already on the device
    assert S[2].data_ptr() == S.data_ptr() + 2 * S[0].numel() * 4


def test_schedule_needs_matching_agent_count(smoke):
    jcfg, tcfg, mds = smoke
    wide = TSCH.link_failure_schedule(_base_graph("BENCH"), 2, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        TS.train(tcfg, wide, mds, 1, device="cpu")
