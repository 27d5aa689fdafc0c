"""The port's halo-exchange mixers (``topology.halo``, ``core.ring``) and
the multi-device training paths they run in, against the reference, on
the CPU with simulated meshes (``devices=["cpu"] * k``).

The reference's halo and ring mixers cannot run on this tree (its
``shard_map`` call passes ``check_rep=``, which the installed jax
refuses), and its multi-shard tests need 8 forced host devices. So the
port is held against what the reference documents its mixers equal:

  * the plans, numpy in both packages: ``halo_plan`` and
    ``scheduled_halo_plan`` bit for bit, and the seed-halo union plan
    against a numpy rebuild of the reference's ``SeedHaloMix``;
  * the reference's dense ``repro.core.unroll.graph_filter`` on the same
    S, W and h, within 1e-5 (``tests/test_sharded_engine.py``), and
    their gradients against autograd through the port's plain filter
    (5e-5, the reference's f32 kernel tolerance);
  * the reference's dense training (``engine.train``) on replayed draws:
    θ within 2e-5 and histories within 1e-4 / 1e-3
    (``tests/test_mesh2d.py``); halo-pallas against the kernel path
    within 5e-6 (``tests/test_pallas_mix.py``).

Runs of the port against itself on one mesh (a seed lane and its
sequential run) are held bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs.base import SURFConfig as JCFG
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic as jsyn
from repro.topology import families as JF
from repro.topology.halo import halo_plan as jhalo_plan
from repro.topology.halo import scheduled_halo_plan as jsched_plan
from repro_torch import engine as E
from repro_torch.checkpoint.convert import state_from_numpy
from repro_torch.configs.base import SURFConfig as TCFG
from repro_torch.core import surf as tsurf
from repro_torch.core.ring import dense_equivalent, make_ring_mix
from repro_torch.kernels.graph_filter import graph_filter_ref, ops
from repro_torch.launch.mesh import make_agent_mesh, make_surf_mesh
from repro_torch.topology import halo as H

MIX_TOL, GRAD_TOL = 1e-5, 5e-5
THETA_TOL, HIST_ATOL, HIST_RTOL, PALLAS_TOL = 2e-5, 1e-4, 1e-3, 5e-6
# 16 agents divide over 1, 2, 4 and 8 shards; a ring keeps the union
# support banded (the reference's mesh tests' config).
KW = dict(n_agents=16, n_layers=3, filter_taps=2, feature_dim=8,
          n_classes=4, batch_per_agent=4, train_per_agent=8,
          test_per_agent=4, eps=0.05, topology="ring", degree=2)
JC, TC = JCFG(**KW), TCFG(**KW)
REG = dict(topology="regular", degree=3)
STEPS = 4


def _graph(kind, n=16):
    A = {"ring": lambda: JF.ring_graph(n, 2),
         "regular": lambda: JF.regular_graph(n, 3, seed=1),
         "smallworld": lambda: JF.small_world_graph(n, k=4, beta=0.3,
                                                    seed=2)}[kind]()
    return JF.metropolis_weights(A).astype(np.float32)


def _mesh(shards, seed_shards=1):
    return make_surf_mesh(seed_shards, shards,
                          devices=["cpu"] * (seed_shards * shards))


def _inputs(n=16, d=6, K=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (0.5 * rng.standard_normal(K + 1)).astype(np.float32))


def _plans_equal(got, ref):
    assert len(got) == len(ref)
    for (dg, rg, sg), (dr, rr, sr) in zip(got, ref):
        assert dg == dr
        np.testing.assert_array_equal(rg, rr)
        assert sg.dtype == sr.dtype
        np.testing.assert_array_equal(sg, sr)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["ring", "regular", "smallworld"])
def test_halo_plan_bit_equal(kind, shards):
    S = _graph(kind)
    S0, plans = H.halo_plan(S, shards)
    S0r, plans_r = jhalo_plan(S, shards)
    np.testing.assert_array_equal(S0, S0r)
    _plans_equal(plans, plans_r)
    assert H.halo_exchange_rows(plans) == sum(len(r) for _, r, _ in plans_r)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("scenario", ["link-failure", "dropout", "markov",
                                      "anneal"])
def test_scheduled_halo_plan_bit_equal(scenario, shards):
    jcfg = dataclasses.replace(JC, **REG)
    S_stack = np.asarray(jsurf.make_scenario(jcfg, scenario, 5, seed=3).S)
    S0, plans = H.scheduled_halo_plan(S_stack, shards)
    S0r, plans_r = jsched_plan(S_stack, shards)
    np.testing.assert_array_equal(S0, S0r)
    _plans_equal(plans, plans_r)


def _seed_plan_rebuild(S_stack, nshards):
    """A numpy rebuild of the reference's ``SeedHaloMix`` union plan
    (``src/repro/topology/halo.py``: union support over every seed and
    step, per-seed blocks on the union's rows)."""
    scheduled = S_stack.ndim == 4
    n = S_stack.shape[-1]
    flat = S_stack.reshape(-1, n, n)
    union = (flat != 0.0).any(axis=0).astype(np.float32)
    _, plans_u = jhalo_plan(union, nshards)
    nl = n // nshards
    blocks = flat.reshape(-1, nshards, nl, nshards, nl).transpose(
        0, 1, 3, 2, 4)
    a = np.arange(nshards)
    lead = S_stack.shape[:2] if scheduled else S_stack.shape[:1]
    S0 = blocks[:, a, a]
    plans = [(d, rows, np.ascontiguousarray(
        blocks[:, a, (a + d) % nshards][:, :, :, rows]))
        for d, rows, _ in plans_u]
    return (S0.reshape(lead + S0.shape[1:]),
            [(d, r, Sd.reshape(lead + Sd.shape[1:])) for d, r, Sd in plans])


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
def test_seed_halo_union_plan_matches_rebuild(shards, scheduled):
    jcfg = dataclasses.replace(JC, **REG)
    if scheduled:
        S_stack = np.stack([np.asarray(jsurf.make_scenario(
            jcfg, "link-failure", 3, seed=s).S) for s in (0, 1)])
    else:
        S_stack = np.stack([np.asarray(jsurf.make_problem(jcfg, s)[1])
                            for s in (0, 1)])
    mix = H.make_seed_halo_mix(_mesh(shards, 2), "agent", S_stack)
    S0, plans = mix.plan
    S0r, plans_r = _seed_plan_rebuild(S_stack, shards)
    np.testing.assert_array_equal(S0, S0r)
    _plans_equal(plans, plans_r)
    assert mix.scheduled == scheduled and mix.n_seeds == 2


@pytest.mark.parametrize("hops,shards", [(1, 4), (2, 4), (2, 2), (1, 8)])
def test_ring_plan_moves_hops_rows_per_direction(hops, shards):
    mix = make_ring_mix(_mesh(shards), "agent", 16, hops)
    deltas = sorted(d for d, _, _ in mix.plan[1])
    assert deltas == ([1] if shards == 2 else [1, shards - 1])
    # on 2 shards offsets +1 and -1 are one offset carrying both sides
    per = 2 * hops if shards == 2 else hops
    assert all(len(rows) == per for _, rows, _ in mix.plan[1])
    np.testing.assert_array_equal(
        dense_equivalent(16, hops),
        JF.metropolis_weights(JF.ring_graph(16, hops)))


# ----------------------------------------------------------------- mixers
def _ref_filter(S, W, h):
    return np.asarray(JU.graph_filter(jnp.asarray(S), jnp.asarray(W),
                                      jnp.asarray(h)))


@pytest.mark.parametrize("resident", ["dense", "pallas"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["ring", "regular", "smallworld"])
def test_halo_mix_matches_reference_filter(kind, shards, resident):
    S = _graph(kind)
    W, h = _inputs(K=3, seed=shards)
    mix = H.make_halo_mix(_mesh(shards), "agent", S, resident=resident)
    got = mix(torch.from_numpy(W), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), _ref_filter(S, W, h),
                               atol=MIX_TOL, rtol=MIX_TOL)


@pytest.mark.parametrize("mix_kind", ["halo", "halo-pallas", "ring"])
@pytest.mark.parametrize("shards", [2, 4])
def test_halo_mix_gradients_match_autograd(mix_kind, shards):
    """dW and dh through the exchange (copies, row indexing, the kernel's
    custom backward for halo-pallas) against autograd through the
    port's plain filter."""
    S = dense_equivalent(16, 2).astype(np.float32) if mix_kind == "ring" \
        else _graph("regular")
    mesh = _mesh(shards)
    mix = (make_ring_mix(mesh, "agent", 16, 2) if mix_kind == "ring" else
           H.make_halo_mix(mesh, "agent", S, resident="pallas"
                           if mix_kind == "halo-pallas" else "dense"))
    W, h = _inputs(seed=7)
    G = np.random.default_rng(8).standard_normal(W.shape).astype(np.float32)
    grads = []
    for fn in (mix, lambda W_, h_: graph_filter_ref(torch.from_numpy(S),
                                                    W_, h_)):
        Wt = torch.from_numpy(W).requires_grad_(True)
        ht = torch.from_numpy(h).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(Wt, ht), (Wt, ht),
                                         torch.from_numpy(G)))
    for got, ref in zip(*grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_scheduled_and_seed_mixers_match_reference_filter(shards):
    jcfg = dataclasses.replace(JC, **REG)
    stacks = [np.asarray(jsurf.make_scenario(jcfg, "link-failure", 4,
                                             seed=s).S) for s in (0, 1)]
    W, h = _inputs(seed=3)
    Wt, ht = torch.from_numpy(W), torch.from_numpy(h)
    sched = H.make_scheduled_halo_mix(_mesh(shards), "agent", stacks[0],
                                      resident="pallas")
    seeded = H.make_seed_halo_mix(_mesh(shards, 2), "agent",
                                  np.stack(stacks))
    for t in range(6):
        np.testing.assert_allclose(sched.at_step(t)(Wt, ht).numpy(),
                                   _ref_filter(stacks[0][t % 4], W, h),
                                   atol=MIX_TOL, rtol=MIX_TOL)
        for lane in (0, 1):
            ref = _ref_filter(stacks[lane][t % 4], W, h)
            np.testing.assert_allclose(seeded.bind(lane, t)(Wt, ht).numpy(),
                                       ref, atol=MIX_TOL, rtol=MIX_TOL)
            np.testing.assert_array_equal(
                seeded.lane(lane).at_step(t)(Wt, ht).numpy(),
                seeded.bind(lane, t)(Wt, ht).numpy())


def test_halo_errors_and_tags():
    with pytest.raises(ValueError, match="divisors of 10"):
        H.halo_plan(np.eye(10, dtype=np.float32), 4)
    with pytest.raises(ValueError, match="must be \\(n, n\\)"):
        H.halo_plan(np.ones((4, 5), np.float32), 2)
    with pytest.raises(ValueError, match="n_seeds, n, n"):
        H.SeedHaloMix(_mesh(1), "agent", np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="resident must be"):
        H.make_halo_mix(_mesh(1), "agent", np.eye(4), resident="tpu")
    S = _graph("regular")
    m2, m4 = _mesh(2), _mesh(4)
    tags = {H.make_halo_mix(m2, "agent", S).tag,
            H.make_halo_mix(m2, "agent", S, resident="pallas").tag,
            H.make_halo_mix(m4, "agent", S).tag,
            H.make_halo_mix(m2, "agent", _graph("ring")).tag,
            make_ring_mix(m2, "agent", 16, 2).tag}
    assert len(tags) == 5
    assert H.make_halo_mix(m2, "agent", S).tag[0] == "halo"
    assert make_ring_mix(m2, "agent", 16, 2).tag[:4] == ("ring", "agent",
                                                         16, 2)
    # the legacy 'data' axis of the 1-D shim mesh
    legacy = make_agent_mesh(4, devices=["cpu"] * 4)
    W, h = _inputs()
    np.testing.assert_allclose(
        H.make_halo_mix(legacy, "data", S)(torch.from_numpy(W),
                                           torch.from_numpy(h)).numpy(),
        _ref_filter(S, W, h), atol=MIX_TOL, rtol=MIX_TOL)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_halo_pallas_resident_launch_counts(shards, monkeypatch):
    """The counts ``PERF.md`` derives for the card, read from the
    wrapper's calls here: a halo-pallas meta-step makes shards·K·L
    forward and shards·K·L dW resident calls (Horner's first iterate
    h_K·W_loc carries h's gradient, so layer 1's products need dW too);
    an evaluation makes shards·K·L forward and none backward."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(ops, "_filter", counted(ops._filter, "fwd"))
    monkeypatch.setattr(ops, "graph_filter_bwd",
                        counted(ops.graph_filter_bwd, "bwd"))
    mds = jsyn.make_meta_dataset(JC, 2, seed=0)
    st, _, S = tsurf.train_surf(TC, mds, steps=1, mix="halo-pallas",
                                mesh=_mesh(shards), device="cpu")
    per = shards * TC.filter_taps * TC.n_layers
    assert calls == {"fwd": per, "bwd": per}
    mix = H.make_halo_mix(_mesh(shards), "agent", S, resident="pallas")
    tsurf.evaluate_surf(TC, st, S, mds[:1], mix_fn=mix, device="cpu")
    assert calls == {"fwd": 2 * per, "bwd": per}


# --------------------------------------------------------------- training
def _draws(jcfg, ds, key):
    kw, kb = jax.random.split(key)
    W0 = JU.sample_w0(kw, jcfg)
    Xl, Yl = JU.sample_layer_batches(kb, jnp.asarray(ds["Xtr"]),
                                     jnp.asarray(ds["Ytr"]), jcfg)
    return tuple(np.asarray(a) for a in (W0, Xl, Yl))


def _port_state(jstate):
    s = jax.tree.map(np.asarray, jstate)
    return state_from_numpy(s.theta, s.lam, s.opt_state, int(s.step), "cpu")


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's dense step-wise runs (ring and regular configs),
    their start states and replayed per-step draws."""
    out = {}
    for name, over in (("ring", {}), ("regular", REG)):
        jcfg = dataclasses.replace(JC, **over)
        _, S = jsurf.make_problem(jcfg, seed=0)
        mds = jsyn.make_meta_dataset(jcfg, 3, seed=0)
        key = jax.random.PRNGKey(1)
        jstate, jhist = JE.train(jcfg, S, mds, STEPS, key, log_every=1)
        draws = [_draws(jcfg, mds[t % 3], jax.random.fold_in(key, t))
                 for t in range(STEPS)]
        out[name] = (np.asarray(S), mds, JE.init_state(key, jcfg), jstate,
                     jhist, draws)
    return out


def _theta_close(tstate, jstate, tol):
    js = jax.tree.map(np.asarray, jstate)
    for k in js.theta:
        np.testing.assert_allclose(tstate.theta[k].numpy(), js.theta[k],
                                   atol=tol, rtol=tol, err_msg=f"theta.{k}")


@pytest.mark.parametrize("mix,shards,graph", [
    ("halo", 2, "regular"), ("halo", 4, "regular"), ("halo", 8, "ring"),
    ("halo-pallas", 4, "regular"), ("ring", 4, "ring"), ("ring", 8, "ring")])
def test_halo_training_matches_reference_dense(reference_runs, mix, shards,
                                               graph):
    S, mds, jinit, jstate, jhist, draws = reference_runs[graph]
    tcfg = dataclasses.replace(TC, **(REG if graph == "regular" else {}))
    mesh = _mesh(shards)
    mix_fn = tsurf._resolve_mix(mix, mesh, tcfg, S=S)
    state, hist = E.train_scan(tcfg, S, mds, STEPS, log_every=1,
                               mix_fn=mix_fn, mesh=mesh,
                               state=_port_state(jinit), draws=draws)
    _theta_close(state, jstate, THETA_TOL)
    assert [r["step"] for r in hist] == [r["step"] for r in jhist]
    for tr, jr in zip(hist, jhist):
        for k in jr:
            np.testing.assert_allclose(tr[k], jr[k], atol=HIST_ATOL,
                                       rtol=HIST_RTOL, err_msg=k)


@pytest.mark.parametrize("shards", [2, 4])
def test_halo_pallas_matches_kernel_path(reference_runs, shards):
    """halo-pallas against the dense kernel path (the default mixer) on
    the same draws, at the reference's pallas-mix bound."""
    S, mds, jinit, _, _, draws = reference_runs["regular"]
    tcfg = dataclasses.replace(TC, **REG)
    mesh = _mesh(shards)
    a, ha = E.train_scan(tcfg, S, mds, STEPS, log_every=1, device="cpu",
                         state=_port_state(jinit), draws=draws)
    b, hb = E.train_scan(tcfg, S, mds, STEPS, log_every=1, mesh=mesh,
                         mix_fn=tsurf._resolve_mix("halo-pallas", mesh, tcfg,
                                                   S=S),
                         state=_port_state(jinit), draws=draws)
    for k in a.theta:
        torch.testing.assert_close(b.theta[k], a.theta[k], atol=PALLAS_TOL,
                                   rtol=PALLAS_TOL)
    for ra, rb in zip(ha, hb):
        for k in ra:
            np.testing.assert_allclose(rb[k], ra[k], atol=PALLAS_TOL,
                                       rtol=PALLAS_TOL)


@pytest.mark.parametrize("mix", ["halo", "halo-pallas"])
def test_scheduled_halo_training_matches_dense_schedule(mix):
    """A link-failure schedule through the scheduled halo mixer against
    the same schedule through the default filter, and a run resumed at
    step 3 against the uninterrupted one."""
    cfg = dataclasses.replace(TC, **REG)
    mds = jsyn.make_meta_dataset(cfg, 3, seed=0)
    mesh = _mesh(4)
    dense, _, S = tsurf.train_surf(cfg, mds, steps=6, device="cpu",
                                   scenario="link-failure", log_every=0)
    halo, _, S_h = tsurf.train_surf(cfg, mds, steps=6, device="cpu",
                                    scenario="link-failure", mix=mix,
                                    mesh=mesh, log_every=0)
    assert torch.equal(S, S_h)
    for k in dense.theta:
        torch.testing.assert_close(halo.theta[k], dense.theta[k],
                                   atol=THETA_TOL, rtol=THETA_TOL)
    sched = tsurf.make_scenario(cfg, "link-failure", 6, device="cpu")
    mix_fn = H.make_scheduled_halo_mix(mesh, "agent", sched)
    first, _ = E.train_scan(cfg, sched, mds, 3, mix_fn=mix_fn, mesh=mesh)
    resumed, _ = E.train_scan(cfg, sched, mds, 3, mix_fn=mix_fn, mesh=mesh,
                              state=first)
    whole, _ = E.train_scan(cfg, sched, mds, 6, mix_fn=mix_fn, mesh=mesh)
    for k in whole.theta:
        assert torch.equal(resumed.theta[k], whole.theta[k])


def test_evaluate_with_halo_mixer_matches_reference(reference_runs):
    """``evaluate_surf`` with a halo mixer on a mesh (datasets Q-sharded)
    against the reference's dense evaluation on its own draws."""
    S, mds, _, jstate, _, _ = reference_runs["regular"]
    jcfg, tcfg = (dataclasses.replace(c, **REG) for c in (JC, TC))
    ref = jsurf.evaluate_surf(jcfg, jstate, jnp.asarray(S), mds, seed=2)
    base = jax.random.PRNGKey(1002)
    draws = [tuple(np.asarray(a) for a in JU.featurize_cohort(
        jax.random.fold_in(base, q), jax.tree.map(jnp.asarray, ds), jcfg))
        for q, ds in enumerate(mds)]
    mesh = _mesh(4)
    got = tsurf.evaluate_surf(
        tcfg, _port_state(jstate), S, mds, seed=2, mesh=mesh, draws=draws,
        mix_fn=H.make_halo_mix(mesh, "agent", S))
    np.testing.assert_allclose(got["loss_per_layer"], ref["loss_per_layer"],
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(got["acc_per_layer"], ref["acc_per_layer"],
                               atol=1e-6, rtol=1e-6)


# --------------------------------------------------- the 2-D seed engine
@pytest.mark.parametrize("scenario", [None, "link-failure"])
@pytest.mark.parametrize("seed_shards,agent_shards", [(2, 4), (4, 2)])
def test_2d_halo_seed_rows_match_sequential(seed_shards, agent_shards,
                                            scenario):
    """``train_surf(seeds=...)`` with mix='halo' on a ('seed', 'agent')
    mesh: each row bit-equal to its lane's sequential run on the same
    mesh, and within the reference's tolerances of the sequential dense
    run (``tests/test_mesh2d.py``)."""
    seeds = (0, 1, 2, 3)
    mds = jsyn.make_meta_dataset(TC, 3, seed=0)
    mesh = make_surf_mesh(seed_shards, agent_shards, n_seeds=4,
                          n_agents=16, devices=["cpu"] * 8)
    states, hist, S_stack = tsurf.train_surf(
        TC, mds, steps=STEPS, seeds=seeds, mix="halo", mesh=mesh,
        scenario=scenario, log_every=2)
    if scenario is None:
        stack = S_stack
    else:
        stack = E.stack_schedules([tsurf.make_scenario(
            TC, scenario, STEPS, s, device="cpu") for s in seeds])
    lanes = H.make_seed_halo_mix(mesh, "agent", stack)
    for i, s in enumerate(seeds):
        S_i = (stack[i] if scenario is None else
               tsurf.make_scenario(TC, scenario, STEPS, s, device="cpu"))
        st, h = E.train_scan(TC, S_i, mds, STEPS, seed=s, log_every=2,
                             mix_fn=lanes.lane(i), mesh=mesh)
        row = E.state_for_seed(states, i)
        for k in st.theta:
            assert torch.equal(row.theta[k], st.theta[k]), (i, k)
        dense, hd, _ = tsurf.train_surf(TC, mds, steps=STEPS, seed=s,
                                        scenario=scenario, log_every=2,
                                        device="cpu")
        for k in dense.theta:
            torch.testing.assert_close(row.theta[k], dense.theta[k],
                                       atol=THETA_TOL, rtol=THETA_TOL)
        for hb, hs in zip(hist, hd):
            for k in hs:
                if k != "step":
                    np.testing.assert_allclose(hb[k][i], hs[k],
                                               atol=HIST_ATOL,
                                               rtol=HIST_RTOL)


def test_seed_halo_engine_guards():
    """The reference's guards (``tests/test_mesh2d.py``): single-seed
    builders refuse a seed-batched mixer, the seed engine a static one,
    a mixer of another stack or kind, and a mesh without named axes."""
    mesh = _mesh(2, 2)
    cfg = dataclasses.replace(TC, **REG)
    S4 = torch.stack([tsurf.make_problem(cfg, s, device="cpu")[1]
                      for s in range(4)])
    mds = jsyn.make_meta_dataset(cfg, 2, seed=0)
    mix = H.make_seed_halo_mix(mesh, "agent", S4)
    assert mix.seed_batched and not mix.scheduled and mix.n_seeds == 4
    with pytest.raises(ValueError, match="single-seed"):
        E.train_scan(cfg, S4[0], mds, 1, mix_fn=mix, mesh=mesh)
    with pytest.raises(ValueError, match="single-seed"):
        E.make_meta_step(cfg, S4[0], mix_fn=mix)
    static = H.make_halo_mix(mesh, "agent", S4[0])
    with pytest.raises(ValueError, match="SEED-BATCHED"):
        E.train_scan_seeds(cfg, S4, mds, 1, range(4), mix_fn=static,
                           mesh=mesh)
    other = H.make_seed_halo_mix(mesh, "agent", torch.stack([
        tsurf.make_problem(cfg, s + 7, device="cpu")[1] for s in range(4)]))
    with pytest.raises(ValueError, match="digest mismatch"):
        E.train_scan_seeds(cfg, S4.clone(), mds, 1, range(4), mix_fn=other,
                           mesh=mesh)
    sched_stack = S4[:, None].expand(4, 5, 16, 16)
    with pytest.raises(ValueError, match="static stack"):
        E.train_scan_seeds(cfg, sched_stack, mds, 1, range(4), mix_fn=mix,
                           mesh=mesh)
    with pytest.raises(ValueError, match="'seed', 'agent'"):
        E.train_scan_seeds(cfg, S4, mds, 1, range(4), mix_fn=mix,
                           mesh=make_agent_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="stacks 4 seeds"):
        E.train_scan_seeds(cfg, S4[:2], mds, 1, range(2), mix_fn=mix,
                           mesh=mesh)


def test_train_surf_mix_string_validation():
    mds = jsyn.make_meta_dataset(TC, 2, seed=0)
    with pytest.raises(ValueError, match="not both"):
        tsurf.train_surf(TC, mds, steps=2, mix="halo",
                         mix_fn=lambda W, h: W, device="cpu")
    with pytest.raises(ValueError, match="mix must be one of"):
        tsurf.train_surf(TC, mds, steps=2, mix="butterfly", device="cpu")
    with pytest.raises(ValueError, match="needs mesh="):
        tsurf.train_surf(TC, mds, steps=2, mix="halo", device="cpu")
    with pytest.raises(ValueError, match="use mix='halo'"):
        tsurf.train_surf(TC, mds, steps=2, seeds=[0, 1], mix="ring",
                         mesh=_mesh(1))
    with pytest.raises(ValueError, match="cfg.topology='ring'"):
        tsurf.train_surf(dataclasses.replace(TC, **REG), mds, steps=2,
                         mix="ring", mesh=_mesh(2))
    with pytest.raises(ValueError, match="engine='scan'"):
        tsurf.train_surf(TC, mds, steps=2, mix="halo", mesh=_mesh(2),
                         engine="python")
