"""The port's mesh (``launch.mesh``), placement rules
(``sharding.surf_rules``), compatibility shims (``core.graph``,
``core.task``, ``core.trainer``) and tree helpers (``utils.tree``)
against the reference, on the CPU.

Meshes are simulated with repeated ``"cpu"`` devices (``devices=["cpu"]
* k``): the port's counterpart of the reference's forced host device
count. The reference's multi-device rules cannot run here (one jax
device), so its specs are held as the literal ``PartitionSpec``s its own
tests assert (``tests/test_mesh2d.py``); its numpy helpers
(``check_divides``, the classification functions, the tree helpers) run
on the same inputs. Errors are held to the reference's messages.
Tolerance: 1e-6 for the functional task forms and the tree norms (f32,
sums in another order); everything else is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as jgraph
import repro.core.task as jtask
import repro.utils.tree as jtree
from repro.sharding import surf_rules as JR
from repro_torch.core import graph as tgraph
from repro_torch.core import task as ttask
from repro_torch.core import trainer as ttrainer
from repro_torch.launch.mesh import (host_device_count, make_agent_mesh,
                                     make_cpu_mesh, make_surf_mesh,
                                     mesh_device)
from repro_torch.sharding import surf_rules as R
from repro_torch.utils import tree as ttree

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


def _cpu(k):
    return ["cpu"] * k


# --------------------------------------------------------------- the mesh
@pytest.mark.parametrize("seed_shards,agent_shards",
                         [(1, 1), (1, 8), (2, 4), (4, 2), (8, 1)])
def test_make_surf_mesh_axes_and_devices(seed_shards, agent_shards):
    mesh = make_surf_mesh(seed_shards, agent_shards,
                          devices=_cpu(seed_shards * agent_shards))
    assert mesh.axis_names == ("seed", "agent")
    assert mesh.shape == {"seed": seed_shards, "agent": agent_shards}
    assert mesh.devices.shape == (seed_shards, agent_shards)
    assert mesh.home == torch.device("cpu")
    assert mesh.simulated == (mesh.size > 1)
    assert len(mesh.along("agent", seed=seed_shards - 1)) == agent_shards
    assert len(mesh.along("seed")) == seed_shards


@pytest.mark.parametrize("call,match", [
    (lambda: make_surf_mesh(2, 4, n_agents=10, devices=_cpu(8)),
     "n_agents=10 does not divide"),
    (lambda: make_surf_mesh(3, 1, n_seeds=4, devices=_cpu(3)),
     "n_seeds=4 does not divide"),
    (lambda: make_surf_mesh(0, 1), "must be >= 1"),
    (lambda: make_surf_mesh(2, 2, devices=_cpu(3)), "lists 3"),
])
def test_make_surf_mesh_errors_are_actionable(call, match):
    """Indivisible problem sizes fail UP FRONT with the reference's
    messages, before any device is touched."""
    with pytest.raises(ValueError, match=match):
        call()


def test_make_surf_mesh_device_count_error_names_the_fix():
    """``devices=None`` takes the visible CUDA cards only; a mesh needing
    more raises and names the explicit simulation."""
    need = host_device_count() + 1
    with pytest.raises(ValueError, match=r"devices=\['cuda:0'\]"):
        make_surf_mesh(need, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        make_agent_mesh(need)


def test_legacy_meshes_and_home_device():
    cpu = make_cpu_mesh()
    assert cpu.axis_names == ("data", "model") and cpu.size == 1
    assert not cpu.simulated
    legacy = make_agent_mesh(devices=_cpu(4))
    assert legacy.shape == {"data": 4, "model": 1}
    assert mesh_device(legacy, None) == torch.device("cpu")
    assert mesh_device(legacy, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="home device"):
        mesh_device(legacy, "cuda:1")


def test_mesh_fingerprint_keys_shape_and_simulation():
    a = make_surf_mesh(1, 2, devices=_cpu(2))
    b = make_surf_mesh(2, 1, devices=_cpu(2))
    assert R.mesh_fingerprint(None) is None
    assert R.mesh_fingerprint(a) == R.mesh_fingerprint(
        make_surf_mesh(1, 2, devices=_cpu(2)))
    assert R.mesh_fingerprint(a) != R.mesh_fingerprint(b)
    assert R.mesh_fingerprint(a) != R.mesh_fingerprint(
        make_surf_mesh(1, 2, devices=["cpu", "meta"]))
    hash(R.mesh_fingerprint(a))


# ------------------------------------------------------ placement rules
@pytest.mark.parametrize("count,shards", [(16, 4), (10, 4), (7, 1), (9, 3),
                                          (12, 8)])
def test_check_divides_matches_reference(count, shards):
    fix = "lower the shard count"
    try:
        JR.check_divides(count, shards, "what", "n", fix)
        ref = None
    except ValueError as e:
        ref = str(e)
    try:
        R.check_divides(count, shards, "what", "n", fix)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == ref


def test_axis_for_role_resolves_named_then_legacy_axes():
    mesh2d = make_surf_mesh(1, 1, devices=_cpu(1))
    assert R.axis_for_role(mesh2d, "seed") == "seed"
    assert R.axis_for_role(mesh2d, "agent") == "agent"
    legacy = make_agent_mesh(1, devices=_cpu(1))
    assert R.axis_for_role(legacy, "seed") == "data"
    assert R.axis_for_role(legacy, "agent") == "data"
    with pytest.raises(ValueError, match="unknown axis role"):
        R.axis_for_role(mesh2d, "batch")


@pytest.mark.parametrize("rule,size,spec", [
    (R.seed_sharding, 4, ("seed",)),
    (R.agent_sharding, 16, ("agent",)),
    (R.stacked_q_sharding, 8, ("agent",)),
    (R.stacked_q_sharding, 6, ()),          # indivisible: replicated
    (R.seed_sharding, 3, ()),
])
def test_rules_place_roles_on_their_axes(rule, size, spec):
    """The reference's specs on a (2, 4) mesh (``tests/test_mesh2d.py``):
    the seed rule places 'seed', the agent and Q rules 'agent'; an
    indivisible dim replicates."""
    mesh = make_surf_mesh(2, 4, devices=_cpu(8))
    place = rule(mesh, size)
    assert place.spec == spec
    assert place.shards == (1 if spec == () else mesh.shape[spec[0]])


def test_rules_replicate_on_one_device_axes_as_the_reference():
    legacy = make_agent_mesh(1, devices=_cpu(1))
    jlegacy = jax.make_mesh((1, 1), ("data", "model"))
    for rule, jrule in ((R.seed_sharding, JR.seed_sharding),
                        (R.agent_sharding, JR.agent_sharding)):
        assert rule(legacy, 4).spec == tuple(jrule(jlegacy, 4).spec)


@pytest.mark.parametrize("two_d", [True, False])
def test_seed_scan_shardings_compose_agent_axis_on_2d_mesh(two_d):
    """The seed-batched engine's shared pools: Q-sharded over 'agent' on
    a 2-D mesh, replicated on a 1-D one (where the seed lanes own the
    single axis)."""
    mesh = (make_surf_mesh(2, 4, devices=_cpu(8)) if two_d
            else make_agent_mesh(devices=_cpu(8)))
    place = R.seed_scan_shardings(mesh, 8 if not two_d else 4, n_eval_q=8,
                                  q_sharded=True, n_q=8)
    assert place["state"].spec == (("seed",) if two_d else ("data",))
    assert place["pool"].spec == (("agent",) if two_d else ())
    assert place["eval_pool"].spec == (("agent",) if two_d else ())
    single = R.train_scan_shardings(mesh, n_eval_q=8, q_sharded=False, n_q=8)
    assert single["pool"].spec == () and single["state"].spec == ()


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_q_select_is_the_replicated_index(shards):
    """A Q-sharded pool's select copies dataset t mod Q from its owner:
    bit-equal to the replicated index for every step."""
    mesh = make_surf_mesh(1, shards, devices=_cpu(shards))
    rng = np.random.default_rng(shards)
    pool = {"Xtr": torch.from_numpy(rng.standard_normal((8, 4, 3, 2))),
            "Ytr": torch.from_numpy(rng.integers(0, 5, (8, 4, 3)))}
    axis = R.q_select_axis(mesh, 8)
    assert axis == ("agent" if shards > 1 else None)
    place = R.stacked_q_sharding(mesh, 8)
    sharded = R.ShardedPool(pool, place)
    assert len(sharded.blocks) == shards and len(sharded) == 8
    select = R.make_q_select(mesh, axis)
    for t in range(19):
        got = select(sharded, t, torch.device("cpu"))
        for k, v in pool.items():
            assert torch.equal(got[k], v[t % 8])
        assert sharded.device_of(t % 8) == torch.device("cpu")
    assert R.q_select_axis(mesh, 6) == ("agent" if shards == 2 else None)
    if shards > 1:
        with pytest.raises(ValueError, match="placed over"):
            R.make_q_select(mesh, "seed")(sharded, 0, "cpu")


def test_replicas_copy_once_per_device():
    theta = {"h": torch.ones(2), "M": torch.zeros(3, 2)}
    reps = R.Replicas(theta=theta, S=torch.eye(2))
    a, b = reps.on(torch.device("cpu")), reps.on(torch.device("cpu"))
    assert a is b and a["theta"]["h"] is theta["h"]


# ------------------------------------------------------------------ shims
_SHIMS = [
    (tgraph, "repro_torch.topology.families", name) for name in (
        "build_topology", "er_graph", "is_connected", "metropolis_weights",
        "metropolis_weights_loop", "regular_graph", "ring_graph",
        "star_graph")] + [
    (ttask, "repro_torch.core.tasks.classification", name)
    for name in ttask.__all__] + [
    (ttrainer, "repro_torch.engine.core", name) for name in (
        "TrainState", "init_state", "make_meta_step", "make_eval",
        "_eval_core", "_meta_step_core", "_engine_cache_key",
        "_check_static_s")] + [
    (ttrainer, "repro_torch.engine.scan", name) for name in (
        "train_scan", "train", "_decimate_history")]


@pytest.mark.parametrize("shim,home,name", _SHIMS,
                         ids=[f"{s.__name__.split('.')[-1]}.{n}"
                              for s, _, n in _SHIMS])
def test_shims_reexport_the_same_objects(shim, home, name):
    import importlib
    assert getattr(shim, name) is getattr(importlib.import_module(home),
                                          name)


@pytest.mark.parametrize("name", ["ring_graph", "regular_graph",
                                  "star_graph", "metropolis_weights"])
def test_graph_shim_matches_reference(name):
    args = {"ring_graph": (12, 2), "regular_graph": (12, 3),
            "star_graph": (12,)}.get(name)
    if name == "metropolis_weights":
        A = jgraph.regular_graph(12, 3, seed=1)
        np.testing.assert_array_equal(tgraph.metropolis_weights(A),
                                      jgraph.metropolis_weights(A))
        return
    np.testing.assert_array_equal(getattr(tgraph, name)(*args),
                                  getattr(jgraph, name)(*args))


@pytest.mark.parametrize("name", ["fl_loss", "fl_accuracy", "fl_grad",
                                  "grad_norm", "local_loss",
                                  "local_accuracy"])
def test_task_shim_matches_reference(name):
    """The legacy functional forms on one cohort: W (n, d), X (n, b, F),
    Y (n, b)."""
    F, C, n, b = 5, 3, 4, 6
    rng = np.random.default_rng(0)
    W = (0.5 * rng.standard_normal((n, ttask.head_dim(F, C)))).astype(
        np.float32)
    X = rng.standard_normal((n, b, F)).astype(np.float32)
    Y = rng.integers(0, C, (n, b))
    if name.startswith("local"):
        W, X, Y = W[0], X[0], Y[0]
    got = getattr(ttask, name)(torch.from_numpy(W), torch.from_numpy(X),
                               torch.from_numpy(Y), F, C)
    ref = getattr(jtask, name)(jnp.asarray(W), jnp.asarray(X),
                               jnp.asarray(Y), F, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


# --------------------------------------------------------------- tree
def _trees(seed=0):
    rng = np.random.default_rng(seed)
    # keys in sorted order, the order of jax's tree leaves
    a = {"M": [rng.standard_normal((4,)).astype(np.float32),
               rng.standard_normal((2, 2)).astype(np.float32)],
         "h": rng.standard_normal((3, 2)).astype(np.float32)}
    to_t = lambda t: {"M": [torch.tensor(x) for x in t["M"]],    # noqa: E731
                      "h": torch.tensor(t["h"])}
    to_j = lambda t: {"M": [jnp.asarray(x) for x in t["M"]],     # noqa: E731
                      "h": jnp.asarray(t["h"])}
    return a, to_t, to_j


@pytest.mark.parametrize("name", ["tree_size", "tree_bytes", "tree_norm",
                                  "tree_add", "tree_scale",
                                  "tree_zeros_like", "has_nan"])
def test_tree_helpers_match_reference(name):
    a, to_t, to_j = _trees(0)
    b, _, _ = _trees(1)
    args_t = {"tree_add": (to_t(a), to_t(b), 0.5),
              "tree_scale": (to_t(a), 3.0)}.get(name, (to_t(a),))
    args_j = {"tree_add": (to_j(a), to_j(b), 0.5),
              "tree_scale": (to_j(a), 3.0)}.get(name, (to_j(a),))
    got = getattr(ttree, name)(*args_t)
    ref = getattr(jtree, name)(*args_j)
    got_l = ttree._leaves(got) if not isinstance(got, (int, bool)) else [got]
    ref_l = (jax.tree_util.tree_leaves(ref)
             if not isinstance(ref, (int, bool)) else [ref])
    assert len(got_l) == len(ref_l)
    for g, r in zip(got_l, ref_l):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), atol=1e-6,
                                   rtol=1e-6)
    bad = to_t(a)
    bad["M"][1][0, 0] = float("inf")
    assert ttree.has_nan(bad) and not ttree.has_nan(to_t(a))
