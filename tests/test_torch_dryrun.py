"""The port's dry run (``launch.{specs,steps,hlo_cost,roofline,dryrun}``,
``configs.shapes``) against the reference's, on the CPU.

Exact equality for the shapes, ``shape_supported``, ``model_flops``,
``param_count`` and ``auto_microbatches`` on every arch and shape; the
``meta`` specs leaf by leaf against the reference's ``jax.eval_shape``
(nothing compiled); the counter's matmul FLOPs against the ``dot`` FLOPs
of the reference's compiled steps, parsed with its own ``hlo_cost``
functions, trip counts included, on one reduced prefill and one reduced
train step (qwen3-4b, B=2, S=16): equal for the train step, and short
by exactly the reference's all-position logits, 2·B·(S−1)·d·V, for the
prefill (the port computes the last position's only). Then the counter
itself (time loops by trip count, live bytes) and the dry run's records.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import flags as jflags
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import hlo_cost as JH
from repro.launch import roofline as JR
from repro.launch import specs as JSP
from repro.launch import steps as JSTEPS
from repro.models import model as JM
from repro_torch import flags
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, hlo_cost, roofline
from repro_torch.launch import specs as SP
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_cpu_mesh, make_production_mesh

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(autouse=True)
def reset_flags():
    yield
    for f in (jflags, flags):
        f.set_flags(**dataclasses.asdict(f.Flags()))


def _jleaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tleaves(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _same_specs(port, ref):
    """Leaf by leaf: the same paths, shapes and dtypes."""
    t, j = _tleaves(port), _jleaves(ref)
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].device.type == "meta", k
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype), k


def test_registry_and_shapes_match_reference():
    assert ARCH_IDS == JARCH_IDS
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(JSHAPES[name])
        assert get_shape(name) is s


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_support_match_reference(arch):
    """shape_supported, model_flops and param_count, exactly, on every
    shape; auto_microbatches on both production meshes with
    microbatch_target unset and set."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) == jcfg.param_count(
        active_only=True)
    for name, shape in SHAPES.items():
        assert SP.shape_supported(cfg, shape) == JSP.shape_supported(
            jcfg, JSHAPES[name])
        assert roofline.model_flops(cfg, shape) == JR.model_flops(
            jcfg, JSHAPES[name])
    for target in (None, 1, 4, 8):
        for f in (jflags, flags):
            f.set_flags(microbatch_target=target or 2)
        for mesh in (FakeMesh(), FakePodMesh()):
            for name, shape in SHAPES.items():
                assert steps.auto_microbatches(shape, mesh) == \
                    JSTEPS.auto_microbatches(JSHAPES[name], mesh)
                assert steps.auto_microbatches(shape, mesh, 3) == \
                    JSTEPS.auto_microbatches(JSHAPES[name], mesh, 3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference_eval_shape(arch):
    """params_spec, input_specs (every shape) and cache_spec_tree: meta
    tensors with the reference's paths, shapes and dtypes (bf16 params)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert SP.PARAM_DTYPE == torch.bfloat16 and JSP.PARAM_DTYPE == jnp.bfloat16
    _same_specs(SP.params_spec(cfg), JSP.params_spec(jcfg))
    for name, shape in SHAPES.items():
        _same_specs(SP.input_specs(cfg, shape),
                    JSP.input_specs(jcfg, JSHAPES[name]))
    _same_specs(SP.cache_spec_tree(cfg, 2, 64),
                JSP.cache_spec_tree(jcfg, 2, 64))


def _dot_flops(text):
    """The ``dot`` FLOPs of a compiled module, while bodies times their
    trip counts, through the reference's own ``hlo_cost`` parser."""
    comps = JH.parse_module(text)
    memo = {}

    def ev(c):
        if c.name in memo:
            return memo[c.name]
        memo[c.name] = 0.0
        tot = 0.0
        for op in c.ops:
            called = dict(JH._called(op))
            if op.opcode == "while":
                n = JH._trip_count(op, comps)
                for role in ("body", "condition"):
                    if called.get(role) in comps:
                        tot += n * ev(comps[called[role]])
            elif op.opcode == "conditional":
                br = [comps[b] for r, b in JH._called(op)
                      if r == "branch" and b in comps]
                tot += max((ev(b) for b in br), default=0.0)
            elif op.opcode == "dot":
                tot += JH._dot_flops(op, c)
            else:
                cn = called.get("calls") or called.get("to_apply")
                if cn in comps:
                    tot += ev(comps[cn])
        memo[c.name] = tot
        return tot
    return ev(comps["__entry__"])


FLOP_B, FLOP_S = 2, 16


@pytest.fixture(scope="module")
def reduced_qwen():
    jcfg, tcfg = jget_config("qwen3-4b").reduced(), get_config(
        "qwen3-4b").reduced()
    params = jax.eval_shape(lambda k: JM.init_lm(jcfg, k),
                            jax.random.PRNGKey(0))
    return jcfg, tcfg, params


def test_prefill_matmul_flops_match_reference_hlo(reduced_qwen):
    jcfg, tcfg, params = reduced_qwen
    tok = jax.ShapeDtypeStruct((FLOP_B, FLOP_S), jnp.int32)
    text = jax.jit(JSTEPS.make_prefill_step(jcfg, FLOP_S)).lower(
        params, {"tokens": tok}).compile().as_text()
    step = steps.jitted_step(tcfg, ShapeConfig("p", FLOP_S, FLOP_B,
                                               "prefill"), make_cpu_mesh())
    _, cost = hlo_cost.count(step.fn, *step.args)
    logits = 2 * FLOP_B * (FLOP_S - 1) * tcfg.d_model * tcfg.vocab
    assert cost.matmul_flops + logits == _dot_flops(text)


def test_train_matmul_flops_match_reference_hlo(reduced_qwen):
    """Remat's recompute included on both sides."""
    jcfg, tcfg, params = reduced_qwen
    fn, opt = JSTEPS.make_train_step(jcfg, microbatches=1)
    batch = {k: jax.ShapeDtypeStruct((FLOP_B, FLOP_S), jnp.int32)
             for k in ("tokens", "labels")}
    text = jax.jit(fn).lower(params, jax.eval_shape(opt.init, params),
                             batch).compile().as_text()
    step = steps.jitted_step(tcfg, ShapeConfig("t", FLOP_S, FLOP_B, "train"),
                             make_cpu_mesh(), microbatches=1)
    _, cost = hlo_cost.count(step.fn, *step.args)
    assert cost.matmul_flops == _dot_flops(text)
    assert cost.flops > cost.matmul_flops


def test_microbatches_count_one_by_trip_count():
    """The dry run counts one microbatch times the microbatch count: the
    same matmul FLOPs as running every microbatch."""
    cfg = get_config("qwen3-4b").reduced()
    shape = ShapeConfig("t", 8, 4, "train")
    step = steps.jitted_step(cfg, shape, make_cpu_mesh(), microbatches=4)
    _, full = hlo_cost.count(step.fn, *step.args)
    with dryrun._one_microbatch(4):
        _, once = hlo_cost.count(step.fn, *step.args)
    assert once.matmul_flops == full.matmul_flops
    assert once.ops < full.ops


@pytest.mark.parametrize("mb", [1, 2])
def test_train_description_counts_donated_trees_once(mb, monkeypatch):
    """The reference's train step donates its parameters and Adam state
    (``donate_argnums=(0, 1)``), so its per-device total, argument + temp
    + output − alias, holds each of them once. The port's described step
    is the donated one: at the reduced qwen3-4b train shape (one and two
    microbatches) its outputs alias every parameter and moment (and the
    step counter), and its total is below the undonated step's by at least
    the new trees' bytes, which the undonated one holds beside the
    arguments."""
    monkeypatch.setattr(steps, "auto_microbatches", lambda *a, **k: mb)
    cfg = get_config("qwen3-4b").reduced()
    shape, mesh = ShapeConfig("t", FLOP_S, FLOP_B, "train"), make_cpu_mesh()
    counts = {}                          # shared, as between two meshes
    donated = dryrun.describe(cfg, shape, mesh, counts)["memory"]
    assert dryrun.describe(cfg, shape, mesh, counts)["memory"] == donated
    params, opt_state = steps.jitted_step(cfg, shape, mesh).args[:2]
    trees = hlo_cost.tree_bytes((params, opt_state))
    real = steps.make_train_step
    monkeypatch.setattr(steps, "make_train_step",
                        lambda *a, donate=False, **k: real(*a, **k))
    undonated = dryrun.describe(cfg, shape, mesh)["memory"]
    assert donated["alias_bytes"] == trees
    assert donated["output_bytes"] - trees == 3 * 4     # loss, norm, lb
    assert undonated["alias_bytes"] == 0
    assert (undonated["per_device_total"] - donated["per_device_total"]
            >= trees)
    for m in (donated, undonated):
        assert m["argument_bytes"] == undonated["argument_bytes"]
        assert m["per_device_total"] == (m["argument_bytes"]
                                         + m["temp_bytes"]
                                         + m["output_bytes"]
                                         - m["alias_bytes"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_time_loops_count_by_trip_count(arch, monkeypatch):
    """A wkv or Mamba time loop counted as one step T times gives the
    step-by-step loop's matmul FLOPs, forward and backward (reduced
    config, T = 6)."""
    cfg = get_config(arch).reduced()
    step = steps.jitted_step(cfg, ShapeConfig("t", 6, 2, "train"),
                             make_cpu_mesh(), microbatches=1)
    _, once = hlo_cost.count(step.fn, *step.args)
    monkeypatch.setattr(hlo_cost, "scans_by_trip_count",
                        hlo_cost.contextlib.nullcontext)
    _, loop = hlo_cost.count(step.fn, *step.args)
    assert once.matmul_flops == pytest.approx(loop.matmul_flops, rel=1e-12)
    assert once.ops < loop.ops


def test_counter_flops_bytes_and_live_bytes():
    a = torch.empty((8, 16), device="meta")
    b = torch.empty((16, 4), device="meta")

    def fn(a, b):
        x = a @ b                        # 2*8*16*4 FLOPs; 512 + 256 + 128 B
        y = torch.relu(x)                # 32 FLOPs; 128 + 128 B
        del x
        z = y.t()                        # a view: free
        return (z * 2).sum()
    out, c = hlo_cost.count(fn, a, b)
    assert out.shape == ()
    assert c.matmul_flops == 2 * 8 * 16 * 4
    assert c.flops == c.matmul_flops + 32 + 32 + 1
    assert c.bytes == (512 + 256 + 128) + 2 * 128 + 2 * 128 + (128 + 4)
    # x dies before z * 2 exists: at most y, z * 2 and the sum are live
    assert c.peak_live_bytes == 128 + 128 + 4
    with hlo_cost.trips(3):
        pass                             # outside a count: no effect


def test_per_device_bytes_and_weight_collectives():
    """By hand on a 16 x 16 mesh: a stacked (2, 256, 64) f32 weight is
    split 256 ways (model on 256, data on 64), a (64,) norm scale 16 ways
    (model); a train step of 3 microbatches all-gathers the weight's
    model shard twice per microbatch (forward, and the backward under
    remat) and reduce-scatters its gradient once, and all-reduces the
    data-replicated scale's gradient."""
    from repro_torch.sharding.rules import params_shardings
    mesh = FakeMesh()
    params = {"segments": {"seg0": {"w": torch.empty((2, 256, 64),
                                                     device="meta")}},
              "norm": torch.empty((64,), device="meta")}
    sh = params_shardings(params, mesh)
    assert tuple(sh["segments"]["seg0"]["w"]) == (None, "model", ("data",))
    assert tuple(sh["norm"]) == ("model",)
    w_bytes, n_bytes = 2 * 256 * 64 * 4, 64 * 4
    assert dryrun.per_device_bytes(params, sh, mesh) == \
        w_bytes / 256 + n_bytes / 16
    coll = dryrun.weight_collectives(params, sh, mesh, "train",
                                     microbatches=3)
    shard = w_bytes / 16                 # one model shard, gathered
    assert coll == {"all-gather": 3 * 2 * shard * 15 / 16,
                    "reduce-scatter": 3 * shard * 15 / 16,
                    "all-reduce": 3 * 2 * (n_bytes / 16) * 15 / 16}
    assert dryrun.weight_collectives(params, sh, mesh, "prefill") == {
        "all-gather": shard * 15 / 16}


def test_lower_only_grid_skips_where_the_reference_does(tmp_path):
    """Every (arch × shape) on both meshes: 'lowered' (the description
    built), or 'skipped' exactly where the reference's shape_supported
    skips; never 'error'. Records carry the simulated meta mesh."""
    for multi in (False, True):
        for arch in ARCH_IDS:
            for name in SHAPES:
                rec = dryrun.run_combo(arch, name, multi, str(tmp_path),
                                       lower_only=True)
                ok, _ = JSP.shape_supported(jget_config(arch), JSHAPES[name])
                assert rec["status"] == ("lowered" if ok else "skipped"), rec
                assert rec["simulated"] and rec["device"] == "meta"
                assert rec["chips"] == (512 if multi else 256)
    assert len(list(tmp_path.iterdir())) == 2 * len(ARCH_IDS) * len(SHAPES)


def test_main_writes_records_with_the_reference_keys(tmp_path, capsys):
    recs = dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                        "--opts", "serve_weight_stationary",
                        "--out", str(tmp_path)])
    (rec,) = recs
    assert rec["status"] == "ok" and rec["weight_stationary"]
    assert rec["tag"] == "serve_weight_stationary"
    for key in ("params", "params_active", "memory", "parsed", "roofline"):
        assert key in rec
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["parsed"]["collective_bytes"] == 0.0   # stationary weights
    assert rec["memory"]["per_device_total"] > rec["memory"][
        "argument_bytes"] > 0
    assert not flags.get().serve_weight_stationary    # restored
    assert '"status": "ok"' in capsys.readouterr().out
    (path,) = tmp_path.iterdir()
    assert path.name == ("whisper-small__decode_32k__16x16__"
                         "serve_weight_stationary.json")


def test_worker_processes_take_the_opts(tmp_path):
    """With --jobs > 1 the spawned workers describe under --opts, as the
    one process does, not under the defaults they import."""
    (rec,) = dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                          "--opts", "serve_weight_stationary", "--jobs", "2",
                          "--out", str(tmp_path)])
    assert rec["status"] == "ok" and rec["weight_stationary"]
    assert rec["parsed"]["collective_bytes"] == 0.0
    assert not flags.get().serve_weight_stationary


def test_a_failed_description_is_the_result(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no")
    monkeypatch.setattr(dryrun, "describe", broken)
    rec = dryrun.run_combo("qwen3-4b", "decode_32k", False, str(tmp_path))
    assert rec["status"] == "error" and "RuntimeError: no" in rec["error"]


def test_production_meshes_are_simulated_meta_grids():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        m = make_production_mesh(multi_pod=multi)
        assert m.axis_names == axes and tuple(m.shape.values()) == shape
        assert m.simulated and m.home.type == "meta"
