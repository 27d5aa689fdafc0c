"""The port's partition rules (``sharding.rules``) against the reference's,
on the CPU: ``param_spec`` on every leaf of every arch's parameter tree
and ``cache_spec`` on every leaf of its decode caches (decode_32k's and
long_500k's, where a batch of one shards the cache's sequence), on the
reference's duck-typed meshes (16×16 and 2×16×16), with the default
flags, ``embed_d_sharded`` and ``megatron_pairs``; ``batch_spec``; the
``*_shardings`` trees; and a divisibility property (hypothesis), as the
reference's ``tests/test_properties.py`` holds its own.
"""
import dataclasses

import jax
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import flags as jflags
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as JSP
from repro.sharding import rules as JR
from repro_torch import flags
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import rules as R

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


MESHES = {"16x16": FakeMesh(), "2x16x16": FakePodMesh()}
FLAG_SETS = {"default": {}, "embed_d_sharded": {"embed_d_sharded": True},
             "megatron_pairs": {"megatron_pairs": True}}


@pytest.fixture(autouse=True)
def reset_flags():
    yield
    for f in (jflags, flags):
        f.set_flags(**dataclasses.asdict(f.Flags()))


def _set(**kw):
    for f in (jflags, flags):
        f.set_flags(**kw)


def _t(spec):
    """A port spec as ``jax.sharding.PartitionSpec`` holds it: JAX keeps a
    one-axis tuple entry as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jpaths(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tpaths(tree):
    out = {}
    R.tree_map_with_path(lambda ps, t: out.__setitem__(ps, tuple(t.shape)),
                         tree)
    return out


@pytest.fixture(scope="module", params=ARCH_IDS)
def trees(request):
    """(arch, reference and port leaves: params, decode_32k's and
    long_500k's caches), path -> shape."""
    arch = request.param
    cfg, jcfg = get_config(arch), jget_config(arch)
    out = {"params": (_jpaths(JSP.params_spec(jcfg)),
                      _tpaths(SP.params_spec(cfg)))}
    for name in ("decode_32k", "long_500k"):
        s = SHAPES[name]
        out[name] = (_jpaths(JSP.cache_spec_tree(jcfg, s.global_batch,
                                                 s.seq_len)),
                     _tpaths(SP.cache_spec_tree(cfg, s.global_batch,
                                                s.seq_len)))
    return arch, out


@pytest.mark.parametrize("flag_set", list(FLAG_SETS))
def test_param_and_cache_specs_match_reference_on_every_leaf(trees,
                                                             flag_set):
    _, out = trees
    _set(**FLAG_SETS[flag_set])
    for mesh in MESHES.values():
        jp, tp = out["params"]
        assert jp == tp          # the same paths joined the same way
        for path, shape in tp.items():
            assert _t(R.param_spec(path, shape, mesh)) == tuple(
                JR.param_spec(path, shape, mesh)), path
            assert _t(R.param_spec(path, shape, mesh, False)) == tuple(
                JR.param_spec(path, shape, mesh, False)), path
        for name in ("decode_32k", "long_500k"):
            jc, tc = out[name]
            assert jc == tc
            for path, shape in tc.items():
                assert _t(R.cache_spec(path, shape, mesh)) == tuple(
                    JR.cache_spec(path, shape, mesh)), (name, path)


def test_batch_specs_and_data_axes_match_reference():
    for mesh in MESHES.values():
        assert R.data_axes(mesh) == JR.data_axes(mesh)
        assert R.axis_size(mesh, R.data_axes(mesh)) == JR.axis_size(
            mesh, JR.data_axes(mesh))
        for shape in [(256, 4096), (32, 32768), (128, 1), (1, 1), (),
                      (24, 5), (512, 8, 3)]:
            assert _t(R.batch_spec(shape, mesh)) == tuple(
                JR.batch_spec(shape, mesh)), shape


def test_shardings_trees_follow_their_inputs():
    """Trees of specs shaped like the input; a production (meta) mesh
    places like the duck-typed one."""
    cfg = get_config("qwen3-4b")
    mesh = make_production_mesh()
    params = SP.params_spec(cfg)
    sh = R.params_shardings(params, mesh)
    assert sh.keys() == params.keys()
    w = params["segments"]["seg0"]["s0"]["attn"]["wq"]["w"]
    assert R.params_shardings(params, mesh)["segments"]["seg0"]["s0"][
        "attn"]["wq"]["w"] == R.param_spec("segments/seg0/s0/attn/wq/w",
                                           tuple(w.shape), FakeMesh())
    specs = SP.input_specs(cfg, SHAPES["decode_32k"])
    bsh = R.batch_shardings({"t": specs["token"]}, mesh)
    assert tuple(bsh["t"]) == (("data",), None)
    csh = R.cache_shardings(specs["cache"], mesh)
    k = csh["seg0"]["s0"]["k"]    # (36, 128, 32768, 8, 128): KV = 8 < 16
    assert isinstance(k, R.PartitionSpec)
    assert tuple(k) == (None, ("data",), None, None, "model")
    assert R.shard_factor(k, mesh) == 256
    assert R.tree_map_with_path(lambda p, x: p, {"a": [1, (2, 3)]}) == {
        "a": ["a/0", ("a/1/0", "a/1/1")]}


@settings(max_examples=200, deadline=None, database=None)
@given(st.integers(1, 4096), st.integers(1, 4096), st.booleans())
def test_param_spec_divisibility(d1, d2, pod):
    """Whatever the dims, the chosen spec only shards divisible axes, and
    it is the reference's."""
    mesh = FakePodMesh() if pod else FakeMesh()
    dp = R.data_axes(mesh)
    spec = R.param_spec("w", (d1, d2), mesh)
    assert _t(spec) == tuple(JR.param_spec("w", (d1, d2), mesh))
    for dim, s in zip((d1, d2), tuple(spec)):
        if s == "model":
            assert dim % 16 == 0
        if s == dp:
            assert dim % R.axis_size(mesh, dp) == 0
    assert torch.Size((d1, d2)).numel() % R.shard_factor(spec, mesh) == 0
