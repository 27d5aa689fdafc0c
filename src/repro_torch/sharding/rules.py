"""Partition specs for the LLM's params / batches / caches: the port of
``repro.sharding.rules``.

Policy (the reference's FSDP×TP 2-D sharding):
  * weights: largest divisible dim -> 'model'; next largest divisible
    dim -> the data axes ('pod','data') folded together. Stacked segment
    params skip their leading repeat axis.
  * batches: batch dim over data axes (replicated if not divisible).
  * KV caches: batch over data; kv-heads (or head-dim fallback) over
    'model'; when batch doesn't shard (long_500k, B=1) the cache SEQUENCE
    dim is sharded over data instead (ring-attention-style).
Every rule degrades to replication when a dim doesn't divide its axis.

The rules are pure functions of (path string, shape, mesh): ``mesh`` is
anything with ``axis_names`` and ``shape`` (a dict of axis sizes), the
port's ``launch.mesh.Mesh`` or a stand-in. A spec is a
``PartitionSpec``, a tuple with one entry per dim: ``None``
(replicated), ``"model"``, or a tuple of data axes, as the reference's
``jax.sharding.PartitionSpec`` holds them. The ``*_shardings`` functions
return a tree of specs shaped like their input (the reference returns
``NamedSharding``s of the same specs); paths are the tree's keys joined
with '/', as ``jax.tree_util.tree_map_with_path`` joins the reference's.
Nothing here moves data: the port runs on one card, and the dry run
(``launch.dryrun``) reads the specs to describe a step on the
production meshes.
"""
from __future__ import annotations

import numpy as np

from repro_torch import flags


class PartitionSpec(tuple):
    """One entry per dim: None, an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, axes):
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _divisible(dim, mesh, axes):
    return dim % axis_size(mesh, axes) == 0


def shard_factor(spec, mesh) -> int:
    """How many ways a tensor placed by ``spec`` is split: the product of
    the sizes of the axes it names (1 when replicated)."""
    n = 1
    for entry in spec:
        if entry is not None:
            n *= axis_size(mesh, entry)
    return n


def param_spec(path_str: str, shape, mesh, data_shard=True) -> P:
    """Sharding spec for one parameter leaf. ``data_shard=False`` gives
    weight-stationary (model-only) sharding for serving."""
    dp = data_axes(mesh) if data_shard else ()
    if flags.get().embed_d_sharded and path_str.endswith("embed/table") \
            and len(shape) == 2:
        # (V, d): shard d over model (gather of rows stays local per shard)
        spec = [None, None]
        if _divisible(shape[1], mesh, "model"):
            spec[1] = "model"
        if dp and _divisible(shape[0], mesh, dp):
            spec[0] = dp
        return P(*spec)
    start = 1 if "segments/" in path_str and len(shape) >= 2 else 0
    dims = list(range(start, len(shape)))
    if not dims:
        return P()
    spec = [None] * len(shape)
    by_size = sorted(dims, key=lambda i: (shape[i], i), reverse=True)
    mi = None
    if flags.get().megatron_pairs and len(shape) - start == 2:
        # name-aware col/row-parallel pairing (flag megatron_pairs)
        leaf_parent = path_str.rsplit("/", 2)[-2] if "/" in path_str else ""
        col = leaf_parent in ("wq", "wk", "wv", "wg", "wu")   # model on out
        row = leaf_parent in ("wo", "wd")                     # model on in
        if col or row:
            cand = len(shape) - (1 if col else 2)
            if _divisible(shape[cand], mesh, "model"):
                mi = cand
    if mi is None:
        # fallback: largest divisible dim (ties toward the last dim)
        mi = next((i for i in by_size if _divisible(shape[i], mesh, "model")
                   and shape[i] >= axis_size(mesh, "model")), None)
    if mi is not None:
        spec[mi] = "model"
    if dp:
        di = next((i for i in by_size
                   if i != mi and _divisible(shape[i], mesh, dp)
                   and shape[i] >= axis_size(mesh, dp)), None)
        if di is not None:
            spec[di] = dp
    return P(*spec)


def tree_map_with_path(fn, tree, path=()):
    """``fn("a/b/c", leaf)`` over a tree of dicts, lists and tuples (keys
    and indices joined with '/'), in the tree's shape."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def params_shardings(params, mesh, data_shard=True):
    return tree_map_with_path(
        lambda ps, leaf: param_spec(ps, tuple(leaf.shape), mesh, data_shard),
        params)


def batch_spec(shape, mesh) -> P:
    dp = data_axes(mesh)
    spec = [None] * len(shape)
    if dp and shape and _divisible(shape[0], mesh, dp) \
            and shape[0] >= axis_size(mesh, dp):
        spec[0] = dp
    return P(*spec)


def batch_shardings(batch, mesh):
    return tree_map_with_path(
        lambda _, leaf: batch_spec(tuple(leaf.shape), mesh), batch)


def cache_spec(path_str: str, shape, mesh) -> P:
    """Cache leaves are stacked (R, B, ...) per segment.

    attention k/v: (R, B, W, KV, dh); ssm h: (R, B, di, N);
    rwkv S: (R, B, H, dk, dv); conv/x_prev/cm_prev: (R, B, t, d)."""
    dp = data_axes(mesh)
    spec = [None] * len(shape)
    leaf = path_str.rsplit("/", 1)[-1]
    B = shape[1] if len(shape) >= 2 else 0
    batch_sharded = dp and _divisible(B, mesh, dp) and B >= axis_size(mesh, dp)
    if batch_sharded:
        spec[1] = dp
    if leaf in ("k", "v") and len(shape) == 5:
        _, _, W, KV, dh = shape
        if _divisible(KV, mesh, "model") and KV >= axis_size(mesh, "model"):
            spec[3] = "model"
        elif _divisible(dh, mesh, "model"):
            spec[4] = "model"
        if not batch_sharded and dp and _divisible(W, mesh, dp):
            spec[2] = dp            # sequence-sharded cache (long_500k)
    elif len(shape) >= 3:
        # ssm/rwkv states: shard the widest trailing dim over model
        dims = sorted(range(2, len(shape)), key=lambda i: shape[i],
                      reverse=True)
        mi = next((i for i in dims if _divisible(shape[i], mesh, "model")
                   and shape[i] >= axis_size(mesh, "model")), None)
        if mi is not None:
            spec[mi] = "model"
    return P(*spec)


def cache_shardings(cache, mesh):
    return tree_map_with_path(
        lambda ps, leaf: cache_spec(ps, tuple(leaf.shape), mesh), cache)
