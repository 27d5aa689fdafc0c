"""Checkpoint io in the reference's format: the port of
``repro.checkpoint.io`` (npz payload + json manifest).

A tree (a ``TrainState``, a dict, nested NamedTuples, dicts and
sequences) is flattened in the reference's order: NamedTuple fields in
their order, dict keys sorted, sequences in order; None is an empty
subtree, as in ``jax.tree_util``. Leaf i is saved as array ``k<i>`` of
``<path>.npz``; ``<path>.json`` records each leaf's path
(``.theta/M``, ``.opt_state/t``, ...) and dtype, and the step. bf16 is
stored as its uint16 bits. A Python int leaf (the port's carried
``step``) is written as an int32 array, the reference's leaf, so each
package restores the other's checkpoints.

``restore`` reads into the structure of a template whose leaves are
tensors (their shape and dtype; a template on the ``meta`` device costs
nothing) or Python ints, and places every tensor on ``device``. Missing
files raise ``FileNotFoundError`` with the offending path; a leaf-count
mismatch raises ``ValueError``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def flatten(tree, path=()):
    """[(path components, leaf)] in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in flatten(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten(v, path + (str(i),))]
    return [(path, tree)]


def unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, dict):
        out = {k: unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(leaf):
    """A leaf as (numpy array, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = leaf.numpy()
    elif isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, (int, np.integer)):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path, tree, step=None):
    """Write ``tree`` to ``<path>.npz`` and its manifest to
    ``<path>.json`` (the reference's format; see the module docstring)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, manifest = {}, {"leaves": [], "step": step}
    for i, (p, leaf) in enumerate(flatten(tree)):
        arrays[f"k{i}"], dt = _to_numpy(leaf)
        manifest["leaves"].append({"path": "/".join(p), "dtype": dt})
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def _from_numpy(arr, meta, like, device):
    """Leaf ``arr`` (manifest entry ``meta``) in the template leaf's
    dtype and shape, on ``device``; an int template leaf gives an int."""
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(like.dtype).reshape(like.shape).to(device)
    if t.numel() != 1:
        raise ValueError(f"leaf {meta['path']!r} has shape "
                         f"{tuple(t.shape)}, the template an int")
    return int(t.reshape(()).item())


def restore(path, like, *, device=None):
    """Restore ``<path>`` into the structure of the template ``like``
    (tensor leaves give shape and dtype, int leaves read back as ints);
    tensors are placed on ``device`` (None: the CUDA card)."""
    manifest_file = path + ".json"
    if not os.path.exists(manifest_file):
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (missing manifest "
            f"{manifest_file!r})")
    payload_file = path + ".npz"
    if not os.path.exists(payload_file):
        raise FileNotFoundError(
            f"checkpoint {path!r} has a manifest but no payload "
            f"({payload_file!r} missing)")
    with open(manifest_file) as f:
        manifest = json.load(f)
    leaves = [leaf for _, leaf in flatten(like)]
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint {path!r} has {len(manifest['leaves'])} leaves, "
            f"template has {len(leaves)} — config/template drift?")
    device = resolve_device(device)
    with np.load(payload_file) as data:
        got = [_from_numpy(data[f"k{i}"], meta, leaf, device)
               for i, (leaf, meta) in enumerate(zip(leaves,
                                                    manifest["leaves"]))]
    return unflatten(like, iter(got))


def state_save_callback(directory, prefix="ckpt_"):
    """The periodic-checkpoint target of the training drivers: a function
    of the carried ``TrainState`` that writes the
    ``<directory>/<prefix><step>`` payload ``engine.resume.save_state``
    would, the step read off the state's own carried ``step``."""
    def cb(state):
        step = int(state.step)
        save(os.path.join(directory, f"{prefix}{step}"), state, step=step)
    return cb


def stacked_state_save_callback(directory, prefix="ckpt_"):
    """Seed-batched sibling of ``state_save_callback``: the STACKED
    per-seed state (every leaf with a leading n_seeds axis, on the device
    or the host; the lockstep step an int) is written as ONE payload under
    ``<directory>/<prefix><step>/seeds``, its step leaf a (n_seeds,)
    int32 vector as in the reference's layout."""
    def cb(states):
        step = int(states.step)
        n_seeds = int(states.lam.shape[0])
        save(os.path.join(directory, f"{prefix}{step}", "seeds"),
             states._replace(step=np.full(n_seeds, step, np.int32)),
             step=step)
    return cb


def latest_step(directory, prefix="ckpt_"):
    """Highest checkpoint step under ``directory``, or None when the
    directory is missing, empty, or holds no parseable checkpoints
    (malformed ``<prefix><non-int>.json`` names are skipped)."""
    if not directory or not os.path.isdir(directory):
        return None
    steps = []
    for f in os.listdir(directory):
        if not (f.startswith(prefix) and f.endswith(".json")):
            continue
        try:
            steps.append(int(f[len(prefix):-5]))
        except ValueError:
            continue
    return max(steps) if steps else None
