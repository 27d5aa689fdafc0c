"""In-loop evaluation snapshots: ``engine.core._eval_core`` run by the
training drivers at an ``eval_every`` cadence; the port of
``repro.engine.snapshots``.

After meta-step ``t`` (the CARRIED step) whenever ``(t + 1) %
eval_every == 0``, the just-updated θ is evaluated on a held-out pool
against the NOMINAL static S (the train-perturbed / test-nominal
protocol of Hadou et al. 2023): the snapshot is the eval-pool mean of
the per-layer loss and metric trajectory. On the card each eval dataset
runs its L layers through the graph-filter kernel (L forward launches
per dataset per snapshot).

RNG: eval dataset q of the snapshot after step t of a run with seed
``seed`` draws from ``core.unroll.snapshot_generator(seed, t, q)``, a
stream apart from the training, solve and robust streams and indexed by
the carried step, so a checkpoint-resumed run emits the snapshots of
the uninterrupted one. ``snapshot_reference`` recomputes a snapshot
offline (the parity oracle of the tests and ``chip_smoke.py``).

The reference emits a NaN row every step inside its compiled scan and
decimates on the host (``nan_snapshot``, ``decimate_snapshots``, ported
as its public API); the drivers here keep the on-cadence rows only and
return them in the decimated list's format.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.data.pipeline import stack_meta_datasets
from repro_torch.engine.core import _eval_core
from repro_torch.sharding.surf_rules import Placement, Replicas, ShardedPool
from repro_torch.utils.device import resolve_device, to_tensor

SNAPSHOT_KEYS = ("loss_per_layer", "acc_per_layer", "final_loss",
                 "final_acc")


def nan_snapshot(n_layers: int):
    """The off-cadence filler row: the structure and dtypes of a real
    snapshot, all NaN (decimation drops these rows)."""
    f = np.float32
    return {"loss_per_layer": np.full((n_layers,), np.nan, f),
            "acc_per_layer": np.full((n_layers,), np.nan, f),
            "final_loss": np.full((), np.nan, f),
            "final_acc": np.full((), np.nan, f)}


def make_snapshot_fn(cfg: SURFConfig, activation="relu", mix_fn=None,
                     task=None):
    """``snap(S, theta, eval_pool, seed, t)`` -> the eval-pool-mean
    snapshot dict of tensors: ``_eval_core`` on each dataset of the
    stacked pool with ``snapshot_generator(seed, t, q)``, then the mean
    over the pool (the aggregation of ``core.surf.evaluate_surf``).

    ``eval_pool`` is a dict of (Q, ...) tensors, or a
    ``sharding.surf_rules.ShardedPool`` Q-sharded over a mesh: each
    dataset is then evaluated on the device that holds it, with S and θ
    copied there once, and the rows are gathered to S's device for the
    mean (data-parallel snapshots). A mixer that bakes the TRAINING S
    (ring / halo) does not apply to the nominal S: snapshots take the
    default filter then, as the reference's dense snapshots do."""
    if not getattr(mix_fn, "takes_S", False):
        mix_fn = None
    ev_s = _eval_core(cfg, activation, mix_fn, task)

    @torch.no_grad()
    def snap(S, theta, eval_pool, seed, t):
        if not isinstance(eval_pool, ShardedPool):
            eval_pool = ShardedPool(eval_pool, Placement(None, None,
                                                         (S.device,)))
        reps = Replicas(S=S, theta=theta)
        outs = []
        for q in range(len(eval_pool)):
            dev = eval_pool.device_of(q)
            r = reps.on(dev)
            o = ev_s(r["S"], r["theta"], eval_pool.get(q),
                     U.snapshot_generator(seed, t, q, dev))
            outs.append({k: o[k].to(S.device) for k in SNAPSHOT_KEYS})
        return {k: torch.stack([o[k] for o in outs]).mean(0)
                for k in SNAPSHOT_KEYS}

    return snap


def snapshot_reference(cfg: SURFConfig, theta, S, eval_datasets, seed, t,
                       activation="relu", mix_fn=None, task=None,
                       device=None):
    """Offline recomputation of the in-loop snapshot emitted after
    meta-step ``t`` of a run with seed ``seed``, from θ: the parity
    oracle, and the post-hoc tool for a checkpointed θ. Numpy out."""
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    snap = make_snapshot_fn(cfg, activation, mix_fn, task)
    out = snap(to_tensor(S, device, torch.float32),
               {k: to_tensor(v, device) for k, v in theta.items()},
               stack_meta_datasets(eval_datasets, task, device), seed, t)
    return {k: v.cpu().numpy() for k, v in out.items()}


def decimate_snapshots(snaps, steps, eval_every, start=0, t_axis=0):
    """The reference's snapshot buffer (one fixed-shape row per step, NaN
    off cadence) ->
    list of snapshot dicts, keeping only the on-cadence rows. ``start``
    offsets the recorded step for resumed runs; ``t_axis`` is the time
    axis (0 for the single-seed drivers, 1 for the seed-batched
    (n_seeds, steps, ...) stacks)."""
    if not eval_every or steps == 0 or not snaps:
        return []
    host = {k: np.asarray(v) for k, v in snaps.items()}
    out = []
    for t in range(steps):
        if (start + t + 1) % eval_every == 0:
            row = {}
            for k, v in host.items():
                val = np.take(v, t, axis=t_axis)
                row[k] = float(val) if val.ndim == 0 else val
            row["step"] = start + t
            out.append(row)
    return out
