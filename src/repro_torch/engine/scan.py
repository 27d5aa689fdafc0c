"""The training drivers: Algorithm 1 as a loop over the meta-step; the
port of ``repro.engine.scan`` (``train_scan``, ``train``,
``_decimate_history``).

PyTorch runs eagerly, so the reference's one compiled ``lax.scan``
becomes a Python loop over the same meta-step in both drivers:

  * ``train_scan`` keeps the stacked dataset pool and every step's
    metrics on the device and turns them into history once, at the end:
    the loop itself makes no host sync;
  * ``train`` copies the metrics to the host at each logged step, as the
    reference's step-wise driver does.

Meta-step t trains on dataset t mod Q and draws from
``core.unroll.step_generator(seed, t)``, the counterpart of the
reference's ``fold_in(PRNGKey(seed), t)``.

Both drivers are SCHEDULE-aware: ``S`` may be a
``topology.schedule.TopologySchedule``, whose (T, n, n) stack moves to
the run's device once, and meta-step t mixes with ``S[t % T]``. As for
the dataset and the draws, t is the CARRIED ``state.step``, not the loop
counter, so a run resumed from a ``TrainState`` continues at the right
S_t. The default mixer and any S-as-argument (``takes_S``) mixer take
each S_t; any other mixer is refused before the first step
(``_check_schedule_mix``).

In-scan snapshots, periodic checkpoints, sharded pools and seed batches
are not ported yet; ``core.surf.train_surf`` raises for them, naming
their ROADMAP items.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import _check_mix, _meta_step_core, init_state
from repro_torch.topology.schedule import TopologySchedule
from repro_torch.utils.device import resolve_device, to_tensor


def stack_meta_datasets(datasets, task, device):
    """The meta-training pool as one dict of (Q, ...) tensors on
    ``device`` (the reference keeps this in ``data.pipeline``); an
    already stacked dict passes through ``task.to_batch``."""
    if isinstance(datasets, (list, tuple)):
        if not datasets:
            raise ValueError("empty meta-training pool")
        datasets = {k: np.stack([np.asarray(ds[k]) for ds in datasets])
                    for k in ("Xtr", "Ytr", "Xte", "Yte")}
    return task.to_batch(datasets, device)


def _decimate_history(metrics, steps, log_every, start=0):
    """Per-key (steps,) metric stacks -> the step-wise ``train`` history
    format, keeping every ``log_every``-th step plus the last; ``start``
    offsets the recorded step."""
    if not log_every or steps == 0:
        return []
    host = {k: np.asarray(v) for k, v in metrics.items()}
    idx = [t for t in range(steps)
           if (start + t) % log_every == 0 or t == steps - 1]
    out = []
    for t in idx:
        row = {}
        for k, v in host.items():
            val = np.take(v, t, axis=-1)
            row[k] = float(val) if val.ndim == 0 else val
        row["step"] = start + t
        out.append(row)
    return out


def _check_schedule_mix(mix_fn):
    """Validate the mixer of a scheduled run before its first step: the
    default mixer (None) and any S-as-argument (``takes_S``) mixer are
    handed each step's S_t; a baked-S mixer would silently ignore the
    schedule, and seed-batched or scheduled halo mixers are not ported
    (``engine.core._check_mix``)."""
    _check_mix(mix_fn)
    if mix_fn is not None and not getattr(mix_fn, "takes_S", False):
        raise ValueError(
            "a TopologySchedule requires the default mixer or an "
            "S-as-argument mixer (takes_S, such as kernels.graph_filter."
            "make_plain_mix): a baked-S mix_fn would silently ignore the "
            "schedule")


def _setup(cfg, S, meta_datasets, seed, constrained, activation, init,
           mix_fn, task, device, state):
    """The meta-step body, S (an (n, n) tensor, or a schedule's (T, n, n)
    stack) on the device, the stacked pool and the start state."""
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    sched = isinstance(S, TopologySchedule)
    if sched:
        _check_schedule_mix(mix_fn)
        S = S.S
    meta_step_s, _ = _meta_step_core(cfg, constrained, activation, mix_fn,
                                     task)
    if state is None:
        state = init_state(U.seeded_generator(seed, device), cfg,
                           init=init, task=task)
    pool = stack_meta_datasets(meta_datasets, task, device)
    return (meta_step_s, to_tensor(S, device, torch.float32), sched, pool,
            state, device)


def _run(meta_step_s, S, sched, pool, state, seed, steps, device, draws):
    """``steps`` meta-steps from ``state``; yields (t, state, metrics)
    after each. Dataset, draws and, when ``sched``, the mixing matrix
    S[t % T] follow the absolute step t = ``state.step``."""
    n_q = next(iter(pool.values())).shape[0]
    for _ in range(int(steps)):
        t = state.step
        batch = {k: v[t % n_q] for k, v in pool.items()}
        S_t = S[t % S.shape[0]] if sched else S
        if draws is None:
            state, m = meta_step_s(S_t, state, batch,
                                   U.step_generator(seed, t, device))
        else:
            state, m = meta_step_s(S_t, state, batch, draws=draws[t])
        yield t, state, m


def train_scan(cfg: SURFConfig, S, meta_datasets, steps, seed=0,
               constrained=True, activation="relu", log_every=0,
               init="dgd", mix_fn=None, task=None, device=None, state=None,
               draws=None):
    """Run ``steps`` meta-iterations, cycling the meta-training datasets
    on the device, with no host sync inside the loop. Returns (state,
    history), the history decimated to ``log_every`` at the end. ``S``
    is an (n, n) mixing matrix or a ``TopologySchedule`` (meta-step t
    mixes with ``S.S[t % T]``).

    ``state`` starts from a given ``TrainState`` instead of
    ``init_state(seed)``; ``draws`` (indexed by the absolute step, one
    ``(W0, Xl, Yl)`` each) replaces the per-step random draws. The tests
    use both to replay a reference run."""
    meta_step_s, S, sched, pool, state, device = _setup(
        cfg, S, meta_datasets, seed, constrained, activation, init, mix_fn,
        task, device, state)
    start, rows = state.step, []
    for _, state, m in _run(meta_step_s, S, sched, pool, state, seed, steps,
                            device, draws):
        rows.append(m)
    if not rows:
        return state, []
    metrics = {k: torch.stack([r[k] for r in rows]).cpu()
               for k in rows[0]}
    return state, _decimate_history(metrics, len(rows), log_every, start)


def train(cfg: SURFConfig, S, meta_datasets, steps, seed=0,
          constrained=True, activation="relu", log_every=0, init="dgd",
          mix_fn=None, task=None, device=None, state=None, draws=None):
    """Step-wise Algorithm 1: the same loop, meta-step and draws as
    ``train_scan``, copying the metrics to the host at each logged step;
    ``S`` may be a ``TopologySchedule`` here too. Returns (state,
    history)."""
    meta_step_s, S, sched, pool, state, device = _setup(
        cfg, S, meta_datasets, seed, constrained, activation, init, mix_fn,
        task, device, state)
    hist, end = [], state.step + int(steps) - 1
    for t, state, m in _run(meta_step_s, S, sched, pool, state, seed, steps,
                            device, draws):
        if log_every and (t % log_every == 0 or t == end):
            hist.append({k: float(v) for k, v in m.items()} | {"step": t})
    return state, hist
