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

Time-varying schedules, in-scan snapshots, periodic checkpoints, sharded
pools and seed batches are not ported yet; ``core.surf.train_surf``
raises for them, naming their ROADMAP items.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import _meta_step_core, init_state
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


def _setup(cfg, S, meta_datasets, seed, constrained, activation, init,
           mix_fn, task, device, state):
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    meta_step_s, _ = _meta_step_core(cfg, constrained, activation, mix_fn,
                                     task)
    if state is None:
        state = init_state(U.seeded_generator(seed, device), cfg,
                           init=init, task=task)
    pool = stack_meta_datasets(meta_datasets, task, device)
    return (meta_step_s, to_tensor(S, device, torch.float32), pool, state,
            device)


def _run(meta_step_s, S, pool, state, seed, steps, device, draws):
    """``steps`` meta-steps from ``state``; yields (t, state, metrics)
    after each. Dataset and draws follow the absolute step ``state.step``."""
    n_q = next(iter(pool.values())).shape[0]
    for _ in range(int(steps)):
        t = state.step
        batch = {k: v[t % n_q] for k, v in pool.items()}
        if draws is None:
            state, m = meta_step_s(S, state, batch,
                                   U.step_generator(seed, t, device))
        else:
            state, m = meta_step_s(S, state, batch, draws=draws[t])
        yield t, state, m


def train_scan(cfg: SURFConfig, S, meta_datasets, steps, seed=0,
               constrained=True, activation="relu", log_every=0,
               init="dgd", mix_fn=None, task=None, device=None, state=None,
               draws=None):
    """Run ``steps`` meta-iterations, cycling the meta-training datasets
    on the device, with no host sync inside the loop. Returns (state,
    history), the history decimated to ``log_every`` at the end.

    ``state`` starts from a given ``TrainState`` instead of
    ``init_state(seed)``; ``draws`` (indexed by the absolute step, one
    ``(W0, Xl, Yl)`` each) replaces the per-step random draws. The tests
    use both to replay a reference run."""
    meta_step_s, S, pool, state, device = _setup(
        cfg, S, meta_datasets, seed, constrained, activation, init, mix_fn,
        task, device, state)
    start, rows = state.step, []
    for _, state, m in _run(meta_step_s, S, pool, state, seed, steps,
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
    ``train_scan``, copying the metrics to the host at each logged step.
    Returns (state, history)."""
    meta_step_s, S, pool, state, device = _setup(
        cfg, S, meta_datasets, seed, constrained, activation, init, mix_fn,
        task, device, state)
    hist, end = [], state.step + int(steps) - 1
    for t, state, m in _run(meta_step_s, S, pool, state, seed, steps,
                            device, draws):
        if log_every and (t % log_every == 0 or t == end):
            hist.append({k: float(v) for k, v in m.items()} | {"step": t})
    return state, hist
