"""The training drivers: Algorithm 1 as a loop over the meta-step; the
port of ``repro.engine.scan`` (``train_scan``, ``train``,
``_decimate_history``).

PyTorch runs eagerly, so the reference's one compiled ``lax.scan``
becomes a Python loop over the same meta-step in both drivers:

  * ``train_scan`` keeps the stacked dataset pool and every step's
    metrics on the device and turns them into history once, at the end:
    the loop itself makes no host sync (snapshots and checkpoints, when
    asked for, read the device at their cadence);
  * ``train`` copies the metrics to the host at each logged step, as the
    reference's step-wise driver does.

Meta-step t trains on dataset t mod Q and draws from
``core.unroll.step_generator(seed, t)``, the counterpart of the
reference's ``fold_in(PRNGKey(seed), t)`` (a robust config draws its
perturbations from ``robust_generator(seed, t)``).

Every per-step selection indexes the CARRIED ``state.step``, not the
loop counter, so a run resumed from a ``TrainState``
(``engine.resume``) continues the exact streams of the interrupted run:

  * SCHEDULE-aware: ``S`` may be a ``topology.schedule.TopologySchedule``,
    whose (T, n, n) stack moves to the run's device once, and meta-step t
    mixes with ``S[t % T]``. The default mixer and any S-as-argument
    (``takes_S``) mixer take each S_t; any other mixer is refused before
    the first step (``_check_schedule_mix``);
  * SNAPSHOT-aware: ``eval_every`` evaluates θ on a held-out pool after
    every ``eval_every``-th meta-step against the nominal ``S_eval``
    (``engine.snapshots``) and adds the snapshot list to the return;
  * CHECKPOINT-aware: ``checkpoint_every`` writes the carried state to
    ``<checkpoint_dir>/ckpt_<step>`` after every ``checkpoint_every``-th
    meta-step, on the absolute step grid (``checkpoint.io``).

Sharded pools (``mesh``, ``q_sharded``) are ROADMAP queue 1 item 8;
``core.surf.train_surf`` raises for them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.io import state_save_callback
from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.data.pipeline import stack_meta_datasets
from repro_torch.engine.core import _check_mix, _meta_step_core, init_state
from repro_torch.engine.snapshots import make_snapshot_fn
from repro_torch.topology.schedule import TopologySchedule
from repro_torch.utils.device import resolve_device, to_tensor


def _decimate_history(metrics, steps, log_every, start=0):
    """Per-key metric stacks with a trailing (steps,) time axis -> the
    step-wise ``train`` history format, keeping every ``log_every``-th
    step plus the last. Seed-batched (n_seeds, steps) stacks give entries
    of (n_seeds,) arrays. ``start`` offsets the recorded step for resumed
    runs; the cadence is on the ABSOLUTE step, so a resumed run's log
    continues the interrupted one's grid."""
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


def _check_cadences(eval_every, eval_datasets, checkpoint_every,
                    checkpoint_dir):
    if eval_every and eval_datasets is None:
        raise ValueError("eval_every > 0 needs eval_datasets (the "
                         "held-out snapshot pool)")
    if checkpoint_every and not checkpoint_dir:
        raise ValueError("checkpoint_every > 0 needs checkpoint_dir (the "
                         "directory the ckpt_<step> payloads are written "
                         "to)")


def _setup(cfg, S, meta_datasets, seed, constrained, activation, init,
           mix_fn, task, device, state, eval_every=0, eval_datasets=None,
           S_eval=None, checkpoint_every=0, checkpoint_dir=None):
    """The meta-step body, S (an (n, n) tensor, or a schedule's (T, n, n)
    stack) on the device, the stacked pool, the start state and the
    cadence hooks (``_Hooks``)."""
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    _check_cadences(eval_every, eval_datasets, checkpoint_every,
                    checkpoint_dir)
    sched = isinstance(S, TopologySchedule)
    if sched:
        _check_schedule_mix(mix_fn)
        if eval_every and S_eval is None:
            raise ValueError(
                "in-loop snapshots under a TopologySchedule need an "
                "explicit S_eval (the nominal static mixing matrix: "
                "robustness protocols evaluate on the unperturbed graph)")
        S = S.S
    meta_step_s, _ = _meta_step_core(cfg, constrained, activation, mix_fn,
                                     task)
    if state is None:
        state = init_state(U.seeded_generator(seed, device), cfg,
                           init=init, task=task)
    pool = stack_meta_datasets(meta_datasets, task, device)
    S = to_tensor(S, device, torch.float32)
    hooks = _Hooks(cfg, activation, mix_fn, task, device, seed,
                   eval_every, eval_datasets,
                   S if S_eval is None else S_eval, checkpoint_every,
                   state_save_callback(str(checkpoint_dir))
                   if checkpoint_every else None)
    return meta_step_s, S, sched, pool, state, device, hooks


class _Hooks:
    """What the drivers do at their cadences after a meta-step: the
    in-loop snapshot (rows kept by step index within the run) and the
    periodic checkpoint (``save``, a ``checkpoint.io`` callback). The
    seed-batched driver keeps one per seed, without ``save``."""

    def __init__(self, cfg, activation, mix_fn, task, device, seed,
                 eval_every, eval_datasets, S_eval, checkpoint_every, save):
        self.n_layers, self.seed = cfg.n_layers, seed
        self.eval_every = int(eval_every or 0)
        self.checkpoint_every = int(checkpoint_every or 0)
        self.save = save
        self.rows = {}
        if self.eval_every:
            self.snap = make_snapshot_fn(cfg, activation, mix_fn, task)
            self.eval_pool = stack_meta_datasets(eval_datasets, task,
                                                 device)
            self.S_eval = (None if S_eval is None
                           else to_tensor(S_eval, device, torch.float32))

    def after_step(self, i, t, state):
        """After the meta-step at carried step ``t`` (index ``i`` of this
        run) produced ``state``."""
        if self.eval_every and (t + 1) % self.eval_every == 0:
            self.rows[i] = self.snap(self.S_eval, state.theta,
                                     self.eval_pool, self.seed, t)
        if self.checkpoint_every and (t + 1) % self.checkpoint_every == 0:
            self.save(state)

    def snapshots(self, start):
        """The snapshot list, as the reference's ``decimate_snapshots``
        returns it: numpy values (a float for a scalar) and the absolute
        step."""
        out = []
        for i, row in sorted(self.rows.items()):
            vals = {k: v.cpu().numpy() for k, v in row.items()}
            out.append({**{k: float(v) if v.ndim == 0 else v
                           for k, v in vals.items()}, "step": start + i})
        return out


def _run(meta_step_s, S, sched, pool, state, seed, steps, device, draws,
         deltas, hooks):
    """``steps`` meta-steps from ``state``; yields (t, state, metrics)
    after each. Dataset, draws and, when ``sched``, the mixing matrix
    S[t % T] follow the absolute step t = ``state.step``; ``draws`` and
    ``deltas`` (indexed by t) replace the step's random draws."""
    n_q = next(iter(pool.values())).shape[0]
    for i in range(int(steps)):
        t = state.step
        batch = {k: v[t % n_q] for k, v in pool.items()}
        S_t = S[t % S.shape[0]] if sched else S
        kw = {}
        if meta_step_s.robust:
            kw = ({"deltas": deltas[t]} if deltas is not None else
                  {"delta_generator": U.robust_generator(seed, t, device)})
        if draws is None:
            state, m = meta_step_s(S_t, state, batch,
                                   U.step_generator(seed, t, device), **kw)
        else:
            state, m = meta_step_s(S_t, state, batch, draws=draws[t], **kw)
        hooks.after_step(i, t, state)
        yield t, state, m


def train_scan(cfg: SURFConfig, S, meta_datasets, steps, seed=0,
               constrained=True, activation="relu", log_every=0,
               init="dgd", mix_fn=None, task=None, device=None, state=None,
               draws=None, deltas=None, eval_every=0, eval_datasets=None,
               S_eval=None, checkpoint_every=0, checkpoint_dir=None):
    """Run ``steps`` meta-iterations, cycling the meta-training datasets
    on the device, with no host sync inside the loop. Returns (state,
    history) — or (state, history, snapshots) when ``eval_every`` > 0 —
    the history decimated to ``log_every`` at the end. ``S`` is an
    (n, n) mixing matrix or a ``TopologySchedule`` (meta-step t mixes
    with ``S.S[t % T]``; snapshots then need the nominal ``S_eval``,
    which defaults to a static ``S``).

    ``state`` starts from a given ``TrainState`` instead of
    ``init_state(seed)`` (history and snapshots then record absolute
    steps); ``draws`` (one ``(W0, Xl, Yl)`` each) and ``deltas`` (a
    robust config's perturbations), both indexed by the absolute step,
    replace the per-step random draws. The tests use them to replay a
    reference run. ``checkpoint_every``/``checkpoint_dir`` write the
    carried state at that cadence (``engine.resume`` restores it)."""
    meta_step_s, S, sched, pool, state, device, hooks = _setup(
        cfg, S, meta_datasets, seed, constrained, activation, init, mix_fn,
        task, device, state, eval_every, eval_datasets, S_eval,
        checkpoint_every, checkpoint_dir)
    start, rows = state.step, []
    for _, state, m in _run(meta_step_s, S, sched, pool, state, seed, steps,
                            device, draws, deltas, hooks):
        rows.append(m)
    metrics = ({k: torch.stack([r[k] for r in rows]).cpu() for k in rows[0]}
               if rows else {})
    hist = _decimate_history(metrics, len(rows), log_every, start)
    if eval_every:
        return state, hist, hooks.snapshots(start)
    return state, hist


def train(cfg: SURFConfig, S, meta_datasets, steps, seed=0,
          constrained=True, activation="relu", log_every=0, init="dgd",
          mix_fn=None, task=None, device=None, state=None, draws=None,
          deltas=None, eval_every=0, eval_datasets=None, S_eval=None,
          checkpoint_every=0, checkpoint_dir=None):
    """Step-wise Algorithm 1: the same loop, meta-step, draws and
    cadences as ``train_scan``, copying the metrics to the host at each
    logged step. Returns (state, history), or (state, history,
    snapshots) with ``eval_every``."""
    meta_step_s, S, sched, pool, state, device, hooks = _setup(
        cfg, S, meta_datasets, seed, constrained, activation, init, mix_fn,
        task, device, state, eval_every, eval_datasets, S_eval,
        checkpoint_every, checkpoint_dir)
    start = state.step
    hist, end = [], start + int(steps) - 1
    for t, state, m in _run(meta_step_s, S, sched, pool, state, seed, steps,
                            device, draws, deltas, hooks):
        if log_every and (t % log_every == 0 or t == end):
            hist.append({k: float(v) for k, v in m.items()} | {"step": t})
    if eval_every:
        return state, hist, hooks.snapshots(start)
    return state, hist
