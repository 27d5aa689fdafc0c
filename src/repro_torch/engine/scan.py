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

MESH-aware: on a ``launch.mesh.Mesh`` the run lives on the mesh's home
device, and ``mix_fn`` may be a halo/ring exchange over its agent axis
(``topology.halo``; a SCHEDULED halo mixer built from the same schedule
is re-bound at each step by ``mix_fn.at_step(state.step)``). The
snapshot pool is Q-sharded over the agent-role axis (data-parallel
snapshots); ``q_sharded=True`` Q-shards the TRAINING pool too (each
device holds Q/P datasets) and selects meta-step t's dataset by copying
it from its owner (``surf_rules.make_q_select``), bit-equal to the
replicated index. Placements come from ``surf_rules.train_scan_shardings``.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.checkpoint.io import state_save_callback
from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.data.pipeline import stack_meta_datasets
from repro_torch.engine.core import (_meta_step_core,
                                     _reject_seed_batched_mix, init_state)
from repro_torch.engine.snapshots import make_snapshot_fn
from repro_torch.launch.mesh import mesh_device
from repro_torch.sharding import surf_rules as R
from repro_torch.topology.halo import _digest, _np32
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


def _check_schedule_mix(S, mix_fn):
    """Validate a (TopologySchedule, mix_fn) pair before the first step:
    the default mixer (None) and any S-as-argument (``takes_S``) mixer
    are handed each step's S_t; a baked-S mixer would silently ignore
    the schedule; a SCHEDULED halo mixer must match the schedule in
    length AND content (its coefficient blocks ARE the mixing
    matrices)."""
    _reject_seed_batched_mix(mix_fn, "the single-seed engine")
    scheduled = bool(getattr(mix_fn, "scheduled", False))
    if (mix_fn is not None and not scheduled
            and not getattr(mix_fn, "takes_S", False)):
        raise ValueError(
            "a TopologySchedule requires the default mixer, an "
            "S-as-argument mixer (takes_S, such as kernels.graph_filter."
            "make_plain_mix) or a SCHEDULED mixer (topology.halo."
            "make_scheduled_halo_mix): a baked-S mix_fn would silently "
            "ignore the schedule")
    if scheduled:
        if mix_fn.steps != S.steps:
            raise ValueError(
                f"scheduled mix_fn has {mix_fn.steps} steps but the "
                f"TopologySchedule has {S.steps} — build the mixer from "
                "the same schedule (topology.halo.make_scheduled_halo_mix)")
        if mix_fn.schedule_digest != _digest(_np32(S.S)):
            raise ValueError(
                "scheduled mix_fn was built from a DIFFERENT schedule "
                "(content digest mismatch) — its coefficient blocks "
                "would silently override this schedule's S_t stream; "
                "rebuild it from this TopologySchedule via "
                "topology.halo.make_scheduled_halo_mix")


def _check_q_sharded(mesh, mix_fn, n_q):
    """The reference's q_sharded guards; returns the select, or None when
    the pool replicates anyway (an axis of one device)."""
    if mesh is None:
        raise ValueError(
            "q_sharded=True needs mesh (the Q-sharded placement and the "
            "select are built from the mesh's agent-role axis and the "
            "pool's Q size)")
    if mix_fn is not None and not getattr(mix_fn, "takes_S", False):
        raise ValueError(
            "q_sharded=True requires the default mixing path or an "
            "S-as-argument (takes_S) mixer: ring/halo mixers split the "
            "AGENT axis over the same devices the Q axis would shard "
            "over — one axis, one role")
    agent_ax = R.axis_for_role(mesh, "agent")
    R.check_divides(n_q, R._axis_size(mesh, agent_ax),
                    "q_sharded train pool", "Q",
                    "the Q (meta-dataset pool) axis shards over the "
                    "mesh's agent-role axis")
    q_ax = R.q_select_axis(mesh, n_q, agent_ax)
    return None if q_ax is None else R.make_q_select(mesh, q_ax)


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
           S_eval=None, checkpoint_every=0, checkpoint_dir=None, mesh=None,
           q_sharded=False):
    """The meta-step body, S (an (n, n) tensor, or a schedule's (T, n, n)
    stack) on the device, the stacked pool, the start state, the cadence
    hooks (``_Hooks``) and the pool's select (None: the replicated
    index). On a ``mesh`` the device is its home device."""
    device = (resolve_device(device) if mesh is None
              else mesh_device(mesh, device))
    task = resolve_task(cfg, task)
    _check_cadences(eval_every, eval_datasets, checkpoint_every,
                    checkpoint_dir)
    _reject_seed_batched_mix(mix_fn, "the single-seed engine")
    sched = isinstance(S, TopologySchedule)
    if sched:
        _check_schedule_mix(S, mix_fn)
        if eval_every and S_eval is None:
            raise ValueError(
                "in-loop snapshots under a TopologySchedule need an "
                "explicit S_eval (the nominal static mixing matrix: "
                "robustness protocols evaluate on the unperturbed graph)")
        S = S.S
    elif getattr(mix_fn, "scheduled", False):
        raise ValueError("a scheduled mix_fn needs a TopologySchedule S "
                         "(its per-step blocks follow the schedule)")
    pool = stack_meta_datasets(meta_datasets, task, device)
    n_q = int(next(iter(pool.values())).shape[0])
    select = _check_q_sharded(mesh, mix_fn, n_q) if q_sharded else None
    if select is not None:
        pool = R.ShardedPool(pool, R.train_scan_shardings(
            mesh, q_sharded=True, n_q=n_q)["pool"])
    meta_step_s, _ = _meta_step_core(cfg, constrained, activation, mix_fn,
                                     task)
    if state is None:
        state = init_state(U.seeded_generator(seed, device), cfg,
                           init=init, task=task)
    S = to_tensor(S, device, torch.float32)
    hooks = _Hooks(cfg, activation, mix_fn, task, device, seed,
                   eval_every, eval_datasets,
                   S if S_eval is None else S_eval, checkpoint_every,
                   state_save_callback(str(checkpoint_dir))
                   if checkpoint_every else None, mesh=mesh)
    if select is not None:
        select = partial(select, device=device)
    return meta_step_s, S, sched, pool, state, device, hooks, select


class _Hooks:
    """What the drivers do at their cadences after a meta-step: the
    in-loop snapshot (rows kept by step index within the run) and the
    periodic checkpoint (``save``, a ``checkpoint.io`` callback). The
    seed-batched driver keeps one per seed, without ``save``."""

    def __init__(self, cfg, activation, mix_fn, task, device, seed,
                 eval_every, eval_datasets, S_eval, checkpoint_every, save,
                 mesh=None):
        self.n_layers, self.seed = cfg.n_layers, seed
        self.eval_every = int(eval_every or 0)
        self.checkpoint_every = int(checkpoint_every or 0)
        self.save = save
        self.rows = {}
        if self.eval_every:
            self.snap = make_snapshot_fn(cfg, activation, mix_fn, task)
            self.eval_pool = stack_meta_datasets(eval_datasets, task,
                                                 device)
            if mesh is not None:
                # Q-sharded over the mesh: data-parallel snapshots
                n = int(next(iter(self.eval_pool.values())).shape[0])
                self.eval_pool = R.ShardedPool(
                    self.eval_pool,
                    R.train_scan_shardings(mesh, n_eval_q=n)["eval_pool"])
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
         deltas, hooks, select=None):
    """``steps`` meta-steps from ``state``; yields (t, state, metrics)
    after each. Dataset, draws and, when ``sched``, the mixing matrix
    S[t % T] follow the absolute step t = ``state.step``; ``draws`` and
    ``deltas`` (indexed by t) replace the step's random draws.
    ``select(pool, t)`` replaces the index of a replicated pool (the
    Q-sharded pool's copy from its owner)."""
    if select is None:
        n_q = next(iter(pool.values())).shape[0]

        def select(pool, t):
            return {k: v[t % n_q] for k, v in pool.items()}
    for i in range(int(steps)):
        t = state.step
        batch = select(pool, t)
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
               S_eval=None, checkpoint_every=0, checkpoint_dir=None,
               mesh=None, q_sharded=False):
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
    carried state at that cadence (``engine.resume`` restores it).

    ``mesh`` runs on the mesh's home device with its snapshot pool
    Q-sharded; ``mix_fn`` may then be a ring/halo exchange over its
    agent axis (a scheduled one with a schedule). ``q_sharded=True``
    Q-shards the training pool over the agent-role axis; it needs
    ``mesh`` and the default or a ``takes_S`` mixer."""
    meta_step_s, S, sched, pool, state, device, hooks, select = _setup(
        cfg, S, meta_datasets, seed, constrained, activation, init, mix_fn,
        task, device, state, eval_every, eval_datasets, S_eval,
        checkpoint_every, checkpoint_dir, mesh, q_sharded)
    start, rows = state.step, []
    for _, state, m in _run(meta_step_s, S, sched, pool, state, seed, steps,
                            device, draws, deltas, hooks, select):
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
    logged step (unsharded, as the reference's step-wise driver).
    Returns (state, history), or (state, history, snapshots) with
    ``eval_every``."""
    meta_step_s, S, sched, pool, state, device, hooks, _ = _setup(
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
