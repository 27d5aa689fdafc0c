"""Seed-batched training: one run trains a batch of init/topology seeds
in LOCKSTEP; the port of ``repro.engine.seeds``.

The reference vmaps its meta-step over the seed axis inside one compiled
scan. At PAPER width one meta-step peaks at about 19.4 GB, of which θ
and Adam's m and v take 6.37 GB, so a meta-step vectorised over 4 seeds
would hold about 78 GB. Here every seed keeps its own ``TrainState`` and
its own ``engine.scan._run`` loop, the sequential driver's, and the
loops advance in lockstep: step t runs seed 0's meta-step, then seed
1's, and so on, each with ``step_generator(seeds[i], t)``. Only one
seed's step transient is live at a time, and each meta-step reads the
fresh allocations its predecessor made, as in the sequential run, so row
i of the returned states, metrics and snapshots is bit for bit the
sequential ``train_surf(seed=seeds[i])`` run on the same device (the
reference promises fp32 tolerance).

The stacked state (every leaf with a leading n_seeds axis; the step the
lockstep int) is built only where the contract needs it: the returned
state (``stack_states``, leaf by leaf, dropping each seed's leaf as it
goes) and the ``ckpt_<step>/seeds`` payload (stacked on the host).
``state_for_seed`` returns a row's views.

``S_stack`` is (n_seeds, n, n) for static topologies or (n_seeds, T, n,
n) for per-seed schedule stacks (``stack_schedules``; each seed trains
under its own perturbation stream, as the sequential protocol does).
All seeds share one meta-training pool. Mixers: the default and any
S-as-argument (``takes_S``) mixer receive each seed's S.

MESH: on a 2-D ``('seed', 'agent')`` mesh (``launch.mesh.make_surf_mesh``)
lane i runs on the home device of its seed shard
(``surf_rules.seed_scan_shardings``), and a SEED-BATCHED halo mixer
(``topology.halo.make_seed_halo_mix``, built from this same stack) is
bound in each lane's meta-step, ``mix_fn.lane(i).at_step(t)`` =
``mix_fn.bind(i, t)``, so lane i exchanges boundary rows over the agent
devices of its seed row. The lanes still advance one after another, so
row i equals lane i's sequential run on the same mesh
(``train_scan(..., mix_fn=mix_fn.lane(i))``) bit for bit. The shared
snapshot pool is Q-sharded over 'agent'; ``q_sharded=True`` Q-shards
the training pool the same way (default or ``takes_S`` mixing only).
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint import io
from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.data.pipeline import stack_meta_datasets
from repro_torch.engine.core import _meta_step_core, init_state
from repro_torch.engine.scan import (_check_cadences, _decimate_history,
                                     _Hooks, _run)
from repro_torch.launch.mesh import mesh_device
from repro_torch.sharding import surf_rules as R
from repro_torch.topology.halo import _digest, _np32
from repro_torch.utils.device import resolve_device, to_tensor


def stack_states(states, device=None):
    """One stacked state from the list of per-seed ``TrainState``s, built
    leaf by leaf (on ``device``, default the first seed's). The list is
    emptied and each seed's leaf released once its stack exists, so the
    stack never sits beside a second full copy (provided nothing else
    holds the seeds' tensors)."""
    flat = [[x for _, x in io.flatten(s)] for s in states]
    like = io.unflatten(states[0], iter([0] * len(flat[0])))
    states.clear()
    out = []
    for j in range(len(flat[0])):
        col = [f[j] for f in flat]
        for f in flat:
            f[j] = None
        if isinstance(col[0], torch.Tensor):
            dev = col[0].device if device is None else device
            out.append(torch.stack([x.to(dev) for x in col]))
        else:
            out.append(col[0])
        del col
    return io.unflatten(like, iter(out))


def _host_stack(states):
    """The per-seed ``states`` stacked on the host (the checkpoint
    payload); the seeds' own tensors stay where they are."""
    cols = zip(*([x for _, x in io.flatten(s)] for s in states))
    return io.unflatten(states[0], iter(
        torch.stack([x.cpu() for x in col])
        if isinstance(col[0], torch.Tensor) else col[0] for col in cols))


def _unstack(states, n_seeds, device):
    """Fresh per-seed copies of the rows of a stacked state (a meta-step
    then reads what the sequential run would), on ``device``, or row i
    on ``device[i]`` for a list (the lanes of a mesh)."""
    if int(states.lam.shape[0]) != n_seeds:
        raise ValueError(f"states stack {states.lam.shape[0]} seeds but "
                         f"{n_seeds} seeds were given")
    devs = (list(device) if isinstance(device, (list, tuple))
            else [device] * n_seeds)
    leaves = [x for _, x in io.flatten(states)]
    return [io.unflatten(states, iter(
        x[i].to(devs[i], copy=True) if isinstance(x, torch.Tensor) else x
        for x in leaves)) for i in range(n_seeds)]


def state_for_seed(states, i):
    """Seed ``i``'s ``TrainState``: views into row ``i`` of the stacked
    ``states``."""
    return io.unflatten(states, iter(
        x[i] if isinstance(x, torch.Tensor) else x
        for _, x in io.flatten(states)))


def _seed_list(seeds):
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("seeds must be non-empty")
    return seeds


def init_states(cfg: SURFConfig, seeds, init="dgd", task=None, device=None):
    """The stacked initial ``TrainState`` of ``seeds``: row i is
    ``init_state(seeded_generator(seeds[i]))``, the sequential run's
    start."""
    device = resolve_device(device)
    return stack_states([init_state(U.seeded_generator(s, device), cfg,
                                    init=init, task=task)
                         for s in _seed_list(seeds)])


def stack_schedules(schedules, device=None):
    """(n_seeds, T, n, n) stack of per-seed ``TopologySchedule``s
    (all must share (T, n, n): one scenario, different seeds), on
    ``device`` (default: the first schedule's)."""
    shapes = {tuple(s.S.shape) for s in schedules}
    if len(shapes) != 1:
        raise ValueError(f"per-seed schedules must share one (T, n, n) "
                         f"shape, got {sorted(shapes)}")
    device = (schedules[0].S.device if device is None
              else resolve_device(device))
    return torch.stack([to_tensor(s.S, device, torch.float32)
                        for s in schedules])


def _check_seed_mix(S_stack, sched, n_seeds, mesh, mix_fn):
    """Validate a (per-seed S stack, mix_fn, mesh) triple. The default
    mixer and any S-as-argument (``takes_S``) mixer receive each seed's
    S_i; otherwise only a SEED-BATCHED mixer is legal (a static halo/ring
    mixer bakes ONE topology and would silently override the per-seed
    S_i stream), built from the SAME stack (kind, seed count, length,
    content digest), on a mesh with named ('seed', 'agent') axes."""
    if mix_fn is None or (getattr(mix_fn, "takes_S", False)
                          and not getattr(mix_fn, "seed_batched", False)):
        return
    if not getattr(mix_fn, "seed_batched", False):
        raise ValueError(
            "the seed-batched engine needs a SEED-BATCHED mixer "
            "(topology.halo.make_seed_halo_mix), an S-as-argument mixer "
            "(takes_S, such as kernels.graph_filter.make_plain_mix) or "
            "the default path — a static make_halo_mix/make_ring_mix "
            "bakes ONE topology and would silently override the per-seed "
            "S_i stream")
    if mesh is None or not {"seed", "agent"} <= set(mesh.axis_names):
        raise ValueError(
            "a seed-batched halo mixer needs mesh= with named "
            "('seed', 'agent') axes (launch.mesh.make_surf_mesh) — each "
            "lane exchanges over the agent devices of its seed row, got "
            f"mesh axes {None if mesh is None else mesh.axis_names}")
    if bool(mix_fn.scheduled) != sched:
        raise ValueError(
            f"seed-batched mixer was built from a "
            f"{'schedule' if mix_fn.scheduled else 'static'} stack but "
            f"the engine got a {'schedule' if sched else 'static'} "
            "S_stack — build the mixer from the SAME per-seed stack "
            "(topology.halo.make_seed_halo_mix)")
    if int(mix_fn.n_seeds) != n_seeds:
        raise ValueError(f"seed-batched mixer stacks {mix_fn.n_seeds} "
                         f"seeds but the engine got {n_seeds}")
    if sched and int(mix_fn.steps) != int(S_stack.shape[1]):
        raise ValueError(
            f"seed-batched mixer has {mix_fn.steps} schedule steps but "
            f"the S_stack has {int(S_stack.shape[1])} — build the mixer "
            "from the same schedule stack")
    src = getattr(mix_fn, "_src_ref", None)
    if src is not None and src() is S_stack:
        return                  # built from THIS object: digests match
    if mix_fn.stack_digest != _digest(_np32(S_stack)):
        raise ValueError(
            "seed-batched mixer was built from a DIFFERENT per-seed "
            "stack (content digest mismatch) — its coefficient blocks "
            "would silently override this run's S_i stream; rebuild it "
            "from this stack via topology.halo.make_seed_halo_mix")


def _check_seed_q_sharded(mesh, mix_fn, n_q):
    """The reference's q_sharded guards of the seed-batched engine;
    returns the select."""
    if mesh is None:
        raise ValueError(
            "q_sharded=True needs mesh (the Q-sharded placement and the "
            "select are built from the mesh's 'agent' axis and the pool's "
            "Q size)")
    if getattr(mix_fn, "seed_batched", False):
        raise ValueError(
            "q_sharded=True requires the default mixing path or an "
            "S-as-argument (takes_S) mixer: a seed-batched halo mixer "
            "splits the AGENT axis over the same 'agent' devices the Q "
            "axis would shard over — one axis, one role")
    seed_ax = R.axis_for_role(mesh, "seed")
    agent_ax = R.axis_for_role(mesh, "agent")
    if (agent_ax is None or agent_ax == seed_ax
            or R._axis_size(mesh, agent_ax) <= 1):
        raise ValueError(
            "q_sharded=True in the seed-batched engine needs a 2-D "
            "('seed', 'agent') mesh with agent size > 1 "
            "(launch.mesh.make_surf_mesh) — on a 1-D mesh the seed lanes "
            "own the single sharded axis and a Q-sharded pool would be "
            f"gathered across lanes every step; got mesh axes "
            f"{mesh.axis_names}")
    R.check_divides(n_q, R._axis_size(mesh, agent_ax),
                    "q_sharded train pool", "Q",
                    "the Q (meta-dataset pool) axis shards over the mesh's "
                    "'agent' axis")
    return R.make_q_select(mesh, R.q_select_axis(mesh, n_q, agent_ax))


def _check_stacks(S_stack, n_seeds, eval_every, S_eval_stack):
    """S_stack (n_seeds, n, n) or (n_seeds, T, n, n); the nominal
    snapshot matrices one (n, n) per seed."""
    if S_stack.dim() not in (3, 4):
        raise ValueError("S_stack must be (n_seeds, n, n) or "
                         f"(n_seeds, T, n, n), got shape "
                         f"{tuple(S_stack.shape)}")
    if int(S_stack.shape[0]) != n_seeds:
        raise ValueError(f"S_stack has {S_stack.shape[0]} seed rows but "
                         f"{n_seeds} seeds were given")
    if not eval_every:
        return None
    if S_eval_stack is None:
        if S_stack.dim() == 4:
            raise ValueError(
                "seed-batched snapshots under schedules need an explicit "
                "S_eval_stack (per-seed nominal matrices)")
        return S_stack
    if S_eval_stack.dim() != 3 or int(S_eval_stack.shape[0]) != n_seeds:
        raise ValueError(
            "S_eval_stack must stack one (n, n) nominal matrix PER SEED — "
            f"expected ({n_seeds}, n, n), got shape "
            f"{tuple(S_eval_stack.shape)}")
    return S_eval_stack


def train_scan_seeds(cfg: SURFConfig, S_stack, meta_datasets, steps, seeds,
                     constrained=True, activation="relu", log_every=0,
                     init="dgd", mix_fn=None, eval_every=0,
                     eval_datasets=None, S_eval_stack=None,
                     checkpoint_every=0, checkpoint_dir=None, task=None,
                     device=None, states=None, draws=None, deltas=None,
                     mesh=None, q_sharded=False):
    """Seed-batched Algorithm 1: every seed of ``seeds`` (its own init,
    draws and S_i) trains ``steps`` lockstep meta-steps on the shared
    pool. Returns (states, history) — or (states, history, snapshots)
    when ``eval_every`` > 0 — where history and snapshot entries carry
    (n_seeds,) / (n_seeds, ...) arrays; row i equals the sequential
    ``seed=seeds[i]`` run bit for bit.

    ``S_stack``: (n_seeds, n, n), or (n_seeds, T, n, n) per-seed schedule
    stacks (step t of seed i mixes with S_stack[i, t % T]). Snapshots
    evaluate seed i against ``S_eval_stack[i]`` (the per-seed nominal
    matrices; default a static ``S_stack``).
    ``checkpoint_every``/``checkpoint_dir`` write ONE
    ``ckpt_<step>/seeds`` payload holding every seed at that cadence
    (``engine.resume.resume_train_scan_seeds`` restores it).

    ``states`` continues a stacked state (``init_states`` or a restored
    one) instead of initialising; ``draws[i]`` and ``deltas[i]``
    (indexed by the absolute step) replace seed i's random draws.

    ``mesh``: lane i on its seed shard's home device (a named 'seed'
    axis must divide the seed count); ``mix_fn`` may then be a
    seed-batched halo mixer built from this ``S_stack``; ``q_sharded``
    Q-shards the training pool over the 'agent' axis of a 2-D mesh (see
    the module docstring). The returned states are gathered on the
    mesh's home device."""
    seeds = _seed_list(seeds)
    n_seeds = len(seeds)
    if mesh is None:
        device = resolve_device(device)
    else:
        device = mesh_device(mesh, device)
        if "seed" in mesh.axis_names:
            R.check_divides(
                n_seeds, int(mesh.shape["seed"]), "the seed-batched engine",
                "n_seeds", "every shard gets an equal block of seed lanes "
                "(a named 'seed' axis does NOT silently replicate); pass a "
                "matching seed batch or rebuild the mesh via "
                "launch.mesh.make_surf_mesh(seed_shards, agent_shards, "
                f"n_seeds={n_seeds})")
    task = resolve_task(cfg, task)
    _check_cadences(eval_every, eval_datasets, checkpoint_every,
                    checkpoint_dir)
    src_stack = S_stack
    S_stack = to_tensor(S_stack, device, torch.float32)
    sched = S_stack.dim() == 4
    S_eval_stack = _check_stacks(
        S_stack, n_seeds, eval_every,
        None if S_eval_stack is None
        else to_tensor(S_eval_stack, device, torch.float32))
    _check_seed_mix(src_stack, sched, n_seeds, mesh, mix_fn)
    pool = stack_meta_datasets(meta_datasets, task, device)
    n_q = int(next(iter(pool.values())).shape[0])
    select = (_check_seed_q_sharded(mesh, mix_fn, n_q) if q_sharded
              else None)
    if mesh is None:
        lanes, two_d = [device] * n_seeds, False
    else:
        places = R.seed_scan_shardings(mesh, n_seeds, q_sharded=q_sharded,
                                       n_q=n_q)
        lanes = [places["state"].device_of(i, n_seeds)
                 for i in range(n_seeds)]
        agent_ax = R.axis_for_role(mesh, "agent")
        two_d = (agent_ax != R.axis_for_role(mesh, "seed")
                 and R._axis_size(mesh, agent_ax) > 1)
        if select is not None:
            pool = R.ShardedPool(pool, places["pool"])
    if getattr(mix_fn, "seed_batched", False):
        steps_s = [_meta_step_core(cfg, constrained, activation,
                                   mix_fn.lane(i), task)[0]
                   for i in range(n_seeds)]
    else:
        shared, _ = _meta_step_core(cfg, constrained, activation, mix_fn,
                                    task)
        steps_s = [shared] * n_seeds
    if states is None:
        per = [init_state(U.seeded_generator(s, lanes[i]), cfg, init=init,
                          task=task) for i, s in enumerate(seeds)]
    else:
        per, states = _unstack(states, n_seeds, lanes), None
    start = per[0].step
    eval_pool = (stack_meta_datasets(eval_datasets, task, device)
                 if eval_every else None)
    hooks = [_Hooks(cfg, activation, mix_fn, task, lanes[i], s, eval_every,
                    eval_pool, S_eval_stack[i].to(lanes[i], copy=True)
                    if eval_every else None, 0, None,
                    mesh=mesh if two_d else None)
             for i, s in enumerate(seeds)]

    def lane_select(i):
        if select is not None:
            return lambda pool, t: select(pool, t, lanes[i])
        return lambda pool, t: {k: v[t % n_q].to(lanes[i])
                                for k, v in pool.items()}

    runs = [_run(steps_s[i], S_stack[i].to(lanes[i], copy=True), sched, pool,
                 per[i], s, steps, lanes[i],
                 None if draws is None else draws[i],
                 None if deltas is None else deltas[i], hooks[i],
                 lane_select(i))
            for i, s in enumerate(seeds)]
    save = (io.stacked_state_save_callback(str(checkpoint_dir))
            if checkpoint_every else None)
    rows = []
    for _ in range(int(steps)):
        ms = []
        for i, run in enumerate(runs):
            t, per[i], m = next(run)
            ms.append(m)
        rows.append({k: torch.stack([m[k].to(device) for m in ms])
                     for k in ms[0]})
        if save is not None and (t + 1) % checkpoint_every == 0:
            save(_host_stack(per))
    for run in runs:
        run.close()
    del runs
    metrics = ({k: torch.stack([r[k] for r in rows], -1).cpu()
                for k in rows[0]} if rows else {})
    hist = _decimate_history(metrics, len(rows), log_every, start)
    states = stack_states(per, device)
    if eval_every:
        return states, hist, [
            {**{k: torch.stack([h.rows[i][k].cpu() for h in hooks]).numpy()
                for k in row}, "step": start + i}
            for i, row in sorted(hooks[0].rows.items())]
    return states, hist
