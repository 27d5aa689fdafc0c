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
S-as-argument (``takes_S``) mixer receive each seed's S; the reference's
seed-batched halo mixer and its ('seed', 'agent') mesh are ROADMAP queue
1 item 8.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint import io
from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.data.pipeline import stack_meta_datasets
from repro_torch.engine.core import _check_mix, _meta_step_core, init_state
from repro_torch.engine.scan import (_check_cadences, _decimate_history,
                                     _Hooks, _run)
from repro_torch.utils.device import resolve_device, to_tensor


def stack_states(states):
    """One stacked state from the list of per-seed ``TrainState``s, built
    leaf by leaf. The list is emptied and each seed's leaf released once
    its stack exists, so the stack never sits beside a second full copy
    (provided nothing else holds the seeds' tensors)."""
    flat = [[x for _, x in io.flatten(s)] for s in states]
    like = io.unflatten(states[0], iter([0] * len(flat[0])))
    states.clear()
    out = []
    for j in range(len(flat[0])):
        col = [f[j] for f in flat]
        for f in flat:
            f[j] = None
        out.append(torch.stack(col) if isinstance(col[0], torch.Tensor)
                   else col[0])
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
    """Fresh per-seed copies, on ``device``, of the rows of a stacked
    state (a meta-step then reads what the sequential run would)."""
    if int(states.lam.shape[0]) != n_seeds:
        raise ValueError(f"states stack {states.lam.shape[0]} seeds but "
                         f"{n_seeds} seeds were given")
    leaves = [x for _, x in io.flatten(states)]
    return [io.unflatten(states, iter(
        x[i].to(device, copy=True) if isinstance(x, torch.Tensor) else x
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


def _check_seed_mix(mix_fn):
    """The seed-batched engine hands each seed its own S_i: the default
    mixer and any S-as-argument (``takes_S``) mixer take it. A baked-S
    mixer would silently override the per-seed S_i stream, and the
    reference's seed-batched halo mixer (``topology.halo.
    make_seed_halo_mix``) is ROADMAP queue 1 item 8."""
    _check_mix(mix_fn)
    if mix_fn is not None and not getattr(mix_fn, "takes_S", False):
        raise ValueError(
            "the seed-batched engine needs the default mixer or an "
            "S-as-argument mixer (takes_S, such as kernels.graph_filter."
            "make_plain_mix): a static mix_fn bakes ONE topology and "
            "would silently override the per-seed S_i stream (the "
            "SEED-BATCHED halo mixer is ROADMAP queue 1 item 8)")


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
                     device=None, states=None, draws=None, deltas=None):
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
    (indexed by the absolute step) replace seed i's random draws."""
    seeds = _seed_list(seeds)
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    _check_seed_mix(mix_fn)
    _check_cadences(eval_every, eval_datasets, checkpoint_every,
                    checkpoint_dir)
    S_stack = to_tensor(S_stack, device, torch.float32)
    S_eval_stack = _check_stacks(
        S_stack, len(seeds), eval_every,
        None if S_eval_stack is None
        else to_tensor(S_eval_stack, device, torch.float32))
    meta_step_s, _ = _meta_step_core(cfg, constrained, activation, mix_fn,
                                     task)
    if states is None:
        per = [init_state(U.seeded_generator(s, device), cfg, init=init,
                          task=task) for s in seeds]
    else:
        per, states = _unstack(states, len(seeds), device), None
    start = per[0].step
    pool = stack_meta_datasets(meta_datasets, task, device)
    eval_pool = (stack_meta_datasets(eval_datasets, task, device)
                 if eval_every else None)
    hooks = [_Hooks(cfg, activation, mix_fn, task, device, s, eval_every,
                    eval_pool, S_eval_stack[i].clone() if eval_every
                    else None, 0, None) for i, s in enumerate(seeds)]
    runs = [_run(meta_step_s, S_stack[i].clone(), S_stack.dim() == 4, pool,
                 per[i], s, steps, device,
                 None if draws is None else draws[i],
                 None if deltas is None else deltas[i], hooks[i])
            for i, s in enumerate(seeds)]
    save = (io.stacked_state_save_callback(str(checkpoint_dir))
            if checkpoint_every else None)
    rows = []
    for _ in range(int(steps)):
        ms = []
        for i, run in enumerate(runs):
            t, per[i], m = next(run)
            ms.append(m)
        rows.append({k: torch.stack([m[k] for m in ms]) for k in ms[0]})
        if save is not None and (t + 1) % checkpoint_every == 0:
            save(_host_stack(per))
    for run in runs:
        run.close()
    del runs
    metrics = ({k: torch.stack([r[k] for r in rows], -1).cpu()
                for k in rows[0]} if rows else {})
    hist = _decimate_history(metrics, len(rows), log_every, start)
    states = stack_states(per)
    if eval_every:
        return states, hist, [
            {**{k: torch.stack([h.rows[i][k] for h in hooks]).cpu().numpy()
                for k in row}, "step": start + i}
            for i, row in sorted(hooks[0].rows.items())]
    return states, hist
