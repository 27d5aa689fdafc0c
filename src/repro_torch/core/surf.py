"""Public SURF API of the port: build the FL problem, meta-train U-DGD
(``train_surf``), evaluate a trained model, and solve one new federation
(the port of ``repro.core.surf``). The asynchronous-agent study lands
with a later slice.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise. On the card every mixer
runs the graph filter through the CUDA kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import engine as E
from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.topology.families import build_topology
from repro_torch.utils.cache import BoundedLRU
from repro_torch.utils.device import resolve_device, to_tensor

# Evaluation bodies, one per distinct computation (``engine._engine_cache_key``
# with the "eval" variant, or ``adaptive_variant(cfg, "eval")``): a sweep
# re-evaluating one config reuses its body, and the cache's ``misses``
# count the builds (``repro_torch.cache_stats()["surf-eval"]``). An
# untagged custom mix_fn is uncacheable and rebuilt per call.
_EVAL_CACHE = BoundedLRU(maxsize=64, name="surf-eval")

DEPTHS = ("fixed", "adaptive")


def _resolve_depth(cfg, depth):
    """Normalize the ``depth=`` opt-in of the solve paths: None means
    fixed L (the paper's forward); "adaptive" selects the early-exit
    solve configured by cfg.exit_threshold / min_layers / probe_size."""
    depth = "fixed" if depth is None else depth
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth!r}")
    if depth == "adaptive" and cfg.min_layers > cfg.n_layers:
        raise ValueError(
            f"min_layers={cfg.min_layers} exceeds n_layers={cfg.n_layers}")
    return depth


def _evaluator(cfg, activation, mix_fn, task, depth):
    """The (cached) evaluation body for ``depth``."""
    adaptive = depth == "adaptive"

    def build():
        core = E._adaptive_eval_core if adaptive else E._eval_core
        return core(cfg, activation, mix_fn=mix_fn, task=task)

    variant = E.adaptive_variant(cfg, "eval") if adaptive else "eval"
    key = E._engine_cache_key(cfg, variant, activation, mix_fn=mix_fn,
                              task=task)
    return build() if key is None else _EVAL_CACHE.get_or_build(key, build)


def make_problem(cfg: SURFConfig, seed=0, device=None):
    """Returns (adjacency, mixing matrix S as an f32 tensor on ``device``)."""
    A, S = build_topology(cfg.topology, cfg.n_agents, degree=cfg.degree,
                          p=cfg.er_p, seed=seed)
    return A, torch.as_tensor(S, dtype=torch.float32,
                              device=resolve_device(device))


def train_surf(cfg: SURFConfig, meta_datasets, steps, seed=0,
               constrained=True, activation="relu", log_every=10,
               init="dgd", engine="scan", mix_fn=None, mix=None, mesh=None,
               scenario=None, schedule=None, seeds=None, eval_every=0,
               eval_datasets=None, checkpoint_every=0, checkpoint_dir=None,
               task=None, q_sharded=False, device=None):
    """Meta-train U-DGD on the config's topology (graph seed ``seed``):
    ``steps`` meta-steps of Algorithm 1 over the ``meta_datasets`` pool.
    Returns (state, history, S); the history holds every
    ``log_every``-th step's metrics and the last.

    ``engine`` is "scan" (``engine.scan.train_scan``, no host sync in the
    loop) or "python" (``engine.scan.train``, a host copy at each logged
    step); both run the same meta-step and draws. ``mix`` is one of
    ``unroll.MIXES``, all of which run the graph filter through the CUDA
    kernel on the card; it is exclusive with an explicit ``mix_fn``. Ring and
    halo mixers (ROADMAP queue 1 item 8) are not ported yet.

    The reference's ``mesh``, ``q_sharded``, ``scenario``, ``schedule``,
    ``seeds``, ``eval_every``, ``eval_datasets`` and ``checkpoint_*``
    options are not ported yet: passing one raises
    ``NotImplementedError`` naming its ROADMAP item."""
    for name, value, item in (
            ("mesh", mesh, 8), ("q_sharded", q_sharded, 8),
            ("scenario", scenario, 6), ("schedule", schedule, 6),
            ("seeds", seeds, 7), ("eval_every", eval_every, 7),
            ("eval_datasets", eval_datasets, 7),
            ("checkpoint_every", checkpoint_every, 7),
            ("checkpoint_dir", checkpoint_dir, 7)):
        if not (value is None or value is False
                or (isinstance(value, int) and value == 0)):
            raise NotImplementedError(
                f"train_surf({name}=...) is not ported yet: ROADMAP queue "
                f"1 item {item}")
    if mix not in U.MIXES:
        raise NotImplementedError(
            f"mix={mix!r} is not ported yet (the port has {U.MIXES}): ring "
            "and halo mixers land with ROADMAP queue 1 item 8")
    if engine not in ("scan", "python"):
        raise ValueError(f"engine must be 'scan' or 'python', got {engine!r}")
    if mix is not None and mix_fn is not None:
        raise ValueError("pass either mix= (a mixer name) or mix_fn= (an "
                         "explicit mixer), not both")
    _, S = make_problem(cfg, seed, device=device)
    driver = E.train_scan if engine == "scan" else E.train
    state, hist = driver(cfg, S, meta_datasets, steps, seed=seed,
                         constrained=constrained, activation=activation,
                         log_every=log_every, init=init, mix_fn=mix_fn,
                         task=task, device=S.device)
    return state, hist, S


def evaluate_surf(cfg: SURFConfig, state, S, datasets, seed=0,
                  activation="relu", seeds=None, mix_fn=None, task=None,
                  device=None, draws=None, depth=None):
    """Per-layer loss/metric trajectories averaged over the downstream
    ``datasets``. Dataset q draws from ``unroll.solve_generator(seed, q)``
    unless ``draws`` (one ``(W0, Xl, Yl)`` per dataset) replaces them.
    Returns numpy arrays: ``loss_per_layer`` / ``acc_per_layer`` (L,),
    ``final_loss`` / ``final_acc``.

    ``seeds``: a batch of evaluation seeds; every returned metric then
    gains a leading (n_seeds,) axis, row i equal to the
    ``seed=seeds[i]`` call (the reference's ``_eval_keys`` fold).

    ``depth="adaptive"`` solves with the convergence-adaptive early-exit
    unroll (``core.unroll.udgd_forward_adaptive``): layers stop once the
    probe-batch grad-norm ratio plateaus at 1 − ``cfg.exit_threshold``
    (≥ ``cfg.min_layers`` layers). The draws are those of the fixed path,
    so ``exit_threshold=0`` reproduces the fixed final row exactly. The
    return drops the per-layer stacks and carries ``final_loss`` /
    ``final_acc`` and ``depth``, the realized layer count averaged over
    the datasets."""
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    depth = _resolve_depth(cfg, depth)
    if draws is not None and len(draws) != len(datasets):
        raise ValueError(f"{len(draws)} draws for {len(datasets)} datasets")
    if seeds is not None:
        seeds = [int(s) for s in np.asarray(list(seeds)).reshape(-1)]
        if not seeds:
            raise ValueError("seeds must be non-empty")
        if draws is not None:
            raise ValueError("draws replace one seed's draws; pass seed=, "
                             "not seeds=")
        rows = [evaluate_surf(cfg, state, S, datasets, seed=s,
                              activation=activation, mix_fn=mix_fn,
                              task=task, device=device, depth=depth)
                for s in seeds]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    evaluate_s = _evaluator(cfg, activation, mix_fn, task, depth)
    S = to_tensor(S, device, torch.float32)
    theta = {k: to_tensor(v, device) for k, v in state.theta.items()}
    with torch.no_grad():
        outs = [evaluate_s(S, theta, task.to_batch(ds, device),
                           U.solve_generator(seed, q, device),
                           None if draws is None else draws[q])
                for q, ds in enumerate(datasets)]
    return {k: torch.stack([o[k] for o in outs]).mean(0).cpu().numpy()
            for k in outs[0]}


def solve_federation(cfg: SURFConfig, state, S, dataset, seed=0,
                     activation="relu", mix_fn=None, task=None, device=None,
                     draws=None, depth=None):
    """Solve ONE new federation with the trained model: the amortization
    primitive (paper §4) as a single call, and the reference the serving
    layer is held against. ``FederationServer.submit(S, dataset,
    seed=seed)`` draws from the same ``solve_generator(seed, 0)``.
    ``cfg.n_agents`` must match the cohort. ``draws=(W0, Xl, Yl)``
    replaces the random draws. ``depth="adaptive"`` solves with the
    early-exit unroll and adds the realized ``depth``: the reference of
    the adaptive serve path."""
    return evaluate_surf(cfg, state, S, [dataset], seed=seed,
                         activation=activation, mix_fn=mix_fn, task=task,
                         device=device,
                         draws=None if draws is None else [draws],
                         depth=depth)
