"""Public SURF API of the port: build the FL problem, meta-train U-DGD
(``train_surf``, on the static graph or under a time-varying topology
scenario, one seed or a batch of seeds, with in-loop snapshots and
periodic checkpoints), evaluate a trained model, solve one new
federation, and the asynchronous-agent perturbation study (paper App.
D, ``evaluate_async``): the port of ``repro.core.surf``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise. On the card every mixer
runs the graph filter through the CUDA kernel.

``mesh=`` (a ``launch.mesh.Mesh``) runs an entry point on the mesh's
devices: the run lives on the mesh's home device, the ``mix`` names
"ring", "halo" and "halo-pallas" build a halo exchange over its agent
axis (``_resolve_mix``), seed lanes go to their seed shard, and the
dataset pools are Q-sharded over the agent-role axis (evaluation one
dataset per owning device; ``q_sharded=True`` for the training pool).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import engine as E
from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import _check_static_mix, _layer_fn
from repro_torch.launch.mesh import mesh_device
from repro_torch.sharding import surf_rules as R
from repro_torch.topology import schedule as SCH
from repro_torch.topology.families import build_topology
from repro_torch.utils.cache import BoundedLRU
from repro_torch.utils.device import resolve_device, to_tensor

# Evaluation bodies, one per distinct computation (``engine._engine_cache_key``
# with the "eval" variant, or ``adaptive_variant(cfg, "eval")``): a sweep
# re-evaluating one config reuses its body, and the cache's ``misses``
# count the builds (``repro_torch.cache_stats()["surf-eval"]``). An
# untagged custom mix_fn is uncacheable and rebuilt per call.
_EVAL_CACHE = BoundedLRU(maxsize=64, name="surf-eval")
# The async study's bodies (``_async_core``), keyed the same way with the
# "async" variant (``cache_stats()["surf-async"]``).
_ASYNC_CACHE = BoundedLRU(maxsize=32, name="surf-async")

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


SCENARIOS = ("static", "link-failure", "dropout", "markov", "anneal")


def make_scenario(cfg: SURFConfig, scenario, steps, seed=0, *,
                  p_fail=0.2, n_drop=None, p_drop=0.05, p_recover=0.5,
                  device=None):
    """Named training scenario -> ``TopologySchedule`` over the config's
    base graph (graph seed ``seed``), on ``device``; None for "static" or
    None (train on the static S).

      * "link-failure": each link down i.i.d. w.p. ``p_fail`` per step,
      * "dropout": ``n_drop`` agents (default n/10) drop out per step,
      * "markov": bursty link outages (``p_drop``/``p_recover`` chain),
      * "anneal": ring→random Watts–Strogatz rewiring curriculum.

    The schedule has ``steps`` matrices (one per meta-step; the drivers
    cycle mod T if trained longer). Bit-equal to the reference's."""
    if scenario in (None, "static"):
        return None
    A, _ = build_topology(cfg.topology, cfg.n_agents, degree=cfg.degree,
                          p=cfg.er_p, seed=seed)
    if scenario == "link-failure":
        return SCH.link_failure_schedule(A, steps, p_fail=p_fail, seed=seed,
                                         device=device)
    if scenario == "dropout":
        nd = n_drop if n_drop is not None else max(1, cfg.n_agents // 10)
        return SCH.dropout_schedule(A, steps, n_drop=nd, seed=seed,
                                    device=device)
    if scenario == "markov":
        return SCH.markov_link_schedule(A, steps, p_drop=p_drop,
                                        p_recover=p_recover, seed=seed,
                                        device=device)
    if scenario == "anneal":
        return SCH.ring_to_random_anneal(cfg.n_agents, steps,
                                         k=max(2, 2 * (cfg.degree // 2)),
                                         seed=seed, device=device)
    raise ValueError(f"unknown scenario {scenario!r}; one of {SCENARIOS}")


MIXES = U.MIXES


def _resolve_mix(mix, mesh, cfg, *, S=None, schedule=None, S_stack=None):
    """Build the ``mix_fn`` a ``mix=`` name stands for against the run's
    topology and the mesh's AGENT-role axis — exactly one of ``S``
    (single-seed static), ``schedule`` (single-seed time-varying) or
    ``S_stack`` (seed-batched, (n_seeds, n, n) or (n_seeds, T, n, n))
    describes the run.

    The dense names (``unroll.DENSE_MIXES``) select the default mixer:
    S stays an argument, so they need no mesh and compose with schedules
    and seed batches. "halo" is the block-sparse exchange (the scheduled
    mixer for a schedule, the seed-batched one for a seed batch);
    "halo-pallas" the same with each shard's on-shard block through the
    graph-filter kernel; "ring" the circulant case, for a static ring
    only."""
    if mix in U.DENSE_MIXES:
        return None
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    if mesh is None:
        raise ValueError(
            f"mix={mix!r} needs mesh= (the mesh whose agent axis the halo "
            "exchange runs over — launch.mesh.make_surf_mesh); for the "
            "meshless kernel path use mix='cuda'")
    from repro_torch.topology import halo
    axis = R.axis_for_role(mesh, "agent")
    if mix == "ring":
        if cfg.topology != "ring":
            raise ValueError("mix='ring' needs cfg.topology='ring' (the "
                             "circulant special case); use mix='halo' "
                             "for arbitrary topologies")
        if schedule is not None or S_stack is not None:
            raise ValueError("mix='ring' bakes one static circulant — "
                             "use mix='halo' for schedules or "
                             "seed-batched runs")
        from repro_torch.core.ring import make_ring_mix
        return make_ring_mix(mesh, axis, cfg.n_agents,
                             max(1, cfg.degree // 2))
    resident = "pallas" if mix == "halo-pallas" else "dense"
    if S_stack is not None:
        # the stack OBJECT itself: the mixer remembers it, so the engine's
        # content-digest guard short-circuits on identity
        return halo.make_seed_halo_mix(mesh, axis, S_stack,
                                       resident=resident)
    if schedule is not None:
        return halo.make_scheduled_halo_mix(mesh, axis, schedule,
                                            resident=resident)
    return halo.make_halo_mix(mesh, axis, S, resident=resident)


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

    ``scenario`` (a name from ``SCENARIOS``, see ``make_scenario``) or
    ``schedule`` (an explicit ``TopologySchedule``) trains under
    TIME-VARYING graphs: meta-step t mixes with the schedule's S[t % T].
    The returned S is still the nominal static mixing matrix, which
    evaluation uses (robustness protocols train on perturbed topologies
    and test on the nominal one). Passing both raises ``ValueError``.

    ``seeds``: a batch of TRAINING seeds, trained in lockstep
    (``engine.seeds``), each with its own init, draws and topology (and
    its own perturbation stream under a scenario); the returned
    state, history and S gain a leading (n_seeds,) axis, and row i equals
    the sequential ``seed=seeds[i]`` run bit for bit.

    ``eval_every``: evaluate θ on ``eval_datasets`` after every
    ``eval_every``-th meta-step against the NOMINAL static S
    (``engine.snapshots``); adds a ``snapshots`` list to the return:
    (state, hist, snapshots, S) / (states, hist, snapshots, S_stack).

    ``checkpoint_every``/``checkpoint_dir``: write the carried state at
    that cadence, ``ckpt_<step>`` payloads (``ckpt_<step>/seeds`` with
    ``seeds``) that ``engine.resume`` restores bit-exactly.

    ``engine`` is "scan" (``engine.scan.train_scan``, no host sync in the
    loop) or "python" (``engine.scan.train``, a host copy at each logged
    step); both run the same meta-step and draws, and seeds, snapshots,
    checkpoints and meshes take "scan", as in the reference. ``mix`` is
    one of ``MIXES`` (see ``_resolve_mix``), exclusive with an explicit
    ``mix_fn``.

    ``mesh``: a ``launch.mesh.Mesh``; the run lives on its home device.
    With ``mix="ring"|"halo"|"halo-pallas"`` every layer's filter
    exchanges boundary rows over its agent axis (with ``seeds``, on a
    2-D ('seed', 'agent') mesh, each lane over its seed row's).
    ``q_sharded=True`` shards the training pool's Q axis over the agent
    axis (default or kernel mixing only; with ``seeds`` the mesh must be
    2-D)."""
    if engine not in ("scan", "python"):
        raise ValueError(f"engine must be 'scan' or 'python', got {engine!r}")
    if mesh is not None and engine != "scan":
        raise ValueError("mesh placements require engine='scan' (the "
                         "step-wise python driver is unsharded)")
    if scenario is not None and schedule is not None:
        raise ValueError("pass either scenario= (a name) or schedule= "
                         "(an explicit TopologySchedule), not both")
    if mix is not None and mix_fn is not None:
        raise ValueError("pass either mix= (a mixer name) or mix_fn= (an "
                         "explicit mixer), not both")
    if mix is not None and mix not in MIXES:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    for name, on in (("eval_every (in-loop snapshots)", eval_every),
                     ("checkpoint_every (periodic checkpoints)",
                      checkpoint_every),
                     ("seed batching", seeds is not None)):
        if on and engine != "scan":
            raise ValueError(f"{name} requires engine='scan'")
    E.scan._check_cadences(eval_every, eval_datasets, checkpoint_every,
                           checkpoint_dir)
    device = (resolve_device(device) if mesh is None
              else mesh_device(mesh, device))
    kw = dict(constrained=constrained, activation=activation,
              log_every=log_every, init=init, task=task,
              eval_every=eval_every, eval_datasets=eval_datasets,
              checkpoint_every=checkpoint_every,
              checkpoint_dir=checkpoint_dir)
    if seeds is not None:
        if seed != 0:
            raise ValueError(
                "pass either seed= (one run) or seeds= (a seed-batched "
                "run), not both — the batch defines every per-seed "
                "init/topology/RNG stream")
        if (mix_fn is not None
                and not getattr(mix_fn, "seed_batched", False)
                and not getattr(mix_fn, "takes_S", False)):
            raise ValueError(
                "seed-batched training needs a SEED-BATCHED mixer "
                "(topology.halo.make_seed_halo_mix / mix='halo'), an "
                "S-as-argument mixer (kernels.graph_filter.make_plain_mix) "
                "or the default path — a static mix_fn bakes one topology "
                "and would silently override the per-seed S_i stream")
        seed_list = E.seeds._seed_list(np.asarray(list(seeds)).reshape(-1))
        S_stack = torch.stack([make_problem(cfg, s, device=device)[1]
                               for s in seed_list])
        if schedule is not None:
            S_sched = to_tensor(schedule.S, device, torch.float32)
            S_train = S_sched.expand(len(seed_list), *S_sched.shape)
        elif scenario not in (None, "static"):
            S_train = E.stack_schedules(
                [make_scenario(cfg, scenario, steps, s, device=device)
                 for s in seed_list], device=device)
        else:
            S_train = S_stack
        if mix is not None:
            mix_fn = _resolve_mix(mix, mesh, cfg, S_stack=S_train)
        out = E.train_scan_seeds(
            cfg, S_train, meta_datasets, steps, seed_list, device=device,
            mix_fn=mix_fn, S_eval_stack=S_stack if eval_every else None,
            mesh=mesh, q_sharded=q_sharded, **kw)
        return (*out, S_stack)
    _, S = make_problem(cfg, seed, device=device)
    if schedule is None:
        schedule = make_scenario(cfg, scenario, steps, seed,
                                 device=S.device)
    S_train = schedule if schedule is not None else S
    if mix is not None:
        mix_fn = _resolve_mix(mix, mesh, cfg, S=S, schedule=schedule)
    if engine == "scan":
        out = E.train_scan(cfg, S_train, meta_datasets, steps, seed=seed,
                           device=S.device, mix_fn=mix_fn,
                           S_eval=S if eval_every else None, mesh=mesh,
                           q_sharded=q_sharded, **kw)
    elif q_sharded:
        raise ValueError("q_sharded=True requires engine='scan' (the "
                         "step-wise python driver is unsharded)")
    else:
        out = E.train(cfg, S_train, meta_datasets, steps, seed=seed,
                      device=S.device, mix_fn=mix_fn,
                      S_eval=S if eval_every else None, **kw)
    return (*out, S)


def _placed(n_q, mesh, device, **replicated):
    """Yield (q, device, values) for datasets 0..n_q−1: dataset q's device
    under the Q-sharded placement of ``mesh`` (``stacked_q_sharding``;
    ``device`` without a mesh or when Q does not divide) and the
    ``replicated`` values (S, θ) copied there once."""
    place = (R.stacked_q_sharding(mesh, n_q) if mesh is not None
             else R.Placement(None, None, (device,)))
    reps = R.Replicas(**replicated)
    for q in range(n_q):
        dev = place.device_of(q, n_q)
        yield q, dev, reps.on(dev)


def _check_draws_and_seeds(datasets, draws, seeds):
    """Validate ``draws`` (one per dataset) and normalize ``seeds`` to a
    non-empty list of ints (None stays None); draws replace ONE seed's
    draws, so they do not combine with ``seeds``."""
    if draws is not None and len(draws) != len(datasets):
        raise ValueError(f"{len(draws)} draws for {len(datasets)} datasets")
    if seeds is None:
        return None
    seeds = [int(s) for s in np.asarray(list(seeds)).reshape(-1)]
    if not seeds:
        raise ValueError("seeds must be non-empty")
    if draws is not None:
        raise ValueError("draws replace one seed's draws; pass seed=, "
                         "not seeds=")
    return seeds


def evaluate_surf(cfg: SURFConfig, state, S, datasets, seed=0,
                  activation="relu", seeds=None, mix_fn=None, mesh=None,
                  task=None, device=None, draws=None, depth=None):
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
    the datasets.

    ``mix_fn`` replaces the default filter (a static halo/ring exchange,
    or the plain ``make_plain_mix()``). ``mesh`` Q-shards the datasets
    over its agent-role axis (``surf_rules.stacked_q_sharding``): each
    is evaluated on the device that holds it, with S and θ copied there
    once, and the rows are gathered to the home device for the mean —
    data-parallel evaluation over downstream datasets."""
    E._check_static_s(S, "evaluate_surf")
    device = (resolve_device(device) if mesh is None
              else mesh_device(mesh, device))
    task = resolve_task(cfg, task)
    depth = _resolve_depth(cfg, depth)
    seeds = _check_draws_and_seeds(datasets, draws, seeds)
    if seeds is not None:
        rows = [evaluate_surf(cfg, state, S, datasets, seed=s,
                              activation=activation, mix_fn=mix_fn,
                              mesh=mesh, task=task, device=device,
                              depth=depth)
                for s in seeds]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    evaluate_s = _evaluator(cfg, activation, mix_fn, task, depth)
    outs = []
    with torch.no_grad():
        for q, dev, r in _placed(
                len(datasets), mesh, device,
                S=to_tensor(S, device, torch.float32),
                theta={k: to_tensor(v, device)
                       for k, v in state.theta.items()}):
            o = evaluate_s(r["S"], r["theta"],
                           task.to_batch(datasets[q], dev),
                           U.solve_generator(seed, q, dev),
                           None if draws is None else draws[q])
            outs.append({k: v.to(device) for k, v in o.items()})
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
    E._check_static_s(S, "solve_federation")
    return evaluate_surf(cfg, state, S, [dataset], seed=seed,
                         activation=activation, mix_fn=mix_fn, task=task,
                         device=device,
                         draws=None if draws is None else [draws],
                         depth=depth)


# ------------------------------------------------- asynchronous agents
def _async_core(cfg: SURFConfig, activation="relu", mix_fn=None, task=None):
    """S-as-argument async-inference body ``run_s(S, theta, batch,
    generator, async_mask, draws=None) -> (losses (L,), metrics (L,))``
    on one dataset (see ``make_async_run``)."""
    task = resolve_task(cfg, task)
    _check_static_mix(mix_fn, "the async body")
    layer_fn = _layer_fn(cfg)

    def run_s(S, theta, batch, generator, async_mask, draws=None):
        W0, Xl, Yl = U.featurize_cohort(generator, batch, cfg, task=task,
                                        draws=draws)
        stale = to_tensor(async_mask, W0.device, torch.bool)[:, None]
        W_prev = W = W0
        losses, accs = [], []
        for l in range(cfg.n_layers):
            # neighbours see the async agents' estimate of layer l − 2
            W_seen = torch.where(stale, W_prev, W)
            Wn = layer_fn(U.layer_params(theta, l), S, W_seen, Xl[l], Yl[l],
                          cfg, activation, mix_fn=mix_fn, task=task)
            # and the async agents skip their own update this layer
            Wn = torch.where(stale, W, Wn)
            losses.append(task.fl_loss(Wn, batch["Xte"], batch["Yte"]))
            accs.append(task.fl_metric(Wn, batch["Xte"], batch["Yte"]))
            W_prev, W = W, Wn
        return torch.stack(losses), torch.stack(accs)

    return run_s


def make_async_run(cfg: SURFConfig, S, activation="relu", task=None):
    """Single-dataset async-inference body (paper Fig. 8) with S bound:
    ``run(theta, batch, generator, async_mask, draws=None) -> (losses,
    metrics)``, each (L,). Agents flagged in ``async_mask`` (n,) fail to
    update in sync: at layer l their neighbours consume the estimate
    communicated at the previous layer (W_seen = where(mask, W_{l−2},
    W_{l−1}), W_{−1} = W_0), and they keep W_{l−1}. The batched path
    is ``evaluate_async``."""
    run_s = _async_core(cfg, activation, task=task)

    def run(theta, batch, generator, async_mask, draws=None):
        return run_s(S, theta, batch, generator, async_mask, draws)

    return run


def async_masks(cfg: SURFConfig, n_datasets, n_async, seed=0):
    """Per-dataset async-agent masks, (Q, n_agents) bool: each dataset gets
    its own uniformly drawn set of ``n_async`` stale agents (numpy,
    bit-equal to the reference's)."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((n_datasets, cfg.n_agents), bool)
    for q in range(n_datasets):
        masks[q, rng.choice(cfg.n_agents, n_async, replace=False)] = True
    return masks


def _async_evaluator(cfg, activation, mix_fn, task):
    """The (cached) async body for this computation."""
    key = E._engine_cache_key(cfg, "async", activation, mix_fn=mix_fn,
                              task=task)

    def build():
        return _async_core(cfg, activation, mix_fn, task)

    return build() if key is None else _ASYNC_CACHE.get_or_build(key, build)


def evaluate_async(cfg: SURFConfig, state, S, datasets, n_async, seed=0,
                   activation="relu", seeds=None, task=None, mesh=None,
                   mix_fn=None, device=None, draws=None):
    """Asynchronous communications (paper Fig. 8) over all downstream
    ``datasets``, each with its own mask from ``async_masks(cfg, Q,
    n_async, seed)``. Dataset q draws from ``unroll.async_generator(seed,
    q)`` unless ``draws`` (one ``(W0, Xl, Yl)`` per dataset) replaces
    them. Returns numpy ``loss_per_layer`` / ``acc_per_layer`` (L,) and
    ``final_loss`` / ``final_acc``, averaged over the datasets.

    ``seeds``: a batch of evaluation seeds; each seed draws its own
    masks and every returned metric gains a leading (n_seeds,) axis, row
    i equal to the ``seed=seeds[i]`` call. ``mix_fn`` overrides the
    default mixer (the plain reference is ``make_plain_mix()``).
    ``mesh`` Q-shards the datasets over its agent-role axis, exactly as
    ``evaluate_surf`` does (same masks and draws per dataset index)."""
    E._check_static_s(S, "evaluate_async")
    device = (resolve_device(device) if mesh is None
              else mesh_device(mesh, device))
    task = resolve_task(cfg, task)
    seeds = _check_draws_and_seeds(datasets, draws, seeds)
    if seeds is not None:
        rows = [evaluate_async(cfg, state, S, datasets, n_async, seed=s,
                               activation=activation, task=task,
                               mesh=mesh, mix_fn=mix_fn, device=device)
                for s in seeds]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    run_s = _async_evaluator(cfg, activation, mix_fn, task)
    masks = async_masks(cfg, len(datasets), n_async, seed=seed)
    outs = []
    with torch.no_grad():
        for q, dev, r in _placed(
                len(datasets), mesh, device,
                S=to_tensor(S, device, torch.float32),
                theta={k: to_tensor(v, device)
                       for k, v in state.theta.items()}):
            loss, acc = run_s(r["S"], r["theta"],
                              task.to_batch(datasets[q], dev),
                              U.async_generator(seed, q, dev), masks[q],
                              None if draws is None else draws[q])
            outs.append((loss.to(device), acc.to(device)))
    losses = torch.stack([o[0] for o in outs]).mean(0).cpu().numpy()
    accs = torch.stack([o[1] for o in outs]).mean(0).cpu().numpy()
    return {"loss_per_layer": losses, "acc_per_layer": accs,
            "final_loss": losses[-1], "final_acc": accs[-1]}
