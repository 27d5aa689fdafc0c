"""Public SURF API of the port: build the FL problem, meta-train U-DGD
(``train_surf``, on the static graph or under a time-varying topology
scenario, one seed or a batch of seeds, with in-loop snapshots and
periodic checkpoints), evaluate a trained model, solve one new
federation, and the asynchronous-agent perturbation study (paper App.
D, ``evaluate_async``): the port of ``repro.core.surf``.

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
from repro_torch.engine.core import _check_mix, _layer_fn
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
    step); both run the same meta-step and draws, and seeds, snapshots and
    checkpoints take "scan", as in the reference. ``mix`` is one of
    ``unroll.MIXES``, all of which run the graph filter through the CUDA
    kernel on the card; it is exclusive with an explicit ``mix_fn``.

    The reference's ``mesh`` and ``q_sharded`` options and its ring and
    halo mixers are ROADMAP queue 1 item 8: passing one raises
    ``NotImplementedError``."""
    for name, value in (("mesh", mesh), ("q_sharded", q_sharded)):
        if not (value is None or value is False):
            raise NotImplementedError(
                f"train_surf({name}=...) is not ported yet: ROADMAP queue "
                "1 item 8")
    if mix not in U.MIXES:
        raise NotImplementedError(
            f"mix={mix!r} is not ported yet (the port has {U.MIXES}): ring "
            "and halo mixers land with ROADMAP queue 1 item 8")
    if engine not in ("scan", "python"):
        raise ValueError(f"engine must be 'scan' or 'python', got {engine!r}")
    if mix is not None and mix_fn is not None:
        raise ValueError("pass either mix= (a mixer name) or mix_fn= (an "
                         "explicit mixer), not both")
    if scenario is not None and schedule is not None:
        raise ValueError("pass either scenario= (a name) or schedule= "
                         "(an explicit TopologySchedule), not both")
    for name, on in (("eval_every (in-loop snapshots)", eval_every),
                     ("checkpoint_every (periodic checkpoints)",
                      checkpoint_every),
                     ("seed batching", seeds is not None)):
        if on and engine != "scan":
            raise ValueError(f"{name} requires engine='scan'")
    E.scan._check_cadences(eval_every, eval_datasets, checkpoint_every,
                           checkpoint_dir)
    kw = dict(constrained=constrained, activation=activation,
              log_every=log_every, init=init, mix_fn=mix_fn, task=task,
              eval_every=eval_every, eval_datasets=eval_datasets,
              checkpoint_every=checkpoint_every,
              checkpoint_dir=checkpoint_dir)
    if seeds is not None:
        if seed != 0:
            raise ValueError(
                "pass either seed= (one run) or seeds= (a seed-batched "
                "run), not both — the batch defines every per-seed "
                "init/topology/RNG stream")
        E.seeds._check_seed_mix(mix_fn)
        seed_list = E.seeds._seed_list(np.asarray(list(seeds)).reshape(-1))
        device = resolve_device(device)
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
        out = E.train_scan_seeds(
            cfg, S_train, meta_datasets, steps, seed_list, device=device,
            S_eval_stack=S_stack if eval_every else None, **kw)
        return (*out, S_stack)
    _, S = make_problem(cfg, seed, device=device)
    if schedule is None:
        schedule = make_scenario(cfg, scenario, steps, seed,
                                 device=S.device)
    S_train = schedule if schedule is not None else S
    driver = E.train_scan if engine == "scan" else E.train
    out = driver(cfg, S_train, meta_datasets, steps, seed=seed,
                 device=S.device, S_eval=S if eval_every else None, **kw)
    return (*out, S)


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
    E._check_static_s(S, "evaluate_surf")
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    depth = _resolve_depth(cfg, depth)
    seeds = _check_draws_and_seeds(datasets, draws, seeds)
    if seeds is not None:
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
    _check_mix(mix_fn)
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
    ``mesh`` (Q sharded over devices) is ROADMAP queue 1 item 8."""
    if mesh is not None:
        raise NotImplementedError("evaluate_async(mesh=...) is not ported "
                                  "yet: ROADMAP queue 1 item 8")
    E._check_static_s(S, "evaluate_async")
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    seeds = _check_draws_and_seeds(datasets, draws, seeds)
    if seeds is not None:
        rows = [evaluate_async(cfg, state, S, datasets, n_async, seed=s,
                               activation=activation, task=task,
                               mix_fn=mix_fn, device=device)
                for s in seeds]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    run_s = _async_evaluator(cfg, activation, mix_fn, task)
    masks = async_masks(cfg, len(datasets), n_async, seed=seed)
    S = to_tensor(S, device, torch.float32)
    theta = {k: to_tensor(v, device) for k, v in state.theta.items()}
    with torch.no_grad():
        outs = [run_s(S, theta, task.to_batch(ds, device),
                      U.async_generator(seed, q, device), masks[q],
                      None if draws is None else draws[q])
                for q, ds in enumerate(datasets)]
    losses = torch.stack([o[0] for o in outs]).mean(0).cpu().numpy()
    accs = torch.stack([o[1] for o in outs]).mean(0).cpu().numpy()
    return {"loss_per_layer": losses, "acc_per_layer": accs,
            "final_loss": losses[-1], "final_acc": accs[-1]}
