"""Shared core of the SURF engine: the S-as-argument meta-step and
evaluation bodies (paper Algorithm 1 + Figure 3) and the ``TrainState``
they carry; the port of ``repro.engine.core``.

Each meta-step: take one downstream dataset D_q, draw W_0 ~ N(μ0, σ0²I)
and L per-layer mini-batches from D_q's training examples, run the
unrolled network, evaluate the test loss f(W_L) on D_q's held-out
examples, add the λ-weighted descending-constraint slacks, take an Adam
step on θ (eq. 6, gradients clipped to a global norm of 10) and a
projected ascent step on λ (eq. 7).

S stays out of the closures (``meta_step_s(S, state, batch, ...)``,
``evaluate_s(S, theta, batch, ...)``), as in the reference. PyTorch runs
eagerly, so nothing is compiled: the drivers in ``engine.scan`` call the
bodies in a Python loop. The evaluation and serve bodies are still built
once per distinct computation and cached (``core.surf``'s evaluator
cache, the server's bucket cache) under keys from ``_engine_cache_key``,
whose cache misses count the builds (the reference's ``TRACE_COUNTS``).
With S an argument, a time-varying schedule needs nothing here: the
drivers hand each meta-step its S_t. The builders that bind one S
(``make_meta_step``, ``make_eval``, and the evaluators of ``core.surf``)
refuse a ``TopologySchedule`` (``_check_static_s``).

Random draws come from an explicit ``torch.Generator``
(``core.unroll.step_generator`` per meta-step); ``draws=(W0, Xl, Yl)``
replaces them, so the tests can replay the reference's draws. The RSDUN
perturbations of a robust config (``cfg.robust_sigma > 0``) come from a
generator of their own (``core.unroll.robust_generator``, apart from
the step stream, so W0 and the mini-batches are those of the nominal
run), or ``deltas=`` replaces them.

On the card every layer's graph filter runs through the CUDA kernel
(the default ``mix_fn=None``): L forward launches and, since W_0
carries no gradient, L−1 backward (dW) launches per meta-step.

``mix_fn`` replaces the dense filter with a halo exchange over a mesh's
agent axis (``core.ring.make_ring_mix`` / ``topology.halo``). A
SCHEDULED mixer (``make_scheduled_halo_mix``, ``.scheduled = True``) is
bound per meta-step by the CARRIED step, ``mix_fn.at_step(state.step)``,
so a resumed run continues its mixing stream. A SEED-BATCHED mixer
(``make_seed_halo_mix``, ``.seed_batched = True``) is bound lane by
lane by ``engine.seeds`` (``mix_fn.lane(i)``); the single-seed builders
refuse it (``_reject_seed_batched_mix``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import constraints as C
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.optim import adam, apply_updates, clip_by_global_norm
from repro_torch.sharding.surf_rules import mesh_fingerprint
from repro_torch.topology.schedule import TopologySchedule

# Global-norm clip of the meta-gradient (the reference's constant).
CLIP_NORM = 10.0


class TrainState(NamedTuple):
    """θ, the dual variables λ (L,), Adam's state ``{m, v, t}`` and the
    meta-step count. Evaluation and serving read θ only, so
    ``TrainState(theta)`` is a valid state for them."""
    theta: dict
    lam: Optional[torch.Tensor] = None
    opt_state: Optional[dict] = None
    step: int = 0


def init_state(generator, cfg: SURFConfig, init="dgd", task=None):
    """A fresh state: θ from ``init_udgd(generator, ...)`` on the
    generator's device, λ = 0, Adam's zero moments, step 0."""
    theta = U.init_udgd(generator, cfg, init=init, task=task)
    return TrainState(theta=theta,
                      lam=torch.zeros((cfg.n_layers,),
                                      device=generator.device),
                      opt_state=adam(cfg.lr_theta).init(theta), step=0)


def _reject_seed_batched_mix(mix_fn, where):
    """Single-seed builders cannot bind a seed-batched mixer (its per-seed
    blocks are bound lane by lane by ``engine.seeds``): point the caller
    at the seed-batched engine instead."""
    if getattr(mix_fn, "seed_batched", False):
        raise ValueError(
            f"{where} is a single-seed builder but got a SEED-BATCHED "
            "mixer (topology.halo.make_seed_halo_mix) — its per-seed "
            "blocks are bound lane by lane in engine.seeds; pass it to "
            "train_surf(seeds=...)/train_scan_seeds, or build a static "
            "make_halo_mix / make_ring_mix here (or seed_mix.lane(i))")


def _check_static_mix(mix_fn, where):
    """The evaluation bodies bind one filter for every layer: a scheduled
    or seed-batched mixer has no step counter / seed lane there."""
    _reject_seed_batched_mix(mix_fn, where)
    if getattr(mix_fn, "scheduled", False):
        raise ValueError(
            f"{where} has no step counter to bind a scheduled mix_fn — "
            "pass a statically bound filter (or mix_fn.at_step(t)), or "
            "use the meta step, which binds the carried state.step")


def _check_static_s(S, where):
    """The static-S builders cannot consume a time-varying schedule:
    point the caller at the schedule-aware drivers instead."""
    if isinstance(S, TopologySchedule):
        raise TypeError(
            f"{where} needs a static (n, n) mixing matrix, got a "
            "TopologySchedule — pass a schedule to train_scan/train "
            "(and evaluate on a static S, e.g. schedule.S[t])")


def _layer_fn(cfg):
    return U.udgd_layer_star if cfg.topology == "star" else U.udgd_layer


def _meta_step_core(cfg: SURFConfig, constrained=True, activation="relu",
                    mix_fn=None, task=None):
    """S-as-argument meta step: ``meta_step_s(S, state, batch,
    generator=None, draws=None, delta_generator=None, deltas=None)`` and
    ``forward_s(S, theta, W0, Xl, Yl)``. ``batch``: dict with Xtr
    (n,m,F), Ytr (n,m), Xte (n,t,F), Yte (n,t) tensors. ``task`` is the
    inner problem (None resolves the config's task).

    A robust config (``C.robust_enabled(cfg)``, also set as
    ``meta_step_s.robust``) needs the perturbations: drawn from
    ``delta_generator`` (the drivers pass ``unroll.robust_generator(seed,
    t)``) or given as ``deltas`` (robust_samples, L+1, n, d). A nominal
    config reads neither."""
    task = resolve_task(cfg, task)
    _reject_seed_batched_mix(mix_fn, "the single-seed meta-step")
    scheduled = bool(getattr(mix_fn, "scheduled", False))
    robust = C.robust_enabled(cfg)
    opt = adam(cfg.lr_theta)
    layer_fn = _layer_fn(cfg)

    def _forward(S, theta, W0, Xl, Yl, mf):
        Ws = [W0]
        for l, p_l in enumerate(U.unbind_layers(theta)):
            Ws.append(layer_fn(p_l, S, Ws[-1], Xl[l], Yl[l], cfg,
                               activation, mix_fn=mf, task=task))
        return Ws[-1], torch.stack(Ws)

    def forward_s(S, theta, W0, Xl, Yl):
        _check_static_mix(mix_fn, "forward_s")
        return _forward(S, theta, W0, Xl, Yl, mix_fn)

    def lagrangian_fn(theta, lam, S, W0, Xl, Yl, Xte, Yte, deltas, mf):
        W_L, W_all = _forward(S, theta, W0, Xl, Yl, mf)
        test_loss = task.fl_loss(W_L, Xte, Yte)
        gnorms = C.layer_grad_norms(W_all, Xl, Yl, cfg, task=task)
        if robust:
            g_rob = C.robust_layer_grad_norms(W_all, Xl, Yl, cfg, deltas,
                                              task=task, nominal=gnorms)
            slack = C.robust_slacks(g_rob, gnorms, cfg.eps)
        else:
            slack = C.slacks(gnorms, cfg.eps)
        lag = C.lagrangian(test_loss, slack, lam) if constrained else test_loss
        return lag, (test_loss, slack, gnorms, W_L)

    def meta_step_s(S, state: TrainState, batch, generator=None,
                    draws=None, delta_generator=None, deltas=None):
        W0, Xl, Yl = U.featurize_cohort(generator, batch, cfg, task=task,
                                        draws=draws)
        if robust:
            deltas = U.sample_deltas(delta_generator, cfg, task=task,
                                     deltas=deltas, device=W0.device)
        theta = {k: v.detach().requires_grad_(True)
                 for k, v in state.theta.items()}
        with torch.enable_grad():
            lag, (tl, slack, gnorms, W_L) = lagrangian_fn(
                theta, state.lam, S, W0, Xl, Yl, batch["Xte"], batch["Yte"],
                deltas,
                mix_fn.at_step(state.step) if scheduled else mix_fn)
            grads = torch.autograd.grad(lag, list(theta.values()))
        with torch.no_grad():
            grads, gn = clip_by_global_norm(dict(zip(theta, grads)),
                                            CLIP_NORM)
            upd, opt_state = opt.update(grads, state.opt_state)
            new_theta = apply_updates(
                {k: v.detach() for k, v in theta.items()}, upd)
            slack = slack.detach()
            lam = (C.dual_ascent(state.lam, slack, cfg.lr_lambda)
                   if constrained else state.lam)
            test_acc = task.fl_metric(W_L.detach(), batch["Xte"],
                                      batch["Yte"])
            metrics = {"lagrangian": lag.detach(), "test_loss": tl.detach(),
                       "test_acc": test_acc, "slack_max": slack.max(),
                       "slack_mean": slack.mean(),
                       "gnorm_first": gnorms[0].detach(),
                       "gnorm_last": gnorms[-1].detach(),
                       "grad_norm": gn, "lam_sum": lam.sum()}
        return TrainState(new_theta, lam, opt_state, state.step + 1), metrics

    meta_step_s.robust = robust
    return meta_step_s, forward_s


def make_meta_step(cfg: SURFConfig, S, *, constrained=True,
                   activation="relu", mix_fn=None, task=None):
    """The meta-training step ``meta_step(state, batch, generator=None,
    draws=None, delta_generator=None, deltas=None) -> (state, metrics)``
    and ``forward(theta, W0, Xl, Yl)`` with S bound. ``constrained=False``
    is the ablation of Appendix D (λ frozen at 0); ``cfg.topology ==
    "star"`` selects the star layers; ``mix_fn`` overrides the default
    mixer (see ``core.unroll._mix``); a robust config takes its
    perturbations as ``_meta_step_core`` says."""
    _check_static_s(S, "make_meta_step")
    _reject_seed_batched_mix(mix_fn, "make_meta_step")
    meta_step_s, forward_s = _meta_step_core(cfg, constrained, activation,
                                             mix_fn, task)

    def meta_step(state, batch, generator=None, draws=None,
                  delta_generator=None, deltas=None):
        return meta_step_s(S, state, batch, generator, draws,
                           delta_generator, deltas)

    def forward(theta, W0, Xl, Yl):
        return forward_s(S, theta, W0, Xl, Yl)

    return meta_step, forward


def _eval_core(cfg: SURFConfig, activation="relu", mix_fn=None, task=None):
    """Evaluation body ``evaluate_s(S, theta, batch, generator,
    draws=None)``: featurize the cohort, run the L layers and report the
    test loss and ``task.fl_metric`` after every layer."""
    task = resolve_task(cfg, task)
    _check_static_mix(mix_fn, "the evaluation body")
    layer_fn = _layer_fn(cfg)

    def evaluate_s(S, theta, batch, generator, draws=None):
        W, Xl, Yl = U.featurize_cohort(generator, batch, cfg, task=task,
                                       draws=draws)
        losses, accs = [], []
        for l in range(cfg.n_layers):
            W = layer_fn(U.layer_params(theta, l), S, W, Xl[l], Yl[l], cfg,
                         activation, mix_fn=mix_fn, task=task)
            losses.append(task.fl_loss(W, batch["Xte"], batch["Yte"]))
            accs.append(task.fl_metric(W, batch["Xte"], batch["Yte"]))
        losses, accs = torch.stack(losses), torch.stack(accs)
        return {"loss_per_layer": losses, "acc_per_layer": accs,
                "final_loss": losses[-1], "final_acc": accs[-1]}

    return evaluate_s


def _adaptive_eval_core(cfg: SURFConfig, activation="relu", mix_fn=None,
                        task=None):
    """ADAPTIVE-depth evaluation body, same contract as ``_eval_core``,
    but the unroll stops early (``core.unroll.udgd_forward_adaptive``)
    once the probe-batch grad-norm ratio plateaus at 1 −
    ``cfg.exit_threshold``. No per-layer metric stacks; returns the final
    loss and metric and the realized ``depth`` (a float tensor). With
    ``cfg.exit_threshold == 0`` all L layers run and the result equals
    ``_eval_core``'s final row (same draws, same layer calls)."""
    task = resolve_task(cfg, task)
    _check_static_mix(mix_fn, "the evaluation body")
    layer_fn = _layer_fn(cfg)

    def evaluate_s(S, theta, batch, generator, draws=None):
        W0, Xl, Yl = U.featurize_cohort(generator, batch, cfg, task=task,
                                        draws=draws)
        Xp, Yp = U.probe_batch(batch, cfg)
        W_L, depth = U.udgd_forward_adaptive(
            theta, S, W0, Xl, Yl, Xp, Yp, cfg, activation, mix_fn=mix_fn,
            task=task, layer_fn=layer_fn)
        return {"final_loss": task.fl_loss(W_L, batch["Xte"], batch["Yte"]),
                "final_acc": task.fl_metric(W_L, batch["Xte"],
                                            batch["Yte"]),
                "depth": torch.tensor(float(depth), device=W_L.device)}

    return evaluate_s


def adaptive_variant(cfg: SURFConfig, base):
    """Cache-key variant tag of an adaptive-depth computation:
    ``_engine_cache_key`` scrubs the exit fields from cfg (fixed-depth
    bodies ignore them), so every adaptive builder carries them here —
    two thresholds build two bodies."""
    return (base + "-adaptive", float(cfg.exit_threshold),
            int(cfg.min_layers), int(cfg.probe_size))


def _engine_cache_key(cfg: SURFConfig, variant, activation, mix_fn=None,
                      task=None, mesh=None):
    """Key of a built body: cfg normalized to the fields that shape the
    computation, the ``variant`` tag, the activation, the mixer's tag,
    the task's tag and the mesh's fingerprint (a body placed on a mesh is
    another computation than the unsharded one). Off the star path the
    topology fields only say how S was built (S is an argument), so they
    are scrubbed; so are the
    adaptive-depth exit fields, which only the early-exit bodies read and
    carry in their variant (``adaptive_variant``): fixed-depth bodies are
    shared across exit-threshold sweeps. None for an untagged custom
    ``mix_fn`` (uncacheable: the closure could compute anything)."""
    if mix_fn is not None and getattr(mix_fn, "tag", None) is None:
        return None
    task = resolve_task(cfg, task)
    if cfg.topology != "star":
        cfg = dataclasses.replace(cfg, topology="regular", degree=0,
                                  er_p=0.0)
    cfg = dataclasses.replace(cfg, exit_threshold=0.0, min_layers=1,
                              probe_size=0)
    return (cfg, variant, activation,
            None if mix_fn is None else mix_fn.tag, task.cache_tag,
            mesh_fingerprint(mesh))


def make_eval(cfg: SURFConfig, S, *, activation="relu", mix_fn=None,
              task=None):
    """Per-layer loss/metric trajectory on one downstream dataset with S
    bound: ``evaluate(theta, batch, generator, draws=None)``."""
    _check_static_s(S, "make_eval")
    evaluate_s = _eval_core(cfg, activation, mix_fn, task)

    def evaluate(theta, batch, generator, draws=None):
        return evaluate_s(S, theta, batch, generator, draws)

    return evaluate
