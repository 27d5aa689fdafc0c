"""Request-batched amortized solver: the serving hot path (the port of
``repro.serve.solver``).

A REQUEST BATCH of cohorts, stacked to a common bucket shape
``(B, n_pad, ...)`` with per-request mixing matrices, runs through one
masked forward whose every tensor carries the leading request axis (the
reference's ``vmap`` over requests, written out). On the card each
layer is one batched launch of the graph-filter kernel, whichever
serve mix is named.

  * masked padding — padded AGENT rows are zeroed through every layer
    (zero S rows/cols make them invisible to the graph filter) and
    padded TEST rows are row-0 copies un-biased by the task's
    ``padded_local_*`` corrections, so a padded solve returns the
    unpadded cohort's numbers;
  * admission-time featurization — ``core.unroll.featurize_cohort`` ran
    at the request's TRUE shape before padding.

``_serve_core_adaptive`` is the early-exit solver of ``depth="adaptive"``.

``mesh=`` splits a bucket's request axis over the devices of the mesh's
agent-role axis (``request_shardings``): each device solves its
max_batch/shards slots with its own copy of θ, every shard launched
before any is gathered, and the results are gathered to the home device
in slot order. Requests are independent, so no shard reads another's
data.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import _engine_cache_key
from repro_torch.sharding import surf_rules as R

SERVE_MIXES = U.DENSE_MIXES


def resolve_serve_mix(mix):
    """Serving supports the S-as-argument mixers only: every name in
    ``core.unroll.DENSE_MIXES`` selects the default path (``mix_fn=None``),
    the fused kernel on the card and the plain filter on the CPU. Baked-S
    mixers (ring/halo) close over ONE topology and cannot serve
    per-request graphs."""
    if mix in U.DENSE_MIXES:
        return None
    raise ValueError(
        f"serve mix must be one of {SERVE_MIXES}, got {mix!r} — baked-S "
        "mixers (ring/halo) cannot serve per-request topologies")


def _masked_scores(task):
    """Padded-cohort loss/metric: the task's ``padded_local_*``
    row-corrections per agent, averaged over REAL agents only.
    W (B,n,d), Xte (B,n,t,F), Yte (B,n,t), mask (B,n), t_real (B,)."""
    def masked_scores(W, Xte, Yte, mask, t_real):
        t_real = t_real[:, None]
        per_loss = task.padded_local_loss(W, Xte, Yte, t_real)
        per_met = task.padded_local_metric(W, Xte, Yte, t_real)
        denom = mask.sum(-1).clamp(min=1).to(per_loss.dtype)
        loss = torch.where(mask, per_loss, 0.0).sum(-1) / denom
        met = torch.where(mask, per_met, 0.0).sum(-1) / denom
        return loss, met

    return masked_scores


def _serve_core(cfg: SURFConfig, activation="relu", mix_fn=None, task=None):
    """Batched masked forward ``solve(S, theta, W0, Xl, Yl, Xte, Yte,
    mask, t_real)`` at a bucket shape: S (B,n,n), W0 (B,n,d),
    Xl (B,L,n,b,F), Yl (B,L,n,b), Xte (B,n,t,F), Yte (B,n,t), mask (B,n)
    flags real agents, t_real (B,) the true test rows. Returns per-request
    metric stacks with a leading (B,) axis."""
    task = resolve_task(cfg, task)
    masked_scores = _masked_scores(task)

    def solve(S, theta, W0, Xl, Yl, Xte, Yte, mask, t_real):
        keep = mask[..., None]
        W = torch.where(keep, W0, 0.0)
        losses, mets = [], []
        for l in range(cfg.n_layers):
            W = U.udgd_layer(U.layer_params(theta, l), S, W, Xl[:, l],
                             Yl[:, l], cfg, activation, mix_fn=mix_fn,
                             task=task)
            # re-zero padded agents: their perceptron term σ(M[0∥b]+d)
            # is nonzero even on zero inputs (the bias d), and zero S
            # rows only silence them in the NEXT layer's filter
            W = torch.where(keep, W, 0.0)
            loss, met = masked_scores(W, Xte, Yte, mask, t_real)
            losses.append(loss)
            mets.append(met)
        losses, mets = torch.stack(losses, 1), torch.stack(mets, 1)
        return {"W": W, "loss_per_layer": losses, "acc_per_layer": mets,
                "final_loss": losses[:, -1], "final_acc": mets[:, -1]}

    return solve


def _serve_core_adaptive(cfg: SURFConfig, activation="relu", mix_fn=None,
                         task=None):
    """Batched early-exit solver for one bucket: ``solve(S, theta, W0, Xl,
    Yl, Xte, Yte, Xp, Yp, mask, t_real)``, the fixed solver's arguments
    with the padded probe split Xp (B,n,p,F), Yp (B,n,p) after Yte.

    Every layer runs on the whole (B, n_pad, ...) batch (one kernel
    launch per layer) under a per-request ACTIVE mask: a request whose
    grad-norm certificate fired keeps its W (``torch.where``), exactly as
    in the reference's shared ``lax.while_loop``. The loop stops once no
    request is active or L layers ran; with the exit on, that takes one
    host read of ``act.any()`` per layer. The certificate uses
    ``task.masked_grad_norm`` on the padded probe split, which equals the
    unpadded ``grad_norm``, so padding never flips an exit decision.
    ``depth`` (B,) int32 is each request's realized layer count (0 for
    empty slots, whose all-false mask starts them inactive). With
    ``exit_threshold == 0`` W equals the fixed solver's bit for bit."""
    task = resolve_task(cfg, task)
    masked_scores = _masked_scores(task)
    thr = float(cfg.exit_threshold)
    min_l = int(cfg.min_layers)
    adaptive = thr > 0.0

    def solve(S, theta, W0, Xl, Yl, Xte, Yte, Xp, Yp, mask, t_real):
        keep = mask[..., None]
        W = torch.where(keep, W0, 0.0)
        act = mask.any(-1)
        depth = torch.zeros(act.shape, dtype=torch.int32, device=W.device)
        g_prev = task.masked_grad_norm(W, Xp, Yp, mask) if adaptive else None
        for l in range(cfg.n_layers):
            # the exit decisions live on the device; without the exit,
            # act never changes after layer 0
            if (adaptive or l == 0) and not bool(act.any()):
                break
            Wn = U.udgd_layer(U.layer_params(theta, l), S, W, Xl[:, l],
                              Yl[:, l], cfg, activation, mix_fn=mix_fn,
                              task=task)
            # the fixed path's padded-agent re-zero, then freeze requests
            # whose certificate already fired
            Wn = torch.where(keep, Wn, 0.0)
            W = torch.where(act[:, None, None], Wn, W)
            depth += act.to(torch.int32)
            if adaptive:
                g = torch.where(act, task.masked_grad_norm(W, Xp, Yp, mask),
                                g_prev)
                ratio = g / g_prev.clamp(min=1e-12)
                fire = (l + 1 >= min_l) & (ratio >= 1.0 - thr)
                act = act & ~fire
                g_prev = g
        loss, met = masked_scores(W, Xte, Yte, mask, t_real)
        return {"W": W, "final_loss": loss, "final_acc": met,
                "depth": depth}

    return solve


def serve_cache_key(cfg: SURFConfig, bucket, max_batch, activation,
                    mix_fn=None, task=None, depth="fixed", mesh=None):
    """Per-bucket solver key: ``engine._engine_cache_key`` with a
    ("serve", n_pad, t_pad, B) variant tag and the cohort-shape cfg
    fields scrubbed (requests of any true size share the bucket's
    solver). That key also scrubs the exit fields, so fixed solvers are
    shared across threshold sweeps; the adaptive path carries them in a
    ("serve-adaptive", ..., thr, min_layers, probe_size) variant
    instead. ``mesh`` rides as its fingerprint: a request-sharded solver
    never shares a key with the one-device solver. None for an untagged
    custom ``mix_fn`` (uncacheable)."""
    variant = ("serve", int(bucket.n_agents), int(bucket.rows),
               int(max_batch))
    if depth == "adaptive":
        variant = ("serve-adaptive",) + variant[1:] + (
            float(cfg.exit_threshold), int(cfg.min_layers),
            int(cfg.probe_size))
    cfg = dataclasses.replace(cfg, n_agents=0, train_per_agent=0,
                              test_per_agent=0)
    return _engine_cache_key(cfg, variant, activation, mix_fn=mix_fn,
                             task=task, mesh=mesh)


def request_shardings(mesh, max_batch, depth="fixed"):
    """(in placements, out placement) of a bucket solver on ``mesh``: the
    REQUEST axis (the leading B of every argument and output) split over
    the mesh's agent-role axis, θ (argument 1) replicated on every shard.
    ``max_batch`` must divide over the shards: ragged traffic already
    rides as masked empty slots, so the constraint is on the bucket's
    batch shape, not on traffic."""
    axis = R.axis_for_role(mesh, "agent")
    shards = R._axis_size(mesh, axis)
    R.check_divides(max_batch, shards, "the sharded serve batch",
                    "max_batch",
                    "each device solves an equal block of request slots "
                    "(ragged traffic rides as masked empty slots)")
    req = R.Placement(axis, 0, mesh.along(axis)) if shards > 1 else (
        R.replicated(mesh))
    theta = R.Placement(None, None, req.devices)
    n_args = 11 if depth == "adaptive" else 9
    return tuple(theta if i == 1 else req for i in range(n_args)), req


def _request_sharded(solve, mesh, max_batch, depth):
    """``solve`` with its request axis split by ``request_shardings``:
    every shard's solve is launched before any result is gathered (the
    shards of several cards overlap), then the outputs are concatenated
    on the home device (S's) in slot order. θ is copied to each shard's
    device once per θ object."""
    in_place, out = request_shardings(mesh, max_batch, depth)
    copies = {}

    def theta_on(theta, dev):
        if copies.get("of") is not theta:
            copies.clear()
            copies["of"] = theta
        if dev not in copies:
            copies[dev] = {k: v.to(dev) for k, v in theta.items()}
        return copies[dev]

    def solve_sharded(S, theta, *rest):
        args = (S,) + rest
        places = in_place[:1] + in_place[2:]
        blocks = [p.split(a) for p, a in zip(places, args)]
        outs = [solve(blocks[0][a], theta_on(theta, dev),
                      *(b[a] for b in blocks[1:]))
                for a, dev in enumerate(out.devices)]
        return {k: torch.cat([o[k].to(S.device) for o in outs])
                for k in outs[0]}

    return solve_sharded


def make_bucket_solver(cfg: SURFConfig, bucket, max_batch, *,
                       activation="relu", mix_fn=None, task=None,
                       cache=None, depth="fixed", mesh=None):
    """The request-batched solver for one shape bucket: ``_serve_core``
    for ``depth="fixed"``, ``_serve_core_adaptive`` (probe arrays after
    Yte, a ``depth`` (B,) field in the result) for ``depth="adaptive"``.
    ``mesh`` splits the request axis over the mesh's agent-role axis
    (``request_shardings``). ``cache`` (a ``BoundedLRU``) keeps it under
    ``serve_cache_key``; its ``misses`` count the builds."""
    core = _serve_core_adaptive if depth == "adaptive" else _serve_core

    def build():
        solve = core(cfg, activation, mix_fn=mix_fn, task=task)
        if mesh is None:
            return solve
        return _request_sharded(solve, mesh, max_batch, depth)

    key = None if cache is None else serve_cache_key(
        cfg, bucket, max_batch, activation, mix_fn=mix_fn, task=task,
        depth=depth, mesh=mesh)
    if key is None:
        return build()
    return cache.get_or_build(key, build)
