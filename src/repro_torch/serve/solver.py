"""Request-batched amortized solver: the serving hot path (the port of
``repro.serve.solver``, fixed depth).

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

Adaptive depth (``_serve_core_adaptive``) and request sharding over
devices (``request_shardings``) land with later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task

SERVE_MIXES = U.MIXES


def resolve_serve_mix(mix):
    """Serving supports the S-as-argument mixers only: every name in
    ``core.unroll.MIXES`` selects the default path (``mix_fn=None``), the
    fused kernel on the card and the plain filter on the CPU. Baked-S
    mixers (ring/halo) close over ONE topology and cannot serve
    per-request graphs."""
    if mix in U.MIXES:
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


def serve_cache_key(cfg: SURFConfig, bucket, max_batch, activation,
                    mix_fn=None, task=None):
    """Per-bucket solver key: the bucket dims, the batch size and the
    config with its cohort-shape fields scrubbed (requests of any true
    size share the bucket's solver), plus the activation, the mixer's
    tag and the task's tag. None for an untagged custom ``mix_fn``
    (uncacheable)."""
    if mix_fn is not None and getattr(mix_fn, "tag", None) is None:
        return None
    task = resolve_task(cfg, task)
    cfg = dataclasses.replace(cfg, n_agents=0, train_per_agent=0,
                              test_per_agent=0)
    return (("serve", int(bucket.n_agents), int(bucket.rows),
             int(max_batch)), cfg, activation,
            None if mix_fn is None else mix_fn.tag, task.cache_tag)


def make_bucket_solver(cfg: SURFConfig, bucket, max_batch, *,
                       activation="relu", mix_fn=None, task=None,
                       cache=None):
    """The request-batched solver for one shape bucket (see
    ``_serve_core`` for its signature). ``cache`` (a ``BoundedLRU``)
    keeps it under ``serve_cache_key``."""
    def build():
        return _serve_core(cfg, activation, mix_fn=mix_fn, task=task)

    key = None if cache is None else serve_cache_key(
        cfg, bucket, max_batch, activation, mix_fn=mix_fn, task=task)
    if key is None:
        return build()
    return cache.get_or_build(key, build)
