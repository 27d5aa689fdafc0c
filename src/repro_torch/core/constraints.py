"""Descending constraints and the empirical Lagrangian (paper §4, eq. 3);
the port of ``repro.core.constraints``.

constraint l:  E[ ‖∇f(W_l)‖ − (1−ε) ‖∇f(W_{l−1})‖ ] ≤ 0
Lagrangian:    L̂(θ, λ) = Ê[f(Φ(D;θ))] + Σ_l λ_l Ê[slack_l]

Gradient norms use stochastic gradients on each layer's own mini-batch.
∇_θ of the Lagrangian differentiates through ‖∇_W f‖ (grad-of-grad):
``Task.grad_norm`` keeps the graph of ∇_W f when W records a gradient,
and that graph runs through the task's loss only, never twice through
the graph filter.

The ROBUST variant (RSDUN, arxiv 2312.15788) replaces each layer's
gradient norm with the max over Gaussian perturbations of the iterate,
``max(‖∇f(W_l)‖, max_j ‖∇f(W_l + σδ_j)‖)``: descent must hold in a
σ-neighbourhood of the trajectory. Enabled by ``cfg.robust_sigma > 0``;
at σ = 0 (or with no samples) the robust norms are the nominal ones. The
perturbations δ are an argument here: the meta-step draws them from a
generator of their own (``core.unroll.robust_generator``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core.tasks import resolve_task


def layer_grad_norms(W_all, Xl, Yl, cfg: SURFConfig, task=None):
    """‖∇f(W_l)‖ for l=0..L. W_all (L+1,n,d); Xl (L,n,b,F); Yl (L,n,b).
    Layer l>0 is evaluated on the batch that produced it (B_l); W_0 on
    B_1. W_0 carries no gradient (its θ-gradient is exactly zero), so its
    norm is a plain value and only layers 1..L keep a graph."""
    task = resolve_task(cfg, task)
    g0 = task.grad_norm(W_all[0].detach(), Xl[0], Yl[0])
    return torch.cat([g0[None], task.grad_norm(W_all[1:], Xl, Yl)])


def slacks(gnorms, eps):
    """slack_l = ‖∇f(W_l)‖ − (1−ε)‖∇f(W_{l−1})‖, l=1..L."""
    return gnorms[1:] - (1.0 - eps) * gnorms[:-1]


def lagrangian(test_loss, slack, lam):
    return test_loss + torch.sum(lam * slack)


def dual_ascent(lam, slack, lr):
    """λ ← [λ + μ_λ slack]_+  (eq. 7)."""
    return torch.clamp(lam + lr * slack, min=0.0)


def robust_enabled(cfg: SURFConfig) -> bool:
    """Whether ``cfg`` asks for the RSDUN constraints (σ > 0, samples > 0)."""
    return cfg.robust_sigma > 0.0 and cfg.robust_samples > 0


def robust_layer_grad_norms(W_all, Xl, Yl, cfg: SURFConfig, deltas,
                            task=None, nominal=None):
    """RSDUN perturbation-sampled grad norms: the elementwise max of the
    nominal ‖∇f(W_l)‖ and ‖∇f(W_l + σδ_j)‖ over the ``cfg.robust_samples``
    perturbations ``deltas`` (robust_samples, L+1, n, d) ~ N(0, I),
    σ = cfg.robust_sigma. Returns (L+1,); the nominal norms when σ = 0 or
    no samples are drawn (``deltas`` is then not read). The perturbed
    norms keep their graph when W_all records a gradient, like the
    nominal ones: the grad-of-grad goes through the task's loss only."""
    task = resolve_task(cfg, task)
    if nominal is None:
        nominal = layer_grad_norms(W_all, Xl, Yl, cfg, task=task)
    if not robust_enabled(cfg):
        return nominal
    if tuple(deltas.shape) != (cfg.robust_samples,) + tuple(W_all.shape):
        raise ValueError(f"deltas must be (robust_samples,) + W_all.shape "
                         f"= {(cfg.robust_samples,) + tuple(W_all.shape)}, "
                         f"got {tuple(deltas.shape)}")
    P = cfg.robust_samples
    Xe = torch.cat([Xl[:1], Xl])                      # (L+1, n, b, F)
    Ye = torch.cat([Yl[:1], Yl])
    pert = task.grad_norm(W_all + cfg.robust_sigma * deltas,
                          Xe.expand(P, *Xe.shape), Ye.expand(P, *Ye.shape))
    return torch.maximum(nominal, pert.amax(0))       # (L+1,)


def robust_slacks(gnorms_robust, gnorms_nominal, eps):
    """RSDUN slack: the ROBUST norm of layer l must descend relative to the
    NOMINAL norm of layer l−1 (the point the trajectory actually
    visits): slack_l = robust_l − (1−ε)·nominal_{l−1}. Since
    robust_l ≥ nominal_l elementwise, this upper-bounds ``slacks``."""
    return gnorms_robust[1:] - (1.0 - eps) * gnorms_nominal[:-1]
