"""Descending constraints and the empirical Lagrangian (paper §4, eq. 3);
the port of ``repro.core.constraints`` (nominal variant).

constraint l:  E[ ‖∇f(W_l)‖ − (1−ε) ‖∇f(W_{l−1})‖ ] ≤ 0
Lagrangian:    L̂(θ, λ) = Ê[f(Φ(D;θ))] + Σ_l λ_l Ê[slack_l]

Gradient norms use stochastic gradients on each layer's own mini-batch.
∇_θ of the Lagrangian differentiates through ‖∇_W f‖ (grad-of-grad):
``Task.grad_norm`` keeps the graph of ∇_W f when W records a gradient,
and that graph runs through the task's loss only, never twice through
the graph filter.

The robust RSDUN variant is not ported yet (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core.tasks import resolve_task

ROBUST_TODO = ("the robust RSDUN constraints (cfg.robust_sigma > 0) are "
               "not ported yet: ROADMAP queue 1 item 5")


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


def robust_layer_grad_norms(*args, **kwargs):
    raise NotImplementedError(ROBUST_TODO)


def robust_slacks(*args, **kwargs):
    raise NotImplementedError(ROBUST_TODO)
