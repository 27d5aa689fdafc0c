"""Sparse-recovery task: federated LASSO (arxiv 2010.12616); the port of
``repro.core.tasks.sparse_recovery``.

All agents recover the SAME k-sparse signal w* ∈ R^p from their own
noisy linear measurements y_i = A_i w* + ν. Per-agent objective

    f_i(w) = ½ · mean((A_i w − y_i)²) + ρ‖w‖₁

so the unrolled optimizer learns a LISTA-style distributed solver
through the engine the classifier uses: the per-agent weight row IS the
signal estimate (d = p), a layer's perceptron input packs each
gradient-at-zero direction x_j·y_j next to its scalar observation, and
the reported metric is the measurement-space NMSE ‖A_i w − y_i‖²/‖y_i‖²
(lower is better; it rides the engine's generic ``*_acc`` slots).
Labels (the measurements) are f32. Every function takes any number of
leading axes (see ``core.tasks.base``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.tasks.base import Task


def soft_threshold(w, tau):
    """prox of τ‖·‖₁ — the LISTA/ISTA shrinkage operator."""
    return torch.sign(w) * torch.clamp(w.abs() - tau, min=0.0)


def support_f1(w, w_star, tau=1e-3):
    """F1 of the thresholded support of w against the true support."""
    est = soft_threshold(w, tau).abs() > 0
    true = w_star.abs() > 0
    tp = (est & true).sum().to(torch.float32)
    prec = tp / est.sum().clamp(min=1)
    rec = tp / true.sum().clamp(min=1)
    return 2 * prec * rec / (prec + rec).clamp(min=1e-12)


def signal_nmse(W, w_star):
    """Signal-space NMSE mean_i ‖w_i − w*‖²/‖w*‖² (needs ground truth)."""
    err = (W - w_star[None]).square().sum(-1)
    return err.mean() / (w_star.square().sum() + 1e-12)


def _residual(W, X, Y):
    """X w − Y per agent: W (..., p), X (..., t, p), Y (..., t)."""
    return (X @ W.unsqueeze(-1)).squeeze(-1) - Y


@dataclass(frozen=True)
class SparseRecoveryTask(Task):
    signal_dim: int = 32
    rho: float = 0.02
    sparsity: int = 4
    noise: float = 0.01
    signal_scale: float = 1.0

    kind = "sparse_recovery"
    label_dtype = torch.float32

    @property
    def dim(self) -> int:
        return self.signal_dim

    @property
    def feat_dim(self) -> int:
        return self.signal_dim

    @property
    def batch_feat(self) -> int:
        return self.signal_dim + 1       # gradient-at-zero row ∥ scalar y

    @property
    def cache_tag(self):
        return ("sparse-recovery", self.signal_dim, self.rho,
                self.sparsity, self.noise, self.signal_scale)

    def local_loss(self, W, X, Y):
        """½·mean((X w − Y)²) + ρ‖w‖₁ per agent."""
        r = _residual(W, X, Y)
        return 0.5 * r.square().mean(-1) + self.rho * W.abs().sum(-1)

    def local_metric(self, W, X, Y):
        """Measurement-space NMSE ‖Xw − Y‖²/‖Y‖² (lower is better)."""
        r = _residual(W, X, Y)
        return r.square().sum(-1) / (Y.square().sum(-1) + 1e-12)

    def padded_local_metric(self, W, X, Y, t_real):
        """NMSE is a RATIO of row sums, so the base class's mean
        correction does not apply. With k = t_pad − t_real row-0 copies
        appended, their contribution leaves numerator and denominator
        separately: (Σe_pad − k·e_0) / (Σy²_pad − k·y_0² + 1e-12). Exact
        for any padding count (row 0 of a real batch is real data)."""
        t_pad = X.shape[-2]
        r = _residual(W, X, Y)
        e_sum = r.square().sum(-1)
        y_sum = Y.square().sum(-1)
        k = t_pad - torch.as_tensor(t_real, dtype=e_sum.dtype,
                                    device=e_sum.device)
        e0 = r[..., 0].square()
        y0 = Y[..., 0].square()
        return (e_sum - k * e0) / (y_sum - k * y0 + 1e-12)

    def batch_vector(self, Xb, Yb):
        """Each gradient-at-zero direction x_j·y_j (the LISTA input Aᵀy,
        row by row) next to its observation:
        Xb (..., n, b, p), Yb (..., n, b) -> (..., n, b*(p+1))."""
        y = Yb.unsqueeze(-1).to(Xb.dtype)
        return torch.cat([Xb * y, y], dim=-1).flatten(-2)

    def synth_datasets(self, cfg, Q, seed=0, **kw):
        from repro_torch.data.synthetic import make_sparse_meta_dataset
        return make_sparse_meta_dataset(cfg, Q, self, seed=seed, **kw)


def sparse_recovery_task(cfg=None, **overrides) -> SparseRecoveryTask:
    """Build a sparse-recovery task from a config's ``task`` field (when it
    is a ``SparseRecoveryTaskConfig``) and/or keyword overrides."""
    fields = {}
    tc = getattr(cfg, "task", None) if cfg is not None else None
    if getattr(tc, "kind", None) == "sparse_recovery":
        fields = {"signal_dim": tc.signal_dim, "rho": tc.rho,
                  "sparsity": tc.sparsity, "noise": tc.noise,
                  "signal_scale": tc.signal_scale}
    fields.update(overrides)
    return SparseRecoveryTask(**fields)
