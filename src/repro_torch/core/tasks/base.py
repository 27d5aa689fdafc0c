"""The ``Task`` interface: the inner FL problem the unrolled optimizer
solves (the port of ``repro.core.tasks.base``).

The reference writes each per-agent function on one agent's row and
lifts it with ``jax.vmap``; here every function takes any number of
leading axes, so one call covers the agents of a cohort and the requests
of a serve batch:

  * ``local_loss(W, X, Y)``: W (..., d), X (..., t, F), Y (..., t) ->
    one loss per agent, shape (...);
  * ``fl_loss(W, X, Y)``: the mean over the agent axis (the last of the
    leading axes), shape (...) without it.

The gradient lifts (``fl_grad``, ``grad_norm``, ``masked_grad_norm``)
take ∇ of ``local_loss`` with ``torch.autograd.grad`` over the sum of the
per-agent losses (each agent's loss reads only its own row). When W
records a gradient they keep the graph (``create_graph=True``), so the
descending constraints can differentiate the norms again (grad-of-grad,
``core.constraints``); otherwise they return plain values, under
``torch.no_grad()`` too.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils.device import to_tensor


@dataclass(frozen=True)
class Task:
    kind = "abstract"
    label_dtype = torch.long     # dtype of Ytr/Yte on the device

    # ------------------------------------------------ subclass contract
    @property
    def dim(self) -> int:
        """Per-agent weight dimension d (rows of W ∈ R^{n×d})."""
        raise NotImplementedError

    @property
    def feat_dim(self) -> int:
        """Per-example feature dimension F (trailing axis of Xtr/Xte)."""
        raise NotImplementedError

    @property
    def batch_feat(self) -> int:
        """Per-example width in the flattened perceptron input b_i —
        features plus the label channel(s)."""
        raise NotImplementedError

    @property
    def cache_tag(self):
        """Hashable tag folded into the serve cache key. Two tasks with
        equal tags compute identical functions."""
        raise NotImplementedError

    def local_loss(self, W, X, Y):
        """f_i(w_i) per agent: W (..., d), X (..., t, F), Y (..., t)."""
        raise NotImplementedError

    def local_metric(self, W, X, Y):
        """Per-agent reporting metric (accuracy, ...), same shapes."""
        raise NotImplementedError

    def batch_vector(self, Xb, Yb):
        """Flatten per-agent mini-batches into the perceptron input:
        Xb (..., n, b, F), Yb (..., n, b) -> (..., n, b*batch_feat)."""
        raise NotImplementedError

    def synth_datasets(self, cfg, Q, seed=0, **kw):
        """Q synthetic downstream datasets (numpy ``Xtr``/``Ytr``/``Xte``/
        ``Yte`` dicts in the (n, m, F) / (n, m) layout)."""
        raise NotImplementedError

    # ------------------------------------------------- shared FL lifts
    def fl_loss(self, W, X, Y):
        """f(W) = (1/n) Σ_i f_i(w_i).  W (..., n, d), X (..., n, b, F)."""
        return self.local_loss(W, X, Y).mean(-1)

    def fl_metric(self, W, X, Y):
        return self.local_metric(W, X, Y).mean(-1)

    def _agent_grads(self, W, X, Y):
        """∇f_i(w_i) per agent, (..., n, d); differentiable when W
        records a gradient."""
        create = torch.is_grad_enabled() and W.requires_grad
        with torch.enable_grad():
            Wg = W if create else W.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.local_loss(Wg, X, Y).sum(), Wg,
                                       create_graph=create)
        return g

    def fl_grad(self, W, X, Y):
        """Stochastic ∇f(W) ∈ R^{n×d} — row i is ∇f_i(w_i)/n."""
        return self._agent_grads(W, X, Y) / W.shape[-2]

    def grad_norm(self, W, X, Y):
        """‖∇f(W)‖_F per cohort, shape (...) — the quantity the
        descending constraints control."""
        g = self.fl_grad(W, X, Y)
        return torch.sqrt(g.square().sum((-2, -1)) + 1e-12)

    def masked_grad_norm(self, W, X, Y, mask):
        """``grad_norm`` over the REAL agents of a padded cohort (mask
        (..., n)): padded rows are zeroed out of the gradient and the 1/n
        normalization uses the real agent count, so the value equals
        ``grad_norm`` on the unpadded cohort."""
        g = torch.where(mask[..., None], self._agent_grads(W, X, Y), 0.0)
        n_real = mask.sum(-1).clamp(min=1).to(g.dtype)[..., None, None]
        return torch.sqrt((g / n_real).square().sum((-2, -1)) + 1e-12)

    def init_state(self, generator, cfg):
        """W0 ~ N(w0_mean, w0_std²) ∈ R^{n×d}, drawn from ``generator``
        on its device."""
        return cfg.w0_mean + cfg.w0_std * torch.randn(
            (cfg.n_agents, self.dim), generator=generator,
            device=generator.device)

    def to_batch(self, dataset, device):
        """A dataset dict (``Xtr``/``Ytr``/``Xte``/``Yte``, numpy or
        tensors) as tensors on ``device``: f32 features, labels in
        ``label_dtype``."""
        return {k: to_tensor(dataset[k], device,
                             torch.float32 if k[0] == "X"
                             else self.label_dtype)
                for k in ("Xtr", "Ytr", "Xte", "Yte")}

    # -------------------------------------------- padded-row corrections
    # The serving layer pads each agent's eval rows up to a bucket size
    # t_pad by REPLICATING ROW 0, then un-biases the padded value here.
    # Exact whenever local_loss / local_metric is a mean over rows plus a
    # row-independent term: with t_pad rows of which t_pad − t_real are
    # copies of row 0,
    #     L_real = (t_pad·L_pad − (t_pad − t_real)·L_0) / t_real
    # where L_0 is the statistic on an all-row-0 batch.

    def _padded(self, fn, W, X, Y, t_real):
        t_pad = X.shape[-2]
        Mp = fn(W, X, Y)
        M0 = fn(W, X[..., :1, :].expand(X.shape), Y[..., :1].expand(Y.shape))
        t_real = torch.as_tensor(t_real, dtype=Mp.dtype, device=Mp.device)
        Mr = (t_pad * Mp - (t_pad - t_real) * M0) / t_real.clamp(min=1.0)
        return torch.where(t_real == t_pad, Mp, Mr)

    def padded_local_loss(self, W, X, Y, t_real):
        """``local_loss`` on a row-0-padded batch, corrected back to the
        value on the first ``t_real`` rows. X (..., t_pad, F); ``t_real``
        broadcasts against the per-agent result."""
        return self._padded(self.local_loss, W, X, Y, t_real)

    def padded_local_metric(self, W, X, Y, t_real):
        """``local_metric`` on a row-0-padded batch, corrected back to the
        value on the first ``t_real`` rows (mean-over-rows default)."""
        return self._padded(self.local_metric, W, X, Y, t_real)


def resolve_task(cfg, task=None):
    """The one task-resolution point: an explicit ``task`` object wins;
    otherwise ``cfg.task`` is materialized; ``cfg.task is None`` yields
    the classification task built from ``cfg.feature_dim`` /
    ``cfg.n_classes``."""
    if task is not None:
        return task
    tc = getattr(cfg, "task", None)
    kind = getattr(tc, "kind", "classification")
    if kind == "classification":
        from repro_torch.core.tasks.classification import ClassificationTask
        if tc is None:
            return ClassificationTask(feat_dim=cfg.feature_dim,
                                      n_classes=cfg.n_classes)
        return ClassificationTask(feat_dim=tc.feature_dim,
                                  n_classes=tc.n_classes)
    if kind == "sparse_recovery":
        from repro_torch.core.tasks.sparse_recovery import SparseRecoveryTask
        return SparseRecoveryTask(signal_dim=tc.signal_dim, rho=tc.rho,
                                  sparsity=tc.sparsity, noise=tc.noise)
    raise ValueError(f"unknown task kind {kind!r}")
