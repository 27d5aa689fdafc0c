"""Classification task (paper §6): collaboratively train a softmax
classifier head on frozen features (the port of
``repro.core.tasks.classification``).

Per-agent head weights are flattened into rows of W ∈ R^{n×d},
d = F·C + C. Every function takes any number of leading axes (see
``core.tasks.base``). The legacy functional forms ``fl_loss``,
``fl_accuracy``, ``fl_grad`` and ``grad_norm`` (re-exported by the
``core.task`` shim) call the task's methods. ``features_from_backbone``
arrives with the LLM substrate (``models/``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as Fn

from repro_torch.core.tasks.base import Task


def head_dim(feat_dim, n_classes):
    return feat_dim * n_classes + n_classes


def unflatten(w, feat_dim, n_classes):
    """w (..., d) -> (Wm (..., F, C), b (..., C))."""
    Wm = w[..., : feat_dim * n_classes].unflatten(-1, (feat_dim, n_classes))
    b = w[..., feat_dim * n_classes:]
    return Wm, b


def _logits(w, X, feat_dim, n_classes):
    Wm, b = unflatten(w, feat_dim, n_classes)
    return X @ Wm + b.unsqueeze(-2)                  # (..., t, C)


def local_loss(w, X, Y, feat_dim, n_classes):
    """CE of each agent's head on its batch: X (..., t, F), Y (..., t)."""
    logp = torch.log_softmax(_logits(w, X, feat_dim, n_classes), dim=-1)
    return -torch.gather(logp, -1, Y.unsqueeze(-1)).squeeze(-1).mean(-1)


def local_accuracy(w, X, Y, feat_dim, n_classes):
    pred = _logits(w, X, feat_dim, n_classes).argmax(-1)
    return (pred == Y).to(torch.float32).mean(-1)


@dataclass(frozen=True)
class ClassificationTask(Task):
    feat_dim: int = 64
    n_classes: int = 10

    kind = "classification"
    label_dtype = torch.long

    @property
    def dim(self) -> int:
        return head_dim(self.feat_dim, self.n_classes)

    @property
    def batch_feat(self) -> int:
        return self.feat_dim + self.n_classes

    @property
    def cache_tag(self):
        return ("classification", self.feat_dim, self.n_classes)

    def local_loss(self, W, X, Y):
        return local_loss(W, X, Y, self.feat_dim, self.n_classes)

    def local_metric(self, W, X, Y):
        return local_accuracy(W, X, Y, self.feat_dim, self.n_classes)

    def batch_vector(self, Xb, Yb):
        """Each example's features and one-hot label follow each other:
        Xb (..., n, b, F), Yb (..., n, b) -> (..., n, b*(F+C))."""
        oh = Fn.one_hot(Yb, self.n_classes).to(Xb.dtype)
        return torch.cat([Xb, oh], dim=-1).flatten(-2)

    def synth_datasets(self, cfg, Q, seed=0, **kw):
        from repro_torch.data.synthetic import make_meta_dataset
        return make_meta_dataset(cfg, Q, seed=seed, **kw)


def classification_task(cfg) -> ClassificationTask:
    """The classification task a config describes (its ``task`` field, or
    the legacy ``feature_dim``/``n_classes`` pair when that is None)."""
    tc = cfg.task_config
    if tc.kind != "classification":
        raise ValueError(f"cfg describes a {tc.kind!r} task")
    return ClassificationTask(feat_dim=tc.feature_dim, n_classes=tc.n_classes)

def fl_loss(W, X, Y, feat_dim, n_classes):
    """f(W) = (1/n) Σ_i f_i(w_i). X (..., n, b, F), Y (..., n, b)."""
    return ClassificationTask(feat_dim, n_classes).fl_loss(W, X, Y)


def fl_accuracy(W, X, Y, feat_dim, n_classes):
    return ClassificationTask(feat_dim, n_classes).fl_metric(W, X, Y)


def fl_grad(W, X, Y, feat_dim, n_classes):
    """Stochastic ∇f(W): row i is ∇f_i(w_i)/n (matches f's 1/n)."""
    return ClassificationTask(feat_dim, n_classes).fl_grad(W, X, Y)


def grad_norm(W, X, Y, feat_dim, n_classes):
    """‖∇f(W)‖_F, the quantity the descending constraints control."""
    return ClassificationTask(feat_dim, n_classes).grad_norm(W, X, Y)
