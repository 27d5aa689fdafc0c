"""Compatibility shim: the legacy classification-task API, the port of
``repro.core.task``.

The downstream FL task is the ``core.tasks`` interface; this module
re-exports the classification functions of
``core/tasks/classification.py`` (the same objects) so the historical
``task.fl_loss(W, X, Y, feat_dim, n_classes)`` entry points keep
working. The reference's ``features_from_backbone`` arrives with the
LLM substrate.
"""
from __future__ import annotations

from repro_torch.core.tasks.classification import (  # noqa: F401
    fl_accuracy,
    fl_grad,
    fl_loss,
    grad_norm,
    head_dim,
    local_accuracy,
    local_loss,
    unflatten,
)

__all__ = [
    "head_dim", "unflatten", "local_loss", "local_accuracy",
    "fl_loss", "fl_accuracy", "fl_grad", "grad_norm",
]
